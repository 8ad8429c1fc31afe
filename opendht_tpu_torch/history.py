"""Time-series flight data recorder: retained metrics history.

Six observability surfaces (``/stats``, ``/trace``, ``/healthz``,
``/keyspace``, ``/cache``, the kernel ledger) are all point-in-time:
``dhtmon --window`` fakes a window by scraping twice and waiting, the
SLO engine re-derives every burn rate from private
prior-snapshot state, and when a node goes unhealthy the evidence is
gone by the time anyone looks.  The reference keeps only instants too
(``Dht::dumpTables`` / ``getNodesStats``) — retained history is the
capability a serving stack adds on top, and the substrate the ROADMAP's
load-aware resharding hysteresis ("driven by *measured* traffic") and
swarm soaks need.  This module is that retention layer:

- :class:`MetricsHistory` — a bounded in-memory ring
  (``deque(maxlen=capacity)``, oldest-evicted) of periodic,
  **delta-encoded** registry frames, ticking on the node scheduler
  exactly like the health tick (host-side snapshot
  subtraction only — no device work, kernels bit-identical with the
  tick on).  Per frame:
  counters as deltas vs the previous tick, histograms as bucket deltas
  (via the :meth:`telemetry.Histogram.raw` contract), gauges
  as last-value recorded only when they changed.  Series keys use the
  Prometheus form ``name{k="v"}`` — the SAME names ``GET /stats``
  exports, so frame sums and scrape diffs are directly comparable.
- **Windowed queries**: :meth:`~MetricsHistory.rate` /
  :meth:`~MetricsHistory.counter_delta` /
  :meth:`~MetricsHistory.quantile` over any ``(t0, t1]`` window the
  ring still covers, reusing :func:`telemetry.quantile_from_buckets`
  (the ONE interpolation copy).  The
  health evaluator reads its SLO windows through these when a recorder
  is attached instead of keeping private ``_Window`` state — one delta
  codepath (opendht_tpu_torch/health.py).
- **Bounded on-disk spill** (optional, ``spill_dir``): frames append to
  segment files of ``spill_segment_frames`` JSON lines each; at most
  ``spill_max_segments`` segments are retained, oldest deleted first —
  RSS *and* disk stay stable under a flood
  (the JAX package soak-checks a 10x flood).
- **Post-mortem black-box bundles**: :func:`build_bundle` assembles
  the last N frames + the flight-recorder ring (spans AND
  events) + kernel ledger + keyspace/cache/ingest snapshots + the
  health report into ONE JSON artifact.  ``runtime/runner.py`` captures
  one automatically on every ``health_transition`` to unhealthy (the
  evidence survives the incident) and serves fresh ones via
  ``DhtRunner.dump_bundle()``; captured bundles are retained in a
  second bounded ring (``retain_bundles``).

Import-light by design (stdlib + the telemetry/tracing spine) so the
recorder runs in minimal containers and pure-registry unit tests.

A copy of the JAX package's ``history.py`` with its behaviour
unchanged.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time as _time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from . import telemetry, tracing
from .telemetry import _bucket_le, _fmt, _series_name

log = logging.getLogger("opendht_tpu_torch.history")

__all__ = [
    "HistoryConfig", "MetricsHistory", "build_bundle", "frames_to_series",
    "BUNDLE_KIND",
]

#: the ``kind`` tag every black-box bundle carries (consumers dispatch
#: on it; the timeline assembler accepts bundles by this tag)
BUNDLE_KIND = "dht-blackbox-bundle"

#: spill segment file name pattern (sortable by sequence number)
_SEG_FMT = "frames-%08d.jsonl"
_SEG_PREFIX = "frames-"


@dataclass
class HistoryConfig:
    """Declarative recorder configuration (lives on
    ``runtime.config.Config.history``)."""

    #: seconds between recorder ticks on the node scheduler; 0 = the
    #: runner never attaches a recorder (history surfaces report
    #: ``enabled: false`` and the health engine keeps its private
    #: windows)
    period: float = 1.0
    #: frames retained in the in-memory ring (oldest evicted).  At the
    #: default 1 s period 768 frames cover ~12.8 minutes — past the
    #: health engine's slow SLO window (600 s) WITH the same 1.25x
    #: slack its private ``_Window`` kept (a shorter ring would
    #: silently truncate the slow window to partial totals).  Scale
    #: capacity >= slow_window / period when shrinking the period.
    capacity: int = 768
    #: frames embedded in a black-box bundle (the "last N" the
    #: post-mortem needs; <= capacity)
    bundle_frames: int = 120
    #: auto-captured bundles retained (a flapping node must not hold
    #: unbounded evidence)
    retain_bundles: int = 4
    #: optional on-disk spill directory ("" = in-memory only)
    spill_dir: str = ""
    #: frames per spill segment file
    spill_segment_frames: int = 128
    #: segment files retained (oldest deleted) — disk is bounded by
    #: ``spill_max_segments * spill_segment_frames`` frames
    spill_max_segments: int = 8


def _norm_buckets(buckets) -> Dict[int, float]:
    """Bucket maps round-trip through JSON (proxy, bundle files, spill
    segments) where dict keys become strings — normalize back to int
    indices so every reader sees one shape."""
    return {int(k): v for k, v in buckets.items()}


class MetricsHistory:
    """The bounded ring of delta-encoded registry frames (see module
    docstring).  ``tick()`` is cheap host-side subtraction; queries are
    safe from any thread (proxy handlers read while the DHT thread
    ticks)."""

    def __init__(self, cfg: Optional[HistoryConfig] = None, *,
                 registry: Optional[telemetry.MetricsRegistry] = None,
                 clock: Callable[[], float] = _time.monotonic,
                 node: str = ""):
        self.cfg = cfg or HistoryConfig()
        self.reg = registry or telemetry.get_registry()
        self.clock = clock
        self.node = node
        self.enabled = self.cfg.period > 0 and self.cfg.capacity > 0
        #: serializes whole ticks (sample + commit).  Sampling happens
        #: outside ``_lock`` so readers aren't blocked behind registry
        #: walks, but two concurrent ticks (the scheduler job + a test
        #: or smoke calling tick() directly) could then commit samples
        #: out of order and the counter-reset heuristic would replay
        #: full cumulative values as one frame's delta — the tick lock
        #: makes sample→commit atomic per tick while ``_lock`` alone
        #: still guards reader access.
        self._tick_lock = threading.Lock()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(int(self.cfg.capacity), 1))
        self._bundles: deque = deque(maxlen=max(
            int(self.cfg.retain_bundles), 1))
        self._seq = 0
        self._prev_mono: Optional[float] = None
        # series name -> cumulative baseline (counters: value;
        # histograms: (count, sum, {bucket: count}); gauges: last value)
        self._prev_counters: Dict[str, float] = {}
        self._prev_hists: Dict[str, tuple] = {}
        self._prev_gauges: Dict[str, float] = {}
        # spill state
        self._spill_buf: List[dict] = []
        self._spill_seq = 0
        self._spill_failed = False
        self._job = None
        # frame hooks: callables invoked with each committed
        # frame, AFTER the ring append and outside the reader lock —
        # the windowed-reset spine (pipeline observatory occupancy
        # checkpoints, the wave builder's windowed in-flight peak)
        self._frame_hooks: List[Callable[[dict], None]] = []
        # export handles (cached like the scheduler's)
        self._m_frames = self.reg.gauge("dht_history_frames",
                                        **({"node": node} if node else {}))
        self._m_ticks = self.reg.counter("dht_history_ticks_total",
                                         **({"node": node} if node else {}))

    # ------------------------------------------------------------ sampling
    def _sample(self) -> tuple:
        """One consistent-enough pass over the registry: cumulative
        counter/gauge values and histogram raw() triples, keyed by the
        Prometheus series name.  Reads only the non-mutating accessors
        (``families``/``series``) — the get-or-create factories would
        register ghost series."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, tuple] = {}
        for name, kind in self.reg.families().items():
            for key, m in self.reg.series(name).items():
                sname = _series_name(name, key)
                if kind == "counter":
                    counters[sname] = m.value
                elif kind == "gauge":
                    gauges[sname] = m.value
                else:
                    hists[sname] = m.raw()
        return counters, gauges, hists

    # ---------------------------------------------------------------- tick
    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """One recording pass: delta the registry against the previous
        tick's cumulative sample and append a frame.  The FIRST tick
        only establishes the baseline (a frame diffing against process
        zero would report the node's whole lifetime as one window).
        Returns the appended frame, or None (first tick / disabled)."""
        if not self.enabled:
            return None
        with self._tick_lock:
            return self._tick_inner(now)

    def _tick_inner(self, now: Optional[float]) -> Optional[dict]:
        now = self.clock() if now is None else now
        counters, gauges, hists = self._sample()
        spill_batch = None
        with self._lock:
            first = self._prev_mono is None
            frame = None
            if not first:
                frame = self._delta_frame_locked(now, counters, gauges,
                                                 hists)
                self._ring.append(frame)
                if self.cfg.spill_dir and not self._spill_failed:
                    self._spill_buf.append(frame)
                    if len(self._spill_buf) >= max(
                            self.cfg.spill_segment_frames, 1):
                        spill_batch = (self._spill_buf, self._spill_seq)
                        self._spill_buf = []
                        self._spill_seq += 1
            self._prev_mono = now
            self._prev_counters = counters
            self._prev_gauges = gauges
            self._prev_hists = hists
            nframes = len(self._ring)
        if spill_batch is not None:
            # disk I/O OUTSIDE the lock: a slow disk must not stall the
            # scheduler thread against concurrent proxy/health readers
            self._write_segment(*spill_batch)
        if frame is not None:
            for fn in list(self._frame_hooks):
                try:
                    fn(frame)
                except Exception:
                    log.exception("history frame hook failed")
        self._m_frames.set(nframes)
        self._m_ticks.inc()
        return frame

    def add_frame_hook(self, fn: Callable[[dict], None]) -> None:
        """Register ``fn(frame)`` to run after every committed frame
        (outside the reader lock, on the ticking thread).  This is the
        recorder's windowed-reset cadence: per-frame windows elsewhere
        (pipeline occupancy checkpoints, the windowed in-flight peak)
        key off it instead of inventing their own timers.  Exceptions
        are logged and swallowed — a broken hook must not stop the
        flight recorder."""
        self._frame_hooks.append(fn)

    def _delta_frame_locked(self, now: float, counters, gauges,
                            hists) -> dict:
        dcounters: Dict[str, float] = {}
        for k, v in counters.items():
            d = v - self._prev_counters.get(k, 0)
            if d < 0:           # counter reset (tests zero in place):
                d = v           # the new value IS the window's events
            if d:
                dcounters[k] = d
        dgauges = {k: v for k, v in gauges.items()
                   if self._prev_gauges.get(k) != v}
        dhists: Dict[str, dict] = {}
        for k, (count, total, buckets) in hists.items():
            pc, ps, pb = self._prev_hists.get(k, (0, 0.0, {}))
            dc = count - pc
            if dc < 0:          # histogram reset
                dc, ds = count, total
                db = dict(buckets)
            else:
                ds = total - ps
                db = {}
                for i in set(buckets) | set(pb):
                    d = buckets.get(i, 0) - pb.get(i, 0)
                    if d:
                        db[i] = d
            if dc:
                dhists[k] = {"count": dc, "sum": ds, "buckets": db}
        self._seq += 1
        return {
            "seq": self._seq,
            "t": _time.time(),
            "mono": now,
            "dur": max(now - (self._prev_mono or now), 0.0),
            "counters": dcounters,
            "gauges": dgauges,
            "hist": dhists,
        }

    # ------------------------------------------------------------- spill
    def _write_segment(self, buf: List[dict], seq: int) -> None:
        """Write one full segment + prune old ones — called WITHOUT the
        lock (frames are immutable once appended; only the tick thread
        writes segments, so sequencing is single-writer)."""
        try:
            os.makedirs(self.cfg.spill_dir, exist_ok=True)
            path = os.path.join(self.cfg.spill_dir, _SEG_FMT % seq)
            with open(path, "w") as fh:
                for f in buf:
                    fh.write(json.dumps(f) + "\n")
            self._prune_segments()
        except OSError:
            # spill must never kill the tick — disable, keep the ring
            self._spill_failed = True
            log.exception("history spill failed; disabling spill")

    def _segment_paths(self) -> List[str]:
        try:
            names = sorted(n for n in os.listdir(self.cfg.spill_dir)
                           if n.startswith(_SEG_PREFIX)
                           and n.endswith(".jsonl"))
        except OSError:
            return []
        return [os.path.join(self.cfg.spill_dir, n) for n in names]

    def _prune_segments(self) -> None:
        paths = self._segment_paths()
        keep = max(int(self.cfg.spill_max_segments), 1)
        for p in paths[:-keep] if len(paths) > keep else []:
            try:
                os.remove(p)
            except OSError:
                pass

    def spilled_frames(self) -> List[dict]:
        """Every frame still on disk, oldest first (post-mortem read
        path; segments beyond ``spill_max_segments`` are gone)."""
        paths = self._segment_paths() if self.cfg.spill_dir else []
        out: List[dict] = []
        for p in paths:
            try:
                with open(p) as fh:
                    for ln in fh:
                        if ln.strip():
                            out.append(json.loads(ln))
            except (OSError, ValueError):
                continue
        return out

    @property
    def spill_segments(self) -> int:
        return len(self._segment_paths()) if self.cfg.spill_dir else 0

    # ------------------------------------------------------------ queries
    def frames(self, t0: Optional[float] = None,
               t1: Optional[float] = None,
               limit: Optional[int] = None) -> List[dict]:
        """Frames with ``mono`` in ``(t0, t1]`` (None = unbounded),
        oldest first; ``limit`` keeps the newest N (0 = none — not
        "unlimited", matching the proxy routes' limit contract)."""
        with self._lock:
            out = [f for f in self._ring
                   if (t0 is None or f["mono"] > t0)
                   and (t1 is None or f["mono"] <= t1)]
        if limit is None:
            return out
        return out[-limit:] if limit > 0 else []

    def _matching(self, table: dict, name: str):
        """Series of ``table`` whose name is exactly ``name`` or a
        labeled member of the ``name`` family.  A fully-labeled name
        (contains ``{``) is one dict hit — the health evaluator's
        exact-series queries must not pay a per-frame linear scan."""
        v = table.get(name)
        if v is not None:
            yield v
        if "{" in name:
            return
        pref = name + "{"
        for k, v in table.items():
            if k.startswith(pref):
                yield v

    def counter_delta(self, name: str, t0: float,
                      t1: float) -> Optional[float]:
        """Summed counter delta of one series (or a whole family) over
        the window; None when NO frame covers ``(t0, t1]`` (the window
        is not computable yet — the ``_Window`` contract)."""
        frames = self.frames(t0, t1)
        if not frames:
            return None
        total = 0.0
        for f in frames:
            for v in self._matching(f.get("counters") or {}, name):
                total += v
        return total

    def hist_delta(self, name: str, t0: float,
                   t1: float) -> Optional[Tuple[float, float, Dict[int, float]]]:
        """Merged ``(count, sum, {bucket_index: count})`` histogram
        delta over the window; None when no frame covers it."""
        frames = self.frames(t0, t1)
        if not frames:
            return None
        count, total = 0.0, 0.0
        buckets: Dict[int, float] = {}
        for f in frames:
            for h in self._matching(f.get("hist") or {}, name):
                count += h.get("count", 0)
                total += h.get("sum", 0.0)
                for i, c in _norm_buckets(h.get("buckets") or {}).items():
                    buckets[i] = buckets.get(i, 0) + c
        return count, total, buckets

    def rate(self, name: str, t0: float, t1: float) -> Optional[float]:
        """Per-second rate of a counter series/family over the window:
        summed deltas / covered seconds.  None with no coverage."""
        frames = self.frames(t0, t1)
        if not frames:
            return None
        span = sum(f.get("dur", 0.0) for f in frames)
        if span <= 0:
            return None
        total = 0.0
        for f in frames:
            for v in self._matching(f.get("counters") or {}, name):
                total += v
        return total / span

    def quantile(self, name: str, q: float, t0: float,
                 t1: float) -> Optional[float]:
        """Windowed quantile of a histogram series/family — the SAME
        interpolator as :meth:`telemetry.Histogram.quantile` (one
        shared copy, :func:`telemetry.quantile_from_buckets`); None
        when the window saw nothing."""
        d = self.hist_delta(name, t0, t1)
        if d is None:
            return None
        _count, _sum, buckets = d
        items = sorted((i, c) for i, c in buckets.items() if c > 0)
        total = sum(c for _i, c in items)
        if total <= 0:
            return None
        return telemetry.quantile_from_buckets(items, total, q)

    # ------------------------------------------------------------ bundles
    def store_bundle(self, bundle: dict) -> None:
        """Retain one captured bundle (bounded: ``retain_bundles``,
        oldest evicted — a flapping node cannot hoard evidence)."""
        with self._lock:
            self._bundles.append(bundle)

    def bundles(self) -> List[dict]:
        with self._lock:
            return list(self._bundles)

    # -------------------------------------------------------------- meta
    def meta(self) -> dict:
        """JSON-able recorder state (embedded by ``GET /history`` and
        the bundles).  The spill listdir happens OUTSIDE the lock — a
        hung filesystem must not let a proxy scrape stall the
        scheduler tick thread (same hazard as the segment writes)."""
        segments = len(self._segment_paths()) if self.cfg.spill_dir else 0
        with self._lock:
            return {
                "enabled": self.enabled,
                "period": self.cfg.period,
                "capacity": self.cfg.capacity,
                "frames_held": len(self._ring),
                "bundles_held": len(self._bundles),
                "spill": {
                    "dir": self.cfg.spill_dir,
                    "active": bool(self.cfg.spill_dir
                                   and not self._spill_failed),
                    "segments": segments,
                    "segment_frames": self.cfg.spill_segment_frames,
                    "max_segments": self.cfg.spill_max_segments,
                },
            }

    # ---------------------------------------------------------- scheduling
    def attach(self, scheduler) -> None:
        """Schedule the periodic recording tick on the node scheduler
        (the NodeHealth attach pattern)."""
        if not self.enabled or self._job is not None:
            return
        self._sched = scheduler
        self._job = scheduler.add(scheduler.time() + self.cfg.period,
                                  self._tick_job)

    def _tick_job(self) -> None:
        try:
            self.tick()
        finally:
            self._job = self._sched.add(
                self._sched.time() + self.cfg.period, self._tick_job)


# ================================================== frame -> series view
def frames_to_series(frames: List[dict]) -> Dict[str, float]:
    """Sum a frame sequence into the SAME ``{series: value}`` shape
    ``testing/health_monitor.parse_exposition`` produces from a
    ``GET /stats`` scrape — counters as summed deltas, histogram
    buckets expanded to cumulative ``<family>_bucket{...,le="X"}``
    entries (plus ``_count``).  This is what lets ``dhtmon`` evaluate
    its windowed invariants (``lookup_success`` / ``cluster_quantile``)
    over history frames through the EXACT code path the scrape-diff
    mode uses — one delta codepath, pinned equal in
    tests/test_history.py."""
    out: Dict[str, float] = {}
    hist_acc: Dict[str, Dict[int, float]] = {}
    hist_count: Dict[str, float] = {}
    for f in frames:
        for k, v in (f.get("counters") or {}).items():
            out[k] = out.get(k, 0.0) + v
        for k, h in (f.get("hist") or {}).items():
            acc = hist_acc.setdefault(k, {})
            for i, c in _norm_buckets(h.get("buckets") or {}).items():
                acc[i] = acc.get(i, 0) + c
            hist_count[k] = hist_count.get(k, 0.0) + h.get("count", 0)
    for k, acc in hist_acc.items():
        family, _, rest = k.partition("{")
        labels = rest[:-1] if rest else ""
        cum = 0.0
        for i in sorted(acc):
            cum += acc[i]
            inner = (labels + "," if labels else "") + \
                'le="%s"' % _fmt(_bucket_le(i))
            out["%s_bucket{%s}" % (family, inner)] = cum
        out[family + "_count" + ("{%s}" % labels if labels else "")] = \
            hist_count.get(k, cum)
    return out


# ====================================================== bundle assembly
def build_bundle(*, reason: str = "on_demand", node_id: str = "",
                 status: str = "", history: Optional[MetricsHistory] = None,
                 health: Optional[dict] = None,
                 metrics: Optional[dict] = None,
                 keyspace: Optional[dict] = None,
                 cache: Optional[dict] = None,
                 ingest: Optional[dict] = None,
                 waterfall: Optional[dict] = None,
                 pipeline: Optional[dict] = None,
                 peers: Optional[dict] = None,
                 listeners: Optional[dict] = None,
                 tracer: Optional[tracing.Tracer] = None,
                 flight_limit: int = 400) -> dict:
    """Assemble one post-mortem black-box bundle (↔ the reference's
    ``Dht::dumpTables`` as a retained failure artifact): every section
    degrades to empty rather than raising — a half-up node must still
    bundle.  ``runtime/runner.py dump_bundle`` is the canonical
    caller; the sections are keyword-injected so tests and the smoke
    can bundle standalone recorders."""
    tr = tracer or tracing.get_tracer()
    bundle: dict = {
        "kind": BUNDLE_KIND,
        "schema": 1,
        "time": _time.time(),
        "reason": reason,
        "node_id": node_id,
        "status": status,
        "health": health or {},
        "metrics": metrics or {},
        "keyspace": keyspace or {},
        "cache": cache or {},
        "ingest": ingest or {},
        "waterfall": waterfall or {},
        "pipeline": pipeline or {},
        "peers": peers or {},
        "listeners": listeners or {},
        "history": {"enabled": False, "frames": []},
        "flight_recorder": {"spans": [], "events": []},
        "kernels": {},
        "auto_captures": [],
    }
    if history is not None:
        meta = history.meta()
        frames = history.frames(limit=history.cfg.bundle_frames)
        meta["frames"] = frames
        bundle["history"] = meta
        bundle["auto_captures"] = [
            {"time": b.get("time"), "reason": b.get("reason"),
             "transition": b.get("transition")}
            for b in history.bundles()]
    try:
        d = tr.dump()
        bundle["flight_recorder"] = {
            "node": d.get("node", ""),
            "capacity": d.get("capacity", 0),
            "spans": d.get("spans", [])[-flight_limit:],
            "events": d.get("events", [])[-flight_limit:],
        }
    except Exception:
        pass
    try:
        from . import profiling
        if profiling.ledger_computed():
            bundle["kernels"] = profiling.get_ledger().snapshot()
    except Exception:
        pass
    return bundle
