"""Pipeline utilization observatory: lane timelines over the async wave plane.

A copy of the JAX package's ``pipeline_observatory.py`` with its behaviour unchanged.

The depth-N async pipeline broke the waterfall's
sequential-stage model — stages overlap, so sum-of-stages no longer
equals wall clock and in-flight device time reappears as ``queue_wait``.
This module answers the question the stage histograms no longer can:
*is the device busy, and if not, whose fault is the gap?*

Design (Dapper-style causality applied to the Orca-style pipeline):

- ``WaveBuilder`` reports per-wave lifecycle **edges** — fill_start,
  fill_done/dispatch, device_done, scatter_done — and the observatory
  folds them into a bounded, lane-structured timeline (``fill`` /
  ``device`` / ``drain`` lanes, same ring discipline as the flight
  recorder).  A wave's three lane intervals partition its wall-clock
  span exactly: fill = [fill_start, dispatch], device = [dispatch,
  device_done], drain = [device_done, scatter_done].
- **Device occupancy** is counted at busy/idle transitions: the device
  lane is busy while >= 1 wave is between dispatch and device_done.
  Cumulative busy seconds feed a windowed occupancy gauge
  (``dht_pipeline_occupancy``), with window checkpoints pushed on the
  history-ring frame cadence.
- **Bubble attribution**: every device-idle gap is classified at the
  idle->busy edge into exactly one cause and observed into
  ``dht_pipeline_bubble_seconds{cause=}``.  Because busy seconds are
  counted on the complementary edges, Σ(busy) + Σ(attributed bubbles)
  equals the observed window — the accounting is conservative and
  closed, and tests pin it against a host-side scalar oracle.
- **Overlap efficiency**: Σ(per-wave serial spans) over the union wall
  span of the retained timeline.  1.0 means depth-1 serial behaviour;
  >1.0 is measured fill∥device overlap — the always-on successor to
  ``captures/pipeline_overlap.json``'s one-shot evidence.

Everything here is host-side bookkeeping around the launch/consume
edges; device kernels are untouched and remain bit-identical with the
observatory on (pinned by tests and an overhead benchmark).
"""

from __future__ import annotations

import threading
import time as _time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

from . import telemetry
from . import tracing

__all__ = [
    "BUBBLE_CAUSES",
    "PipelineObservatoryConfig",
    "PipelineObservatory",
]

# Every device-idle gap is attributed to exactly one of these causes.
# Order matters twice: classification priority (first match wins among
# the flag-driven causes) and the index published by the top-cause
# gauge ``dht_pipeline_bubble_top_cause``.
BUBBLE_CAUSES = (
    "queue_empty",        # nothing submitted: idle because there was no work
    "fill_slow",          # work arrived but batching/deadline held the wave open
    "drain_backpressure", # pipeline full: fire blocked on draining an old wave
    "launch_retry",       # a launch/consume failure forced a requeue round-trip
    "reshard_swap",       # table generation changed between waves (hot swap)
    "cache_served",       # the whole wave was served from cache; device skipped
)

# Causes that indicate the serving plane is *starved* while work exists.
# queue_empty and cache_served are healthy idleness and never degrade
# the occupancy-collapse health signal.
STARVED_CAUSES = ("fill_slow", "drain_backpressure", "launch_retry", "reshard_swap")


@dataclass
class PipelineObservatoryConfig:
    """Tuning for the pipeline utilization observatory.

    Defaults keep the plane always-on: the per-edge cost is a few dict
    ops under a lock (no syscalls, no allocation beyond the ring slot),
    bounded <1% on the 8192-wave round (``captures/pipeutil_overhead.json``).
    """

    # Master switch.  Off => every hook is a cheap early return and the
    # occupancy gauge stays at -1 (unknown).
    enabled: bool = True
    # Closed wave records retained for overlap/lane export (flight-ring
    # discipline: bounded deque, oldest evicted first).
    ring: int = 512
    # Occupancy gauge window.  Checkpoints are pushed on the history
    # frame cadence; with no history attached the gauge degrades to
    # lifetime occupancy.
    window_s: float = 60.0
    # Bound on retained window checkpoints (one per history frame).
    checkpoints: int = 256


class _Wave:
    """One wave's lifecycle record (open until scatter_done)."""

    __slots__ = (
        "seq", "t_fill", "t_dispatch", "t_avail", "t_done",
        "n", "af", "k", "slot", "gen", "cause", "trace", "span", "cached",
    )

    def __init__(self, seq: int, t_fill: float, t_dispatch: float,
                 n: int, af: int, k: int, slot: int, gen: int,
                 cause: Optional[str]) -> None:
        self.seq = seq
        self.t_fill = t_fill
        self.t_dispatch = t_dispatch
        self.t_avail = -1.0
        self.t_done = -1.0
        self.n = n
        self.af = af
        self.k = k
        self.slot = slot
        self.gen = gen
        self.cause = cause       # bubble cause attributed at this dispatch edge
        self.trace = ""          # dht.search.wave trace id (hex), linked at close
        self.span = ""
        self.cached = False


class PipelineObservatory:
    """Concurrency-aware utilization plane over the wave pipeline.

    Thread-safety: edges arrive from the DHT maintenance thread while
    snapshots/exports are read from proxy handler threads — one lock
    guards all mutable state.  Edge methods are O(1); the overlap sweep
    is O(ring) and only runs at snapshot/frame cadence.
    """

    def __init__(self, config: Optional[PipelineObservatoryConfig] = None,
                 registry: Optional[telemetry.MetricsRegistry] = None,
                 clock: Callable[[], float] = _time.time) -> None:
        self.config = config or PipelineObservatoryConfig()
        self.enabled = bool(self.config.enabled)
        self._clock = clock
        self._lock = threading.Lock()

        self._seq = 0
        self._open: Dict[int, _Wave] = {}
        self._ring: Deque[_Wave] = deque(maxlen=max(1, int(self.config.ring)))

        # Device-lane busy/idle transition accounting.
        self._t0: Optional[float] = None        # first observed edge
        self._device_n = 0                      # waves between dispatch and device_done
        self._busy_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._cum_busy = 0.0                    # closed busy seconds
        self._cum_bubble: Dict[str, float] = {c: 0.0 for c in BUBBLE_CAUSES}
        self._bubble_n: Dict[str, int] = {c: 0 for c in BUBBLE_CAUSES}

        # Idle-gap cause flags, set between an idle edge and the next
        # dispatch; cleared once the gap is attributed.
        self._flag_retry = False
        self._flag_backpressure = False
        self._flag_cache = False
        self._last_gen: Optional[int] = None
        # fill_start of the wave currently batching (queue went 0 -> 1).
        self._fill_start: Optional[float] = None

        # Occupancy window checkpoints: (wall_t, cum_busy_at_t), pushed
        # on the history frame cadence.
        self._ckpts: Deque[Tuple[float, float]] = deque(
            maxlen=max(2, int(self.config.checkpoints)))

        # Occupancy-collapse window baseline (stage_budget-style diff).
        self._collapse_prev: Optional[Tuple[float, float, int]] = None

        reg = registry if registry is not None else telemetry.get_registry()
        self._m_occ = reg.gauge("dht_pipeline_occupancy")
        self._m_occ.set(-1.0)  # unknown until a window closes
        self._m_busy_total = reg.counter("dht_pipeline_device_busy_seconds_total")
        self._m_overlap = reg.gauge("dht_pipeline_overlap_ratio")
        self._m_overlap.set(-1.0)
        self._m_top_cause = reg.gauge("dht_pipeline_bubble_top_cause")
        self._m_top_cause.set(-1.0)
        self._m_bubble = {
            c: reg.histogram("dht_pipeline_bubble_seconds", cause=c)
            for c in BUBBLE_CAUSES
        }
        self._m_waves = reg.counter("dht_pipeline_waves_total")

    # ------------------------------------------------------------------
    # lifecycle edges (called by WaveBuilder; all O(1))

    def note_fill_start(self, t: Optional[float] = None) -> None:
        """Pending queue went 0 -> 1: a new wave starts batching."""
        if not self.enabled:
            return
        t = self._clock() if t is None else t
        with self._lock:
            if self._fill_start is None:
                self._fill_start = t
            if self._t0 is None:
                self._t0 = t
                self._idle_since = t

    def take_fill(self, t_pick: float) -> Optional[float]:
        """Fill done: the builder picked up the pending batch.

        Returns the fill_start edge for this wave group (or None when
        the observatory is off / no fill edge was seen) and re-arms for
        the next wave.
        """
        if not self.enabled:
            return None
        with self._lock:
            t_fill = self._fill_start
            self._fill_start = None
            return t_fill

    def note_backpressure(self) -> None:
        """Fire blocked on draining a full pipeline before launching."""
        if not self.enabled:
            return
        with self._lock:
            self._flag_backpressure = True

    def note_launch_retry(self) -> None:
        """A launch or consume failure forced a requeue round-trip."""
        if not self.enabled:
            return
        with self._lock:
            self._flag_retry = True

    def note_cache_served(self, t_fill: Optional[float], n: int) -> None:
        """An entire wave was served from cache; the device was skipped.

        Recorded as a fill-only wave in the ring (device/drain lanes
        empty) and flags the current idle gap as ``cache_served``.
        """
        if not self.enabled:
            return
        now = self._clock()
        with self._lock:
            self._flag_cache = True
            if self._t0 is None:
                self._t0 = t_fill if t_fill is not None else now
                self._idle_since = self._t0
            self._seq += 1
            w = _Wave(self._seq, t_fill if t_fill is not None else now,
                      now, n, 0, 0, -1, self._last_gen or 0, None)
            w.t_avail = now
            w.t_done = now
            w.cached = True
            self._ring.append(w)

    def on_dispatch(self, t_fill: Optional[float], t_dispatch: float,
                    n: int, af: int, k: int, slot: int, gen: int) -> int:
        """Wave dispatched to the device.  Returns the wave's seq.

        When the device lane was idle, the idle gap [idle_since,
        t_dispatch] is attributed to exactly one bubble cause here —
        the complementary edge to busy accounting, which keeps
        Σ(busy) + Σ(bubbles) == observed window.
        """
        if not self.enabled:
            return -1
        with self._lock:
            if self._t0 is None:
                self._t0 = t_fill if t_fill is not None else t_dispatch
                self._idle_since = self._t0
            cause: Optional[str] = None
            if self._device_n == 0:
                idle0 = self._idle_since if self._idle_since is not None else t_dispatch
                gap = t_dispatch - idle0
                if gap > 0.0:
                    cause = self._classify_locked(t_fill, idle0, t_dispatch, gen)
                    self._cum_bubble[cause] += gap
                    self._bubble_n[cause] += 1
                    self._m_bubble[cause].observe(gap)
                    self._refresh_top_cause_locked()
                self._busy_since = t_dispatch
                self._idle_since = None
                self._flag_retry = False
                self._flag_backpressure = False
                self._flag_cache = False
            self._device_n += 1
            self._last_gen = gen
            self._seq += 1
            seq = self._seq
            self._open[seq] = _Wave(seq, t_fill if t_fill is not None else t_dispatch,
                                    t_dispatch, n, af, k, slot, gen, cause)
            self._m_waves.inc()
            return seq

    def on_device_done(self, seq: int, t_avail: float) -> None:
        """Device results available for wave ``seq`` (consume returned)."""
        if not self.enabled or seq < 0:
            return
        with self._lock:
            w = self._open.get(seq)
            if w is not None:
                w.t_avail = t_avail
            if self._device_n > 0:
                self._device_n -= 1
                if self._device_n == 0 and self._busy_since is not None:
                    busy = max(0.0, t_avail - self._busy_since)
                    self._cum_busy += busy
                    self._m_busy_total.inc(busy)
                    self._busy_since = None
                    self._idle_since = t_avail
                    self._update_occupancy_gauge_locked(t_avail)

    def on_scatter_done(self, seq: int, t_done: float,
                        trace: str = "", span: str = "") -> None:
        """Results scattered back (or the wave abandoned): closes the
        wave's lane slices.  Failure paths must reach here too so the
        timeline never leaks an orphan open interval."""
        if not self.enabled or seq < 0:
            return
        with self._lock:
            w = self._open.pop(seq, None)
            if w is None:
                return
            if w.t_avail < 0.0:
                # Device edge never reported (abandoned mid-flight):
                # close conservatively at the scatter edge.
                w.t_avail = t_done
            w.t_done = max(t_done, w.t_avail)
            if trace:
                w.trace = trace
            if span:
                w.span = span
            self._ring.append(w)

    # ------------------------------------------------------------------
    # classification

    def _classify_locked(self, t_fill: Optional[float], idle0: float,
                         t_dispatch: float, gen: int) -> str:
        # Priority: explicit pipeline events first, then the fill-edge
        # geometry splits "no work" from "work batching too slowly".
        if self._flag_retry:
            return "launch_retry"
        if self._last_gen is not None and gen != self._last_gen:
            return "reshard_swap"
        if self._flag_backpressure:
            return "drain_backpressure"
        if self._flag_cache:
            return "cache_served"
        if t_fill is not None and t_fill < t_dispatch:
            # Gap = empty part [idle0, fill_start] + fill part
            # [fill_start, dispatch]; the dominant share names it.
            fill_part = t_dispatch - max(t_fill, idle0)
            empty_part = max(t_fill, idle0) - idle0
            return "fill_slow" if fill_part >= empty_part else "queue_empty"
        return "queue_empty"

    def _refresh_top_cause_locked(self) -> None:
        top, top_s = -1, 0.0
        for i, c in enumerate(BUBBLE_CAUSES):
            if self._cum_bubble[c] > top_s:
                top, top_s = i, self._cum_bubble[c]
        self._m_top_cause.set(float(top))

    # ------------------------------------------------------------------
    # derived signals

    def _cum_busy_at_locked(self, now: float) -> float:
        busy = self._cum_busy
        if self._busy_since is not None:
            busy += max(0.0, now - self._busy_since)
        return busy

    def occupancy(self, now: Optional[float] = None) -> Optional[float]:
        """Windowed device occupancy in [0, 1]; None while unknown."""
        if not self.enabled:
            return None
        now = self._clock() if now is None else now
        with self._lock:
            return self._occupancy_locked(now)

    def _occupancy_locked(self, now: float) -> Optional[float]:
        if self._t0 is None:
            return None
        target = now - float(self.config.window_s)
        base_t, base_busy = self._t0, 0.0
        for t, b in self._ckpts:
            if t <= target:
                base_t, base_busy = t, b
            else:
                break
        span = now - base_t
        if span <= 0.0:
            return None
        occ = (self._cum_busy_at_locked(now) - base_busy) / span
        return min(1.0, max(0.0, occ))

    def _update_occupancy_gauge_locked(self, now: float) -> None:
        occ = self._occupancy_locked(now)
        if occ is not None:
            self._m_occ.set(occ)

    def on_frame(self, now: Optional[float] = None) -> None:
        """History-ring frame hook: push an occupancy window checkpoint
        and refresh the windowed gauges."""
        if not self.enabled:
            return
        now = self._clock() if now is None else now
        with self._lock:
            if self._t0 is None:
                return
            self._ckpts.append((now, self._cum_busy_at_locked(now)))
            self._update_occupancy_gauge_locked(now)
            self._update_overlap_gauge_locked()

    def collapse(self) -> Optional[float]:
        """Degrade-only occupancy-collapse signal for the health engine.

        Windowed fraction of wall clock lost to *starved* bubbles
        (fill_slow / drain_backpressure / launch_retry / reshard_swap —
        queue_empty and cache_served are healthy idleness).  None when
        the window saw no pipeline activity (unknown, never degrades).
        """
        if not self.enabled:
            return None
        now = self._clock()
        with self._lock:
            starved = sum(self._cum_bubble[c] for c in STARVED_CAUSES)
            waves = int(self._m_waves.value)
            prev = self._collapse_prev
            self._collapse_prev = (now, starved, waves)
            if prev is None:
                return None
            dt = now - prev[0]
            if dt <= 0.0:
                return None
            d_starved = starved - prev[1]
            d_waves = waves - prev[2]
            if d_waves == 0 and d_starved <= 0.0:
                return None  # quiet window: unknown, not healthy-by-default
            return min(1.0, max(0.0, d_starved / dt))

    # ------------------------------------------------------------------
    # accounting / snapshot / export

    def account(self, now: Optional[float] = None) -> dict:
        """Closed busy/bubble ledger.  On an idle-free load, measured
        through the last idle edge, busy + bubbles == span (the oracle
        the tests pin)."""
        now = self._clock() if now is None else now
        with self._lock:
            # Close the ledger at the last attributed edge: the current
            # idle tail (if any) has not been classified yet.
            until = now if self._busy_since is not None else (
                self._idle_since if self._idle_since is not None else now)
            busy = self._cum_busy_at_locked(until)
            bubbles = dict(self._cum_bubble)
            span = (until - self._t0) if self._t0 is not None else 0.0
            return {
                "t0": self._t0,
                "until": until,
                "span_s": max(0.0, span),
                "busy_s": busy,
                "bubble_s": bubbles,
                "bubble_n": dict(self._bubble_n),
                "attributed_s": busy + sum(bubbles.values()),
                "open_waves": len(self._open),
            }

    def _update_overlap_gauge_locked(self) -> None:
        ratio = self._overlap_locked()
        self._m_overlap.set(ratio if ratio is not None else -1.0)

    def _overlap_locked(self) -> Optional[float]:
        """Σ(per-wave serial spans) / union wall span over the ring.
        1.0 == depth-1 serial; >1.0 is measured lane overlap."""
        spans = [(w.t_fill, w.t_done) for w in self._ring
                 if w.t_done >= 0.0 and w.t_done > w.t_fill]
        if not spans:
            return None
        spans.sort()
        serial = sum(t1 - t0 for t0, t1 in spans)
        union = 0.0
        cur0, cur1 = spans[0]
        for t0, t1 in spans[1:]:
            if t0 > cur1:
                union += cur1 - cur0
                cur0, cur1 = t0, t1
            else:
                cur1 = max(cur1, t1)
        union += cur1 - cur0
        if union <= 0.0:
            return None
        return serial / union

    def snapshot(self, now: Optional[float] = None) -> dict:
        """JSON-safe utilization snapshot (served on ``GET /pipeline``)."""
        if not self.enabled:
            return {"enabled": False}
        now = self._clock() if now is None else now
        with self._lock:
            occ = self._occupancy_locked(now)
            self._update_occupancy_gauge_locked(now)
            overlap = self._overlap_locked()
            self._m_overlap.set(overlap if overlap is not None else -1.0)
            top = -1
            top_s = 0.0
            for i, c in enumerate(BUBBLE_CAUSES):
                if self._cum_bubble[c] > top_s:
                    top, top_s = i, self._cum_bubble[c]
            return {
                "enabled": True,
                "occupancy": occ if occ is not None else -1.0,
                "window_s": float(self.config.window_s),
                "busy_seconds_total": self._cum_busy_at_locked(now),
                "waves_total": int(self._m_waves.value),
                "inflight_device": self._device_n,
                "open_waves": len(self._open),
                "overlap_ratio": overlap if overlap is not None else -1.0,
                "bubbles": {
                    c: {"seconds": self._cum_bubble[c], "count": self._bubble_n[c]}
                    for c in BUBBLE_CAUSES
                },
                "top_bubble_cause": BUBBLE_CAUSES[top] if top >= 0 else None,
                "ring": len(self._ring),
                "ring_cap": int(self._ring.maxlen or 0),
            }

    def lane_records(self) -> List[dict]:
        """Tracer-shaped records for the retained waves, one synthetic
        node per lane so ``tracing.to_chrome_trace`` renders one pid
        per lane with waves as slices, linked to their
        ``dht.search.wave`` spans via args."""
        with self._lock:
            waves = list(self._ring)
        out: List[dict] = []
        for w in waves:
            if w.t_done < 0.0:
                continue
            link = {"wave_seq": w.seq, "af": w.af, "k": w.k,
                    "pipeline_slot": w.slot, "reshard_gen": w.gen,
                    "entries": w.n}
            if w.trace:
                link["wave_trace_id"] = w.trace
            if w.span:
                link["wave_span_id"] = w.span
            if w.cause:
                link["bubble_cause"] = w.cause
            if w.cached:
                link["cache_served"] = True
            lanes = (("lane:fill", w.t_fill, w.t_dispatch),
                     ("lane:device", w.t_dispatch, w.t_avail),
                     ("lane:drain", w.t_avail, w.t_done))
            for li, (lane, t0, t1) in enumerate(lanes):
                if t1 < t0:
                    continue
                if w.cached and lane != "lane:fill":
                    continue  # cache-served waves never touched device/drain
                out.append({
                    "name": "wave %d" % w.seq,
                    "start": t0,
                    "dur": max(0.0, t1 - t0),
                    "trace_id": w.trace or ("%032x" % (w.seq & ((1 << 128) - 1))),
                    "span_id": "%016x" % (((w.seq << 2) | li) & ((1 << 64) - 1)),
                    "attrs": dict(link, lane=lane.split(":", 1)[1]),
                    "node": lane,
                })
        return out

    def chrome_trace(self) -> dict:
        """Perfetto/chrome://tracing lane export (``GET /pipeline?fmt=trace``)."""
        return tracing.to_chrome_trace(records=self.lane_records())
