"""Keyspace traffic observatory: where in the 160-bit ring traffic lands.

The port of the JAX package's ``keyspace.py``, with its behaviour
unchanged.  The telemetry, tracing and health layers say how fast and
how healthy the node is; this layer says WHERE traffic lands — the
row-sharded table and the ingest waves live or die on keyspace load
balance, and Kademlia's design calls for detecting popular keys to
relieve hot spots (Maymounkov & Mazières 2002 §4.1).  Built on the
device count-min sketch of :mod:`opendht_tpu_torch.ops.sketch`:

- :class:`KeyspaceObservatory` owns the ``[depth, width]`` sketch and
  the 256-bin top-8-bit histogram on the node's device, updated by one
  batched scatter-add per ingest wave (``runtime/wave_builder.py`` feeds
  the wave's ``[Q]`` target ids at ``_scatter``; stored-key puts ride
  the same update through :meth:`note_stored`'s pending buffer).  The
  update never reads the device back.
- **Heavy hitters**: a bounded host-side CANDIDATE set (sample-and-
  hold admission — every ``sample_stride``-th observed id) is re-scored
  against the sketch on a periodic scheduler tick (one batched
  ``sketch_query``), and the top-K with estimates/shares is retained.
  A key newly crossing the hot rule (share of window traffic >=
  ``hot_share`` AND estimate >= ``hot_min_count``) emits a
  ``hot_key_emerged`` flight event.
- **Windowing**: the tick applies exponential decay
  (``ops.sketch.sketch_decay``) so every surface reports a recent-
  traffic window, not a lifetime sum.
- **Shard load balance**: the 256-bin histogram is folded over shard
  boundaries (:func:`fold_bins`; a uniform ``virtual_shards`` split of
  the ring on the port, whose resolve is unsharded) into per-shard
  loads and one ``imbalance = max/mean`` ratio — the health engine's
  ``shard_imbalance`` signal.

Surfaces: ``dht_keyspace_*`` / ``dht_hotkey_*`` / ``dht_shard_imbalance``
gauges on the port's registry and ``DhtRunner.get_keyspace()``.

The sketch changes NO results anywhere: it only observes (the JAX
package pins the observatory's off state as result-identical).

The device is the node's (``device=``, None = the card).  A device that
fails when the sketch is first allocated, or any later update, query or
decay, degrades to a disabled observatory ("going dark") instead of
failing the node, as in the JAX package.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import telemetry, tracing
from .infohash import InfoHash
from .ops import sketch as sk
from .ops.ids import (HASH_BYTES, N_LIMBS, ids_from_bytes, ids_from_hashes,
                      ids_to_bytes)
from .ops.sketch import BINS

log = logging.getLogger("opendht_tpu_torch.keyspace")

__all__ = [
    "KeyspaceConfig", "KeyspaceObservatory", "bin_edges_from_ids",
    "bin_edges_uniform", "fold_bins",
]

# ========================================================== configuration
@dataclass
class KeyspaceConfig:
    """Declarative observatory configuration (lives on
    ``runtime.config.Config.keyspace``)."""

    #: master switch; "off" disables every launch and surface (the
    #: escape hatch — results identical either way, the sketch only
    #: observes)
    enabled: bool = True
    #: count-min geometry: depth rows x width columns of int32
    depth: int = 4
    width: int = 2048
    #: seconds between observatory ticks on the node scheduler (decay,
    #: heavy-hitter re-score, gauge refresh); 0 disables the tick
    tick: float = 2.0
    #: per-tick decay multiplier — counts are windowed, not lifetime
    #: (0.5 at a 2 s tick ~= a 4-6 s traffic window)
    decay: float = 0.5
    #: heavy hitters retained per tick
    top_k: int = 8
    #: host candidate-set bound (sample-and-hold admission)
    candidates: int = 512
    #: admit every Nth observed id into the candidate set (1 = every
    #: id; higher strides cut host cost, hot keys are still admitted
    #: with near-certainty because they recur)
    sample_stride: int = 8
    #: hot rule: a top-K key is HOT when its estimate is at least this
    #: share of the window total ...
    hot_share: float = 0.125
    #: ... and at least this absolute count (a 3-op boot window where
    #: one key is 2 of 3 observations is not a hot spot)
    hot_min_count: int = 32
    #: shard granularity for the imbalance signal when the table is
    #: NOT t-sharded (a uniform split of the ring — the load balance a
    #: t-way row-sharding WOULD see); a live resolve mesh overrides
    #: this with its actual shard boundaries
    virtual_shards: int = 8
    #: an imbalance below this many windowed observations is unknown,
    #: not a signal (absence of evidence is not imbalance)
    min_observed: int = 64
    #: bound on the stored-key pending buffer (drop-oldest): with
    #: ``tick=0`` and no wave traffic nothing ever drains it, and a
    #: put-only node would otherwise grow it for the process lifetime
    store_buffer: int = 4096


# ===================================================== histogram folding
def bin_edges_uniform(t: int, bins: int = BINS) -> List[float]:
    """Interior shard boundaries of a uniform t-way ring split, in
    fractional bin coordinates (len ``t - 1``)."""
    return [bins * s / t for s in range(1, t)]


def bin_edges_from_ids(boundary_ids, bins: int = BINS) -> List[float]:
    """Interior shard boundaries from the actual first-row ids of
    shards 1..t-1 of a sorted table (uint32 ``[t-1, 5]`` limbs or
    20-byte ids): fractional bin position = top-32-bits / 2^32 * bins.
    Bin-space resolution (2^-24 of a bin) is far below the 1-bin
    granularity the fold reports at."""
    arr = np.asarray(boundary_ids)
    if arr.dtype != np.uint32:
        arr = ids_from_bytes(arr.astype(np.uint8).reshape(-1, HASH_BYTES))
    top = arr.reshape(-1, N_LIMBS)[:, 0].astype(np.float64)
    return sorted((top / 2.0 ** 32 * bins).tolist())


def fold_bins(hist, edges: List[float]) -> List[float]:
    """Fold the per-bin counts over shard boundaries: shard ``s`` owns
    the keyspace ``[edges[s-1], edges[s])`` in bin coordinates, and a
    bin straddling an edge apportions its count by keyspace overlap
    (traffic is assumed uniform WITHIN a bin — the 1/256-ring
    resolution limit, stated in the snapshot).  Returns per-shard
    loads of length ``len(edges) + 1``; conserves ``sum(hist)``."""
    h = np.asarray(hist, np.float64)
    bounds = [0.0] + [min(max(float(e), 0.0), float(len(h)))
                      for e in edges] + [float(len(h))]
    loads = []
    for s in range(len(bounds) - 1):
        lo, hi = bounds[s], bounds[s + 1]
        if hi <= lo:
            loads.append(0.0)
            continue
        i0, i1 = int(np.floor(lo)), int(np.ceil(hi))
        total = 0.0
        for b in range(i0, min(i1, len(h))):
            c = h[b]
            if not c:
                continue
            overlap = min(hi, b + 1.0) - max(lo, float(b))
            if overlap > 0:
                total += float(c) * overlap
        loads.append(float(total))
    return loads


def _imbalance(loads: List[float]) -> Optional[float]:
    total = sum(loads)
    if total <= 0 or not loads:
        return None
    mean = total / len(loads)
    return float(max(loads) / mean)


# ============================================================ observatory
class KeyspaceObservatory:
    """Device sketch + histogram + host heavy-hitter state (module
    docstring).  One per :class:`~opendht_tpu_torch.runtime.dht.Dht`
    (``dht.keyspace``); standalone construction (no scheduler) is the
    unit-test surface — call :meth:`tick` manually."""

    def __init__(self, cfg: Optional[KeyspaceConfig] = None, *,
                 node: str = "",
                 shard_info: Optional[Callable] = None, device=None):
        """``shard_info()`` (optional) returns ``(t, boundary_ids)``
        for the live t-sharded table — ``t <= 1`` or ``None`` ids fall
        back to the uniform ``virtual_shards`` split.  ``device``: where
        the sketch lives (None = the CUDA card)."""
        self.cfg = cfg or KeyspaceConfig()
        self.node = node
        self._labels = {"node": node} if node else {}
        self._shard_info = shard_info
        self._device = device
        self._lock = threading.Lock()
        # device state (lazy: allocated on first observe; a failed
        # device downgrades to disabled instead of failing the node)
        self._sketch = None
        self._hist = None
        self._device_ok: "bool | None" = None if self.cfg.enabled else False
        # host state
        self._pending_store: List[bytes] = []    # keys awaiting a launch
        self._candidates: Dict[bytes, int] = {}  # id bytes -> host hits
        self._sample_phase = 0
        self._observed_total = 0                 # lifetime (counter twin)
        self._window_total = 0.0                 # decayed window total
        # the window the published products were SCORED against (set
        # per tick, pre-decay): snapshot/gauges must report estimates,
        # shares and window_total from the same instant — publishing
        # the post-decay accumulator made estimate > window_total and
        # share inconsistent by 1/decay)
        self._window_published = 0.0
        self._since_tick = 0
        # tick products (read by snapshot()/health from other threads;
        # replaced wholesale under the lock)
        self._top: List[dict] = []
        self._hot: set = set()
        self._loads: List[float] = []
        self._shard_t = 0
        self._shard_virtual = True
        self._imbalance: Optional[float] = None
        self._hist_host = np.zeros((BINS,), np.int64)
        self._job = None
        self._m_obs: Dict[str, object] = {}      # source -> counter
        # tick subscribers: the hot-key serving cache (and
        # anything else acting on the observatory's products) receives
        # each tick's heavy-hitter list — the observe→act seam
        self._subscribers: List[Callable] = []

    # ------------------------------------------------------------- device
    def _ensure_device(self) -> bool:
        if self._device_ok is not None:
            return self._device_ok
        try:
            self._sketch, self._hist = sk.sketch_init(
                self.cfg.depth, self.cfg.width, device=self._device)
            self._device_ok = True
        except Exception:
            log.warning("keyspace sketch unavailable (device %s does not "
                        "work); observatory disabled", self._device,
                        exc_info=True)
            self._device_ok = False
        return self._device_ok

    @property
    def enabled(self) -> bool:
        return self.cfg.enabled and self._device_ok is not False

    def _go_dark_locked(self) -> None:
        """Device failure: disable AND clear every published product
        (callers hold the lock).  A dead observatory must report
        unknown/empty, not the last window forever — the health signal
        reads :meth:`imbalance` every period, and a stale 7.0 would
        hold the node unhealthy on no evidence."""
        self._device_ok = False
        self._imbalance = None
        self._top = []
        self._hot = set()
        self._loads = []
        self._hist_host = np.zeros((BINS,), np.int64)
        self._window_total = 0.0
        self._window_published = 0.0

    def _pop_pending_locked(self):
        """Drain the buffered stored-key puts as a uint32 ``[n, 5]`` id
        batch, or ``None`` when nothing is pending (callers hold the
        lock) — the one copy of the buffer→ids conversion both flush
        sites (the wave-riding one in :meth:`observe_ids`, the idle-node
        one in :meth:`tick`) share."""
        if not self._pending_store:
            return None
        stored = ids_from_bytes(b"".join(self._pending_store))
        self._pending_store = []
        # the store series counts at FLUSH time, so it matches what the
        # sketch/window actually saw — counting at buffer time credited
        # keys the store_buffer bound evicted)
        c = self._m_obs.get("store")
        if c is None:
            c = self._m_obs["store"] = telemetry.get_registry().counter(
                "dht_keyspace_observed_total", source="store",
                **self._labels)
        c.inc(int(stored.shape[0]))
        return stored

    # ------------------------------------------------------------ ingest
    def note_stored(self, key: InfoHash) -> None:
        """Record one stored-key put.  Buffered host-side and flushed
        into the NEXT wave's scatter-add launch (or the tick's flush) —
        stores never cost their own device launch."""
        if not self.enabled:
            return
        with self._lock:
            self._pending_store.append(bytes(key))
            drop = (len(self._pending_store)
                    - max(1, int(self.cfg.store_buffer)))
            if drop > 0:
                # drop-oldest: a windowed observatory keeps the RECENT
                # traffic when the buffer has no drain (tick=0, no waves)
                del self._pending_store[:drop]

    def observe_hashes(self, targets, source: str = "wave") -> None:
        """Observe a wave's target ids (:class:`InfoHash` iterable) —
        the ``runtime/wave_builder.py _launch`` hook."""
        if not targets or not self.enabled:
            return
        self.observe_ids(ids_from_hashes(targets), source=source)

    def observe_ids(self, ids, source: str = "wave") -> None:
        """Observe a batch of ids (uint32 ``[Q, 5]``, numpy or device):
        ONE async scatter-add launch updating sketch + histogram, plus
        O(Q/stride) host dict ops for candidate sampling.  Never
        blocks; never raises into the wave path."""
        if not self.enabled or not self._ensure_device():
            return
        try:
            arr = np.ascontiguousarray(np.asarray(ids, np.uint32)
                                       ).reshape(-1, N_LIMBS)
        except Exception:
            log.exception("keyspace observe: bad id batch")
            return
        if arr.size == 0:
            return
        with self._lock:
            stored = self._pop_pending_locked()
            full = (np.concatenate([arr, stored], axis=0)
                    if stored is not None else arr)
            try:
                self._sketch, self._hist = sk.sketch_update(
                    self._sketch, self._hist, full)
            except Exception:
                log.exception("keyspace sketch update failed; disabling")
                self._go_dark_locked()
                dark = True
            else:
                dark = False
        if dark:
            self._export_gauges()       # gauges flip to unknown (-1)
            return
        with self._lock:
            n = int(full.shape[0])
            self._observed_total += n
            self._window_total += n
            self._since_tick += n
            self._admit_candidates_locked(full)
        c = self._m_obs.get(source)
        if c is None:
            with self._lock:
                c = self._m_obs.get(source)
                if c is None:
                    c = self._m_obs[source] = telemetry.get_registry(
                    ).counter("dht_keyspace_observed_total",
                              source=source, **self._labels)
        c.inc(int(arr.shape[0]))

    def _admit_candidates_locked(self, batch) -> None:
        """Sample-and-hold candidate admission over one observed batch
        (callers hold the lock): a round-robin phase over the stream —
        every stride-th id enters the candidate set, so a key with
        >= stride occurrences per window is admitted with
        near-certainty.  Shared by the wave path (:meth:`observe_ids`)
        and the tick's idle-node store flush — a hot stored key must be
        detectable whichever surface carried it."""
        stride = max(1, int(self.cfg.sample_stride))
        start = (-self._sample_phase) % stride
        self._sample_phase = (self._sample_phase + len(batch)) % stride
        sampled = batch[start::stride]
        if not len(sampled):
            return
        cand = self._candidates
        # canonical big-endian 20-byte id form — the same bytes
        # note_stored buffers and InfoHash serializes, so the
        # re-score reconstructs EXACTLY the observed ids
        for row in ids_to_bytes(sampled):
            kb = row.tobytes()
            cand[kb] = cand.get(kb, 0) + 1
        if len(cand) > self.cfg.candidates:
            self._prune_candidates()

    def _prune_candidates(self) -> None:
        """Evict the coldest half by host hit count (callers hold the
        lock).  Current top-K keys are always retained — a hot key must
        not be evicted by a burst of one-hit wonders."""
        keep = set(t["_key"] for t in self._top)
        items = sorted(self._candidates.items(), key=lambda kv: -kv[1])
        limit = max(self.cfg.candidates // 2, self.cfg.top_k)
        kept = {}
        for kb, hits in items:
            if kb in keep or len(kept) < limit:
                kept[kb] = hits
        self._candidates = kept

    # -------------------------------------------------------- subscribers
    def subscribe(self, cb: Callable[[List[dict]], None]) -> None:
        """Register a tick subscriber: ``cb(top)`` fires
        after every tick that (re)publishes the heavy-hitter list —
        ``top`` entries carry the canonical ``_key`` bytes alongside
        the public fields, so an acting layer (the hot-value cache) can
        key device state off them.  A dark/disabled tick notifies with
        an empty list so subscribers narrow/evict instead of holding a
        stale hot set."""
        self._subscribers.append(cb)

    def _notify(self, top: List[dict]) -> None:
        for cb in self._subscribers:
            try:
                cb(top)
            except Exception:
                log.exception("keyspace tick subscriber failed")

    # --------------------------------------------------------------- tick
    def attach(self, scheduler) -> None:
        """Arm the periodic tick on the node scheduler (decay, heavy-
        hitter re-score, gauge refresh)."""
        if not self.enabled or self.cfg.tick <= 0 or self._job is not None:
            return
        self._sched = scheduler
        self._job = scheduler.add(scheduler.time() + self.cfg.tick,
                                  self._tick_job)

    def _tick_job(self) -> None:
        try:
            self.tick()
        except Exception:
            log.exception("keyspace tick failed")
        finally:
            self._job = self._sched.add(
                self._sched.time() + self.cfg.tick, self._tick_job)

    def tick(self) -> dict:
        """One observatory pass: re-score the candidate set against the
        sketch (one batched query launch), retain the top-K, emit
        ``hot_key_emerged`` for keys newly crossing the hot rule, fold
        the histogram into per-shard loads + the imbalance ratio,
        refresh the gauges, then decay the window.  Cheap no-op while
        nothing has been observed."""
        if not self.enabled or (self._device_ok is not True
                                and not (self._pending_store
                                         and self._ensure_device())):
            if self.enabled:
                # disabled observatories never register their gauge
                # series (the permanently-zero-series rule)
                self._export_gauges()
            return self.snapshot()
        dark = False
        with self._lock:
            stored = self._pop_pending_locked()
            if stored is not None:
                # flush stores that no wave carried (idle node)
                try:
                    self._sketch, self._hist = sk.sketch_update(
                        self._sketch, self._hist, stored)
                except Exception:
                    # same go-dark contract as observe_ids: on an
                    # idle put-only node this flush is the SOLE device
                    # call, and a stale published window would hold
                    # the health signal on no evidence forever
                    log.exception("keyspace store flush failed; disabling")
                    self._go_dark_locked()
                    dark = True
                else:
                    self._window_total += stored.shape[0]
                    self._observed_total += stored.shape[0]
                    # admit BEFORE the candidate snapshot below so the
                    # flushed keys are re-scored this very tick
                    self._admit_candidates_locked(stored)
            dirty = self._since_tick > 0 or self._window_total > 0
            cand_keys = list(self._candidates)
            wt_seen = self._window_total
            sketch = self._sketch
            hist = self._hist
        if dark:
            self._export_gauges()       # gauges flip to unknown (-1)
            self._notify([])            # subscribers drop the hot set
            return self.snapshot()
        if not dirty:
            self._export_gauges()
            # quiet ticks still notify subscribers with the retained
            # top: the acting layers' windows
            # must roll and their TTL sweeps must run on an idle node —
            # a frozen hit-ratio window would hold the degrade-only
            # health signal (and dhtmon --min-cache-hit) on a stale
            # low ratio forever
            with self._lock:
                top = list(self._top)
            self._notify(top)
            return self.snapshot()
        # ---- heavy hitters: candidate re-score, ONE batched query
        top: List[dict] = []
        if cand_keys:
            ids = ids_from_bytes(b"".join(cand_keys))
            try:
                est = sk.sketch_query(sketch, ids).cpu().numpy()
            except Exception:
                log.exception("keyspace re-score failed; disabling")
                with self._lock:
                    self._go_dark_locked()
                self._export_gauges()   # gauges flip to unknown (-1)
                self._notify([])        # subscribers drop the hot set
                return self.snapshot()
            order = np.argsort(-est, kind="stable")[:self.cfg.top_k]
            wt = max(wt_seen, 1.0)
            for i in order:
                e = int(est[int(i)])
                if e <= 0:
                    continue
                kb = cand_keys[int(i)]
                share = e / wt
                top.append({
                    "key": kb.hex(), "_key": kb, "estimate": e,
                    "share": round(share, 4),
                    "hot": (share >= self.cfg.hot_share
                            and e >= self.cfg.hot_min_count),
                })
        # ---- shard loads off the histogram
        hist_host = hist.cpu().numpy().astype(np.int64)
        t, edges, virtual = self._shard_edges()
        loads = fold_bins(hist_host, edges)
        total = float(hist_host.sum())
        imb = (_imbalance(loads)
               if total >= self.cfg.min_observed else None)
        # ---- publish + events
        tr = tracing.get_tracer()
        with self._lock:
            prev_hot = self._hot
            hot = set(t_["_key"] for t_ in top if t_["hot"])
            for t_ in top:
                if t_["hot"] and t_["_key"] not in prev_hot \
                        and tr.enabled:
                    tr.event("hot_key_emerged", node=self.node,
                             key=t_["key"], estimate=t_["estimate"],
                             share=t_["share"],
                             window_total=int(wt_seen))
            self._top = top
            self._hot = hot
            self._window_published = wt_seen
            self._loads = loads
            self._shard_t = t
            self._shard_virtual = virtual
            self._imbalance = imb
            self._hist_host = hist_host
            self._since_tick = 0
            # ---- decay: window, not lifetime
            if self.cfg.decay < 1.0:
                try:
                    self._sketch, self._hist = sk.sketch_decay(
                        self._sketch, self._hist, self.cfg.decay)
                except Exception:
                    # go-dark like every other device-call site: the
                    # products published just above are cleared rather
                    # than frozen at the last good window
                    log.exception("keyspace decay failed; disabling")
                    self._go_dark_locked()
                else:
                    self._window_total *= self.cfg.decay
                    if self._window_total < 1.0:
                        # a fully-decayed window goes quiet: later idle
                        # ticks are dict checks, not device launches
                        self._window_total = 0.0
                    for kb in list(self._candidates):
                        hits = self._candidates[kb] >> 1
                        if hits or kb in hot:
                            self._candidates[kb] = hits
                        else:
                            del self._candidates[kb]
            went_dark = self._device_ok is False
        self._export_gauges()
        # acting layers (the hot-value cache) see the SAME top list the
        # snapshot publishes — or an empty one if the decay launch went
        # dark (the published products were cleared with it)
        self._notify([] if went_dark else top)
        return self.snapshot()

    def _shard_edges(self) -> Tuple[int, List[float], bool]:
        """(t, interior bin edges, virtual): ``t > 0`` when a resolve
        mesh serves; ``virtual`` is False ONLY when the edges are the
        table's actual boundary ids — a mesh whose shard_info falls
        back (no snapshot yet, partially-filled table) folds over the
        uniform split and must say so, or the snapshot reports a
        uniform ring split as real per-shard loads.

        ``shard_info`` may return ``(t, bounds)`` or — as the JAX
        package's reshard plane does — ``(t, bounds, virtual)``, where
        ``bounds`` is either boundary *ids* (uint limb rows) or
        pre-folded fractional *bin edges* (floats, the virtual
        resharded split).  Fold attribution always follows the edges
        of the CURRENT layout: frames recorded before a swap keep the
        values folded at their own tick (frames are immutable deltas),
        later ticks attribute to the new ownership."""
        if self._shard_info is not None:
            try:
                info = self._shard_info()
                t, bounds = info[0], info[1]
                virtual = info[2] if len(info) > 2 else None
                if t and t > 1:
                    if bounds is not None and len(bounds):
                        arr = np.asarray(bounds)
                        if arr.dtype.kind == "f":
                            edges = [float(x) for x in np.sort(arr)]
                            return t, edges, (True if virtual is None
                                              else bool(virtual))
                        return t, bin_edges_from_ids(bounds), (
                            False if virtual is None else bool(virtual))
                    return t, bin_edges_uniform(t), True
            except Exception:
                log.debug("keyspace shard_info failed", exc_info=True)
        t = max(2, int(self.cfg.virtual_shards))
        return 0, bin_edges_uniform(t), True

    def _export_gauges(self) -> None:
        reg = telemetry.get_registry()
        with self._lock:
            imb = self._imbalance
            top = self._top
            wt = self._window_published
            occupied = int(np.count_nonzero(self._hist_host))
            hot_n = len(self._hot)
        reg.gauge("dht_keyspace_window_total", **self._labels).set(wt)
        reg.gauge("dht_keyspace_occupied_bins", **self._labels).set(occupied)
        reg.gauge("dht_hotkey_count", **self._labels).set(hot_n)
        reg.gauge("dht_hotkey_top_estimate", **self._labels).set(
            top[0]["estimate"] if top else 0)
        # -1 = unknown (below min_observed), same convention as the
        # health signal gauges
        reg.gauge("dht_shard_imbalance", **self._labels).set(
            -1.0 if imb is None else imb)

    # ---------------------------------------------------------- read side
    def imbalance(self) -> Optional[float]:
        """Last tick's max/mean per-shard load ratio; None below
        ``min_observed`` windowed observations OR while the observatory
        is disabled/dark (unknown, not balanced) — the
        ``shard_imbalance`` health-signal provider."""
        if not self.enabled:
            return None
        return self._imbalance

    def hist_window(self):
        """Copy of the last published 256-bin windowed load histogram
        (int64, top-8-bit key space) — the reshard tick's solver input
        in the JAX package (``reshard.py``): boundaries are solved from the SAME
        fold space the imbalance gauge measures in."""
        with self._lock:
            return np.array(self._hist_host, np.int64, copy=True)

    def top_keys(self) -> List[dict]:
        """Last tick's heavy hitters (key hex, windowed estimate,
        share, hot flag)."""
        with self._lock:
            return [{k: v for k, v in t.items() if k != "_key"}
                    for t in self._top]

    def snapshot(self) -> dict:
        """JSON-able observatory state — the proxy ``GET /keyspace``
        body, the ``keyspace`` REPL command and the scanner section."""
        with self._lock:
            imb = self._imbalance
            loads = list(self._loads)
            t = self._shard_t
            virtual = self._shard_virtual
            hist = self._hist_host.tolist()
            top = [{k: v for k, v in t_.items() if k != "_key"}
                   for t_ in self._top]
            wt = self._window_published
            lifetime = self._observed_total
            cands = len(self._candidates)
        return {
            "enabled": bool(self.enabled),
            "depth": self.cfg.depth,
            "width": self.cfg.width,
            "decay": self.cfg.decay,
            "tick_s": self.cfg.tick,
            "observed_total": int(lifetime),
            "window_total": round(wt, 1),
            "candidates": cands,
            "hist_bins": BINS,
            "hist": hist,
            "occupied_bins": int(sum(1 for c in hist if c)),
            "top": top,
            "hot_keys": [t_["key"] for t_ in top if t_["hot"]],
            "shards": {
                # t == 0: no live resolve mesh.  virtual: the loads
                # attribute to a uniform ring split (what a t-way
                # sharding WOULD see) — also True for a LIVE mesh whose
                # shard_info fell back (no snapshot / partial fill)
                "t": t,
                "virtual": virtual,
                "n": len(loads),
                "loads": [round(x, 2) for x in loads],
                "imbalance": (round(imb, 4) if imb is not None else None),
            },
        }
