"""Load-aware resharding: the rebalance tick that closes the loop from
the keyspace observatory's imbalance gauge to traffic-weighted shard
boundaries — the port of the JAX package's ``reshard.py``, host code
unchanged.

The reference DHT balances load structurally — each node owns the XOR
neighborhood around its id (src/dht.cpp searchStep ownership) — so a
hot key only ever burdens the k nodes nearest it.  The t-sharded table
(parallel/partition.py) splits the sorted id space into uniform ~N/t
row slices, which a Zipf-skewed workload defeats: most wave traffic
lands on one shard.  The observatory measures exactly this
(``dht_shard_imbalance`` = max/mean of the per-shard loads folded from
its 256-bin histogram); this module acts on it.

One :class:`Resharder` rides the node scheduler (period
``ReshardConfig.period``).  Each tick:

1. reads the current windowed imbalance from the observatory,
2. runs it through the shared sustain latch
   (:func:`health.sustain_latch`, with a ``recover_ratio`` band so
   oscillation around the threshold does not restart the clock),
   corroborated against the history ring's frame samples over the
   sustain window (windowed evidence, not instants),
3. when the imbalance has exceeded ``rebalance_threshold`` for a full
   ``sustain`` window AND the ``min_interval`` cooldown since the last
   swap has passed, solves new boundaries from the observatory's load
   histogram (parallel/partition.py ``solve_shard_edges``, blended
   with row counts by ``rebalance_load_weight``) and installs a new
   :class:`ReshardLayout` generation.

Installing a layout is ONE attribute write on the DHT loop thread —
and because the loop is single-threaded, that write lands strictly
between wave launches.  The serving path (core/table.py
``Snapshot._shard_state``) keys its placed-operand cache on
``layout.gen``: the next wave rebuilds the sharded state at the new
boundaries (row movement + per-shard LUT rebuild — never a re-sort),
while waves already in flight keep the operands and perm map their
launch captured (the PendingLookup finalize closures), so every lookup
before, during and after the swap is bit-identical to the
single-device resolve.  On an unsharded node (no resolve mesh) a swap
changes only the observatory's virtual attribution and launches
nothing on the device.

Every skip is reason-labeled (``dht_reshard_skips_total{reason=}``:
below-threshold / hysteresis / cooldown / disabled / error), so a
transient burst shorter than the sustain window causing ZERO swaps is
observable, not inferred.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time as _time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np

from . import telemetry, tracing
from .health import sustain_latch

log = logging.getLogger("opendht_tpu_torch.reshard")

_IMB_GAUGE = "dht_shard_imbalance"


@dataclasses.dataclass
class ReshardConfig:
    """Knobs for the rebalance tick (``Config.reshard``)."""
    #: master switch — disabled ticks count skips with reason=disabled
    enabled: bool = True
    #: tick period on the node scheduler, seconds (<= 0 never ticks)
    period: float = 5.0
    #: windowed max/mean imbalance that arms the trigger (the same
    #: quantity ``dht_shard_imbalance`` exports)
    rebalance_threshold: float = 2.0
    #: seconds the imbalance must stay above threshold before a swap —
    #: a transient republish burst shorter than this causes zero swaps
    sustain: float = 15.0
    #: cooldown between swaps, seconds (anti-thrash)
    min_interval: float = 60.0
    #: blend of load vs row counts in the boundary solve: 1.0 = pure
    #: equal-traffic, 0.0 = equal-rows.  The default keeps a 10% row
    #: floor so a pathological histogram cannot starve a shard of rows
    #: (and bounds the weighted layout's per-shard capacity).
    rebalance_load_weight: float = 0.9
    #: hysteresis release band for the sustain latch: once armed, the
    #: imbalance must fall below threshold·recover_ratio to reset the
    #: clock (health.py SLO latch idiom)
    recover_ratio: float = 0.8


class ReshardLayout(NamedTuple):
    """One installed boundary generation.  ``bin_loads`` is the 256-bin
    load histogram the solve ran on — the serving path re-derives ROW
    boundaries from it per snapshot (raw row offsets go stale across
    table rebuilds), cached by ``gen``."""
    gen: int
    t: int
    #: interior fractional bin edges (len t-1) — virtual attribution
    #: and post-swap refold
    edges: Tuple[float, ...]
    #: the solver input (np.int64 [256], frozen at swap time)
    bin_loads: np.ndarray
    load_weight: float


class Resharder:
    """The rebalance state machine (see module docstring).

    ``shard_t`` is a zero-arg callable returning the live resolve-mesh
    ``t`` (0/1 = no physical sharding — the layout then drives VIRTUAL
    attribution at the observatory's ``virtual_shards`` split, same
    semantics as its uniform virtual fold).  ``on_swap(layout)`` is
    called inside the swap span with the new layout BEFORE it is
    installed — the Dht hook uses it to eagerly warm the snapshot's
    weighted shard state so the next wave doesn't pay the rebuild.
    """

    def __init__(self, cfg: Optional[ReshardConfig] = None, *,
                 node: str = "",
                 keyspace=None,
                 shard_t: Optional[Callable[[], int]] = None,
                 on_swap: Optional[Callable] = None,
                 clock: Callable[[], float] = _time.monotonic):
        self.cfg = cfg or ReshardConfig()
        self.node = node
        self.keyspace = keyspace
        self.shard_t = shard_t
        self.on_swap = on_swap
        self.clock = clock
        self.history = None               # wired by the runner post-build
        self._lock = threading.Lock()
        self._labels = {"node": node} if node else {}
        self._layout: Optional[ReshardLayout] = None
        self._gen = 0
        self._above_since: Optional[float] = None
        self._last_swap: Optional[float] = None
        self._last_mode = ""
        self._post_imbalance: Optional[float] = None
        self._ticks = 0
        self._swaps = 0
        self._skips: dict = {}
        self._job = None
        self._sched = None

    # ------------------------------------------------------------ wiring
    def attach(self, scheduler) -> None:
        """Arm the periodic tick on the node scheduler (same pattern as
        the observatory/history ticks — jobs serialize with wave
        launches on the DHT loop, which is what makes the swap's
        attribute write 'between waves' by construction)."""
        if not self.cfg.enabled or self.cfg.period <= 0:
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

    def set_history(self, history) -> None:
        """Late-bind the history ring (the runner builds it AFTER the
        Dht); the sustain check then reads windowed frame evidence in
        addition to its own latch."""
        self.history = history

    # ----------------------------------------------------------- reading
    @property
    def layout(self) -> Optional[ReshardLayout]:
        return self._layout

    def _skip(self, reason: str) -> None:
        with self._lock:
            self._skips[reason] = self._skips.get(reason, 0) + 1
        telemetry.get_registry().counter(
            "dht_reshard_skips_total", reason=reason, **self._labels).inc()

    def _windowed_imbalance(self, now: float) -> Optional[float]:
        """Min imbalance over the history ring's frame samples in the
        sustain window — frames record a gauge only when it CHANGED
        (delta encoding), so an empty scan means 'no counter-evidence'
        (None), not 'balanced'.  A -1 sample (unknown) counts as
        counter-evidence: an unknown instant inside the window breaks
        the sustained-overload claim."""
        h = self.history
        if h is None or not getattr(h, "enabled", False):
            return None
        try:
            frames = h.frames(now - self.cfg.sustain, now)
        except Exception:
            return None
        vals = []
        for f in frames:
            g = f.get("gauges") or {}
            for k, v in g.items():
                if k == _IMB_GAUGE or k.startswith(_IMB_GAUGE + "{"):
                    vals.append(float(v))
        return min(vals) if vals else None

    # -------------------------------------------------------------- tick
    def tick(self) -> dict:
        """One rebalance pass; returns the action taken (for tests and
        the REPL)."""
        reg = telemetry.get_registry()
        reg.counter("dht_reshard_ticks_total", **self._labels).inc()
        with self._lock:
            self._ticks += 1
        now = self.clock()
        if not self.cfg.enabled:
            self._skip("disabled")
            return {"action": "skip", "reason": "disabled"}
        ks = self.keyspace
        imb = ks.imbalance() if ks is not None else None
        thr = float(self.cfg.rebalance_threshold)
        self._above_since = sustain_latch(
            self._above_since, now, imb, thr, float(self.cfg.recover_ratio))
        if imb is None or imb <= thr:
            # includes the hysteresis band: latched but currently under
            # threshold — the clock holds, the trigger doesn't fire
            self._skip("below-threshold")
            return {"action": "skip", "reason": "below-threshold",
                    "imbalance": imb}
        if self._above_since is None \
                or (now - self._above_since) < float(self.cfg.sustain):
            self._skip("hysteresis")
            return {"action": "skip", "reason": "hysteresis",
                    "imbalance": imb,
                    "sustained": (0.0 if self._above_since is None
                                  else now - self._above_since)}
        wmin = self._windowed_imbalance(now)
        if wmin is not None and wmin <= thr:
            # frame evidence contradicts the latch: somewhere inside
            # the window the imbalance dipped below threshold (or went
            # unknown) — not a sustained overload
            self._skip("hysteresis")
            return {"action": "skip", "reason": "hysteresis",
                    "imbalance": imb, "window_min": wmin}
        if self._last_swap is not None \
                and (now - self._last_swap) < float(self.cfg.min_interval):
            self._skip("cooldown")
            return {"action": "skip", "reason": "cooldown",
                    "imbalance": imb}
        return self._swap(now, imb)

    # -------------------------------------------------------------- swap
    def _swap(self, now: float, imb_before: Optional[float]) -> dict:
        from .parallel.partition import solve_shard_edges
        from .keyspace import fold_bins, _imbalance
        cfg = self.cfg
        ks = self.keyspace
        t_phys = 0
        if self.shard_t is not None:
            try:
                t_phys = int(self.shard_t() or 0)
            except Exception:
                t_phys = 0
        virtual = t_phys <= 1
        t = t_phys if not virtual else max(
            2, int(getattr(getattr(ks, "cfg", None), "virtual_shards", 2)))
        loads = (ks.hist_window() if ks is not None
                 else np.zeros(256, np.int64))
        lam = float(cfg.rebalance_load_weight)
        edges = solve_shard_edges(loads, t, load_weight=lam)
        layout = ReshardLayout(
            gen=self._gen + 1, t=t,
            edges=tuple(float(e) for e in edges),
            bin_loads=np.asarray(loads, np.int64), load_weight=lam)
        reg = telemetry.get_registry()
        tr = tracing.get_tracer()
        mode = "virtual" if virtual else "physical"
        try:
            with reg.span("dht_reshard_swap_seconds", **self._labels), \
                    tr.span("reshard_swap", node=self.node,
                            gen=layout.gen, t=t, mode=mode):
                if self.on_swap is not None:
                    info = self.on_swap(layout) or {}
                    mode = info.get("mode", mode)
                # the installation: one attribute write, between waves
                self._layout = layout
                self._gen = layout.gen
        except Exception:
            log.exception("reshard swap failed; keeping layout gen=%d",
                          self._gen)
            self._skip("error")
            return {"action": "skip", "reason": "error"}
        self._last_swap = now
        self._above_since = None          # attribution restarts clean
        self._last_mode = mode
        # post-swap imbalance: the SAME histogram refolded at the new
        # edges — what the gauge will converge to once traffic continues
        post = _imbalance(fold_bins(loads, list(layout.edges)))
        self._post_imbalance = post
        reg.gauge("dht_reshard_post_imbalance", **self._labels).set(
            -1.0 if post is None else post)
        reg.gauge("dht_reshard_gen", **self._labels).set(layout.gen)
        with self._lock:
            self._swaps += 1
        reg.counter("dht_reshard_swaps_total", mode=mode,
                    **self._labels).inc()
        tr.event("reshard_swap", node=self.node, gen=layout.gen, t=t,
                 mode=mode,
                 imbalance_before=(-1.0 if imb_before is None
                                   else round(float(imb_before), 4)),
                 imbalance_after=(-1.0 if post is None
                                  else round(float(post), 4)))
        log.info("reshard swap gen=%d t=%d mode=%s imbalance %.3f -> %s",
                 layout.gen, t, mode,
                 -1.0 if imb_before is None else imb_before,
                 "?" if post is None else "%.3f" % post)
        return {"action": "swap", "gen": layout.gen, "t": t, "mode": mode,
                "imbalance_before": imb_before, "imbalance_after": post}

    # ---------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """JSON-able state — the ``reshard`` REPL command, the scanner
        section and the proxy accessor."""
        with self._lock:
            ticks, swaps = self._ticks, self._swaps
            skips = dict(self._skips)
        lay = self._layout
        now = self.clock()
        return {
            "enabled": bool(self.cfg.enabled),
            "gen": self._gen,
            "mode": self._last_mode,
            "threshold": float(self.cfg.rebalance_threshold),
            "sustain": float(self.cfg.sustain),
            "min_interval": float(self.cfg.min_interval),
            "load_weight": float(self.cfg.rebalance_load_weight),
            "ticks": ticks,
            "swaps": swaps,
            "skips": skips,
            "latched_s": (None if self._above_since is None
                          else round(now - self._above_since, 3)),
            "last_swap_age_s": (None if self._last_swap is None
                                else round(now - self._last_swap, 3)),
            "post_imbalance": self._post_imbalance,
            "layout": (None if lay is None else {
                "gen": lay.gen, "t": lay.t,
                "edges": [round(e, 4) for e in lay.edges],
            }),
        }
