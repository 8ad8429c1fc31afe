"""Cluster health observatory: the declarative SLO engine + node verdict.

The observability layers (telemetry, tracing / flight recorder) export
raw signals; this module *interprets* them — a health model, SLO
evaluation and a readiness verdict:

- :class:`SloObjective` / :class:`HealthConfig` — a declarative per-op
  objective set (availability = fraction of ops with ``ok=true``;
  latency = fraction of ops under a threshold), configured through
  ``runtime/config.py`` (``Config.health``).
- :class:`HealthEvaluator` — multi-window **burn-rate** evaluation
  (Google SRE style): per objective, the error-budget burn rate —
  observed bad fraction / allowed bad fraction — is computed over a
  *fast* window (sudden total failure pages within seconds) and a
  *slow* window (a 2-3x budget leak that a fast window never sees).
  The evaluator reads ONLY the registry (log-bucket
  ``Histogram`` deltas, counters, gauges): each tick snapshots the
  cumulative series and windows are differences of snapshots — no new
  instrumentation on any hot path, no device work, kernels untouched.
- Derived per-node signals, thresholded ``ok | degraded | unhealthy``:
  ingest queue saturation vs ``ingest_queue_max`` (the wave
  builder), scheduler tick lag (windowed p95 of
  ``dht_scheduler_tick_lag_seconds``), request timeout ratio
  (``dht_net_requests_expired_total`` / ``..._sent_total`` deltas),
  stale-bucket fraction from the ``maintenance_sweep``
  outputs, and node connectivity.
- One rolled-up verdict ``healthy | degraded | unhealthy`` with
  per-signal attribution and **hysteresis** (a tripped objective clears
  only below ``recover_ratio`` x its threshold, so a boundary value
  cannot flap the verdict).  Zero traffic / empty registry reports
  *healthy-unknown* — absence of evidence is not an outage.
- Evaluated on a periodic scheduler tick (``runtime/runner.py`` attaches
  :class:`NodeHealth`), emitting ``health_transition`` /
  ``slo_violation`` flight-recorder events (ring) so every
  degradation is trace-correlatable, and ``dht_health_*`` /
  ``dht_slo_*`` gauges on the same registry ``get_metrics()`` and the
  proxy ``GET /stats`` already export.

Surfaces: ``DhtRunner.get_health()``; in the JAX package also the
proxy's ``GET /healthz``, the REPL, the scanner and the cluster
aggregator, which are not ported yet.

Reference mapping: the reference's only health surface is
``Dht::getNodesStats`` (src/dht.cpp:1424-1444) — raw routing counters a
human inspects.  This module is what a service fleet needs instead: the
counters stay (folded into ``dht_routing_*``), and the
verdict machine on top is the part the reference leaves to the reader.

Import-light by design (stdlib + the telemetry/tracing spine) so the
evaluator runs in minimal containers and pure-registry unit tests.

A copy of the JAX package's ``health.py`` with its behaviour unchanged.
The keyspace and hot-cache signals read their planes through
``getattr(dht, ..., None)``; those planes are not ported (ROADMAP A.2),
so the signals read as absent (unknown), as on a JAX node with the
planes off.
"""

from __future__ import annotations

import logging
import time as _time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import telemetry, tracing
from .telemetry import _bucket_index, _bucket_le

log = logging.getLogger("opendht_tpu_torch.health")

__all__ = [
    "HEALTHY", "DEGRADED", "UNHEALTHY", "SloObjective", "HealthConfig",
    "HealthEvaluator", "NodeHealth", "default_slos", "parse_alerts",
    "percentile_breaches", "quantile_from_cumulative",
]

HEALTHY, DEGRADED, UNHEALTHY = "healthy", "degraded", "unhealthy"
_RANK = {HEALTHY: 0, DEGRADED: 1, UNHEALTHY: 2}
_BY_RANK = (HEALTHY, DEGRADED, UNHEALTHY)


# ===================================================== shared alert grammar
def parse_alerts(specs) -> dict:
    """``["p95=2.5", "50=1"]`` → {95: 2.5, 50: 1.0}; raises ValueError
    on malformed specs or percentiles outside (0, 100).  The ONE
    ``--alert PCT=SEC`` grammar shared by testing/network_monitor.py,
    testing/health_monitor.py and tools/dhtmon.py in the JAX
    package."""
    out: dict = {}
    for spec in specs or ():
        name, _, thr = spec.partition("=")
        if not thr:
            raise ValueError("alert spec %r is not PCT=SECONDS" % spec)
        p = float(name.lstrip("pP"))
        if not 0 < p < 100:
            raise ValueError("alert percentile %r outside (0, 100)" % name)
        out[p] = float(thr)
    return out


def percentile_breaches(quantile_fn: Callable[[float], Optional[float]],
                        alerts: dict) -> List[Tuple[float, float, float]]:
    """Evaluate one ``parse_alerts`` threshold map against a quantile
    source (``quantile_fn(q)`` with q in (0,1); None = no data).
    Returns ``[(pct, observed, threshold)]`` for every breached alert —
    the cumulative-percentile check network_monitor and dhtmon share."""
    out = []
    for pct, thr in sorted(alerts.items()):
        v = quantile_fn(pct / 100.0)
        if v is not None and v > thr:
            out.append((pct, v, thr))
    return out


def quantile_from_cumulative(pairs: List[Tuple[float, float]],
                             q: float) -> Optional[float]:
    """Linear-interpolated quantile over cumulative ``(le, count)``
    pairs (a Prometheus ``_bucket`` series, or any cumulative
    histogram) — the exposition-side twin of
    :meth:`telemetry.Histogram.quantile`.  ``None`` when empty."""
    pairs = sorted((float(le), float(c)) for le, c in pairs
                   if le != float("inf"))
    total = pairs[-1][1] if pairs else 0.0
    if total <= 0:
        return None
    target = q * total
    prev_le, prev_c = 0.0, 0.0
    for le, c in pairs:
        if c >= target:
            inb = c - prev_c
            frac = (target - prev_c) / inb if inb > 0 else 1.0
            return prev_le + (le - prev_le) * min(max(frac, 0.0), 1.0)
        prev_le, prev_c = le, c
    return pairs[-1][0]


# ========================================================== configuration
@dataclass(frozen=True)
class SloObjective:
    """One declarative objective over the ``dht_op_seconds`` /
    ``dht_ops_total`` series of a public op.

    - ``kind="availability"``: ``objective`` is the target success
      fraction of ``dht_ops_total{op=,ok=}`` (bad = ``ok="false"``).
    - ``kind="latency"``: ``objective`` is the target fraction of
      ``dht_op_seconds{op=}`` observations at or under ``threshold_s``
      (bad = over-threshold ops) — the standard reduction that lets one
      burn-rate machine serve both objective kinds."""

    name: str
    op: str
    kind: str = "availability"
    objective: float = 0.99
    threshold_s: float = 1.0


def default_slos() -> tuple:
    """The default per-op objective set: 99% availability on the three
    public op families, 95% of gets/puts under 4 s (generous enough
    for WAN deployments; tighten via ``Config.health.slos``).  4 s is
    a log-bucket EDGE, so the default over-threshold counts are exact,
    not interpolated (see :func:`_count_over`)."""
    return (
        SloObjective("get_availability", "get"),
        SloObjective("put_availability", "put"),
        SloObjective("listen_availability", "listen"),
        SloObjective("get_latency", "get", "latency", 0.95, 4.0),
        SloObjective("put_latency", "put", "latency", 0.95, 4.0),
    )


#: per-signal (degraded, unhealthy) thresholds; values are fractions
#: except scheduler_lag (seconds, windowed p95) and connectivity
#: (0 = connected, 1 = connecting, 2 = disconnected)
DEFAULT_SIGNAL_THRESHOLDS = {
    "connectivity": (0.5, 1.5),
    "ingest_queue": (0.5, 0.9),
    "scheduler_lag": (0.5, 2.0),
    "timeout_ratio": (0.5, 0.9),
    "stale_buckets": (0.6, 0.95),
    # max/mean per-shard keyspace traffic off the
    # observatory's folded histogram — 1.0 is perfect balance, t is a
    # single-shard flood.  3x the fair share degrades; 6x (a de-facto
    # single-key/single-shard hot spot at the default 8-way
    # attribution) would be unhealthy, but the signal is capped at
    # degraded in the verdict by default (HealthConfig.degrade_only) —
    # see the field comment.  Unknown below the observatory's
    # min_observed window, so boot noise never trips it.
    "shard_imbalance": (3.0, 6.0),
    # the hot-key serving cache's windowed MISS
    # fraction (1 − dht_cache_hit_ratio) — the engine thresholds on
    # "bigger is worse", so the signal VALUE is the miss side of the
    # ratio the gauges/dhtmon report.  Unknown (never trips) while the
    # cache is disabled, dark, or had no eligible probes in the
    # window; capped at degraded in the verdict (degrade_only): a cold
    # cache is an efficiency problem, not a liveness one.
    "cache_hit_ratio": (0.5, 0.9),
    # the waterfall's windowed worst-stage
    # p95/budget ratio (waterfall.StageProfiler.stage_budget) — 1.0
    # means the slowest serving stage sits exactly at its budgeted
    # p95; 2.0 is a 2x blowout.  Unknown until a stage accrues enough
    # samples in the window, device_compile excluded (one-time XLA
    # lowering).  Capped at degraded in the verdict (degrade_only): a
    # slow stage is an efficiency regression, not lost liveness.
    "stage_budget": (1.0, 2.0),
    # occupancy collapse — the pipeline
    # observatory's windowed fraction of wall clock lost to STARVED
    # device-idle bubbles (fill_slow / drain_backpressure /
    # launch_retry / reshard_swap; queue_empty and cache_served are
    # healthy idleness and never count).  Half the window starved
    # degrades; 0.9 would be unhealthy-grade, but the signal is capped
    # at degraded in the verdict (degrade_only): a starved pipeline is
    # an efficiency collapse, not lost liveness.  Unknown (never
    # trips) while the observatory is off or the window saw no waves.
    "pipeline_occupancy": (0.5, 0.9),
    # worst single-link fail ratio from the
    # per-peer ledger (opendht_tpu_torch/peers.py) — expired / finished
    # requests of the worst peer with at least
    # Config.peers.min_signal_events requests.  Half the requests to
    # ONE peer failing degrades; 0.9 would be unhealthy-grade, but the
    # signal is capped at degraded in the verdict (degrade_only): one
    # bad link (or one dead remote peer flapping good<->dubious<->
    # expired) is a wire problem to route around, not lost liveness of
    # THIS node — the cluster-wide view is already timeout_ratio.
    # Unknown (never trips) while the ledger is off or no peer
    # qualifies.
    "peer_flap": (0.5, 0.9),
}


@dataclass
class HealthConfig:
    """Declarative health/SLO configuration (lives on
    ``runtime.config.Config.health``)."""

    #: seconds between evaluator ticks on the node scheduler; 0 = the
    #: runner never attaches an evaluator (health surfaces report
    #: verdict "unknown")
    period: float = 1.0
    slos: tuple = field(default_factory=default_slos)
    #: fast-burn pair: sudden total failure trips within one window
    fast_window: float = 60.0
    fast_burn: float = 14.4
    #: slow-burn pair: a sustained modest budget leak
    slow_window: float = 600.0
    slow_burn: float = 6.0
    #: hysteresis: a tripped window clears only below
    #: ``threshold * recover_ratio`` (no flapping on a boundary value)
    recover_ratio: float = 0.8
    #: a window with fewer events than this never trips (one failed op
    #: at boot is not an outage)
    min_events: int = 4
    #: signal name -> (degraded, unhealthy) threshold pair
    signal_thresholds: dict = field(
        default_factory=lambda: dict(DEFAULT_SIGNAL_THRESHOLDS))
    #: signals whose level is capped at degraded in the verdict:
    #: load-balance attribution is capacity planning, not liveness —
    #: legitimately concentrated traffic (a republish calendar bin's
    #: searches all land XOR-close to the node's own id, one narrow
    #: ring slice) can exceed the unhealthy threshold for a window on
    #: a perfectly healthy node, and must not 503 its /healthz
    #: readiness behind a load balancer.
    #: cache_hit_ratio rides the same cap: a cold or
    #: miss-heavy cache degrades efficiency, never liveness.
    #: stage_budget joins it: a stage past its latency
    #: budget is slow serving, not a down node.  pipeline_occupancy
    #: joins it: a starved pipeline serves slowly, it is
    #: not dead.  peer_flap joins it: ONE bad link is a
    #: wire problem to route around, not lost liveness of this node.
    degrade_only: tuple = ("shard_imbalance", "cache_hit_ratio",
                           "stage_budget", "pipeline_occupancy",
                           "peer_flap")


# ====================================================== window bookkeeping
class _Window:
    """History of cumulative sample tuples -> windowed deltas.  Keeps
    one entry older than ``keep`` as the baseline for the longest
    window; all math is snapshot subtraction, so the underlying series
    stay untouched."""

    __slots__ = ("keep", "_h")

    def __init__(self, keep: float):
        self.keep = keep
        self._h: deque = deque()

    def push(self, t: float, vals) -> None:
        self._h.append((t, vals))
        cutoff = t - self.keep
        while len(self._h) > 2 and self._h[1][0] <= cutoff:
            self._h.popleft()

    def delta(self, now: float, window: float):
        """``(baseline_vals, current_vals, span_s)`` against the newest
        entry at least ``window`` old (or the oldest held — a young
        process evaluates over its whole life); None before two
        snapshots exist."""
        if len(self._h) < 2:
            return None
        target = now - window
        base = self._h[0]
        for ent in self._h:
            if ent[0] <= target:
                base = ent
            else:
                break
        cur = self._h[-1]
        if cur[0] <= base[0]:
            return None
        return base[1], cur[1], cur[0] - base[0]


def _count_over(dbuckets: Dict[int, int], threshold: float) -> float:
    """Observations above ``threshold`` in a bucket-index delta map
    (log-bucket scheme of telemetry.Histogram), interpolating inside
    the landing bucket.  Exact when the threshold is a power of two
    (the bucket edge), which the SLO defaults and tests use."""
    i = _bucket_index(threshold)
    over = 0.0
    for j, c in dbuckets.items():
        if c <= 0:
            continue
        if j > i:
            over += c
        elif j == i:
            lo = 0.0 if i == 0 else _bucket_le(i - 1)
            hi = _bucket_le(i)
            frac = (hi - threshold) / (hi - lo) if hi > lo else 0.0
            over += c * min(max(frac, 0.0), 1.0)
    return over


def _delta_quantile(dbuckets: Dict[int, int], q: float) -> Optional[float]:
    """Quantile over a bucket-index delta map — the SAME interpolator
    as telemetry.Histogram.quantile (one shared copy,
    telemetry.quantile_from_buckets); None when the window saw
    nothing."""
    items = sorted((i, c) for i, c in dbuckets.items() if c > 0)
    total = sum(c for _i, c in items)
    if total <= 0:
        return None
    return telemetry.quantile_from_buckets(items, total, q)


def _sub_buckets(cur: Dict[int, int], base: Dict[int, int]) -> Dict[int, int]:
    return {i: cur.get(i, 0) - base.get(i, 0)
            for i in set(cur) | set(base)}


# ============================================================ SLO engine
class _SloState:
    """Per-objective burn-rate state: cumulative snapshots + the two
    window trip latches (with hysteresis)."""

    __slots__ = ("obj", "win", "fast_active", "slow_active", "level",
                 "detail")

    def __init__(self, obj: SloObjective, keep: float):
        self.obj = obj
        self.win = _Window(keep)
        self.fast_active = False
        self.slow_active = False
        self.level = HEALTHY
        self.detail: dict = {}


def _latch(active: bool, trip_burn: Optional[float],
           clear_burn: Optional[float], threshold: float,
           recover: float) -> bool:
    """Trip/clear one window latch with asymmetric evidence rules:

    - TRIPPING uses ``trip_burn`` (None below ``min_events`` — one
      failed op at boot is not an outage).
    - CLEARING uses ``clear_burn``, which is computable whenever the
      window itself is (zero events in the window = burn 0: once the
      window has rolled completely past the failure, holding the latch
      would deadlock a drained node — /healthz 503 → LB sends no
      traffic → no events → 503 forever).  ``None``
      (window not yet computable) keeps the previous state."""
    if active:
        if clear_burn is None:
            return True
        return clear_burn >= threshold * recover
    if trip_burn is None:
        return False
    return trip_burn >= threshold


def sustain_latch(since: Optional[float], now: float,
                  value: Optional[float], threshold: float,
                  recover: float) -> Optional[float]:
    """Timestamped form of :func:`_latch` for raw gauges — the shared
    sustain-window hysteresis rule (used by the reshard tick,
    opendht_tpu_torch/reshard.py, against ``dht_shard_imbalance``).

    ``since`` is the time the value first exceeded ``threshold`` (None
    = not latched).  Tripping needs ``value > threshold``; once
    latched, clearing needs the value to fall below
    ``threshold·recover`` — inside the hysteresis band the latch (and
    its start time) holds, so a value oscillating around the threshold
    accumulates ONE sustain window instead of restarting the clock at
    every dip.  An unknown value keeps the previous state (same rule
    as the SLO latch: no evidence is not recovery)."""
    if value is None:
        return since
    if since is not None:
        return None if value < threshold * recover else since
    return now if value > threshold else None


class HealthEvaluator:
    """The registry-reading verdict machine (see module docstring).

    Pure host-side: every tick snapshots cumulative series, computes
    windowed burn rates and signal levels, rolls the verdict, exports
    ``dht_health_*`` / ``dht_slo_*`` gauges and emits the two flight
    events on transitions.  ``providers`` maps extra signal names to
    zero-arg callables returning the signal value (None = unknown);
    the two registry-derived signals (scheduler tick lag, request
    timeout ratio) are built in."""

    def __init__(self, cfg: Optional[HealthConfig] = None, *,
                 registry: Optional[telemetry.MetricsRegistry] = None,
                 tracer: Optional[tracing.Tracer] = None,
                 clock: Callable[[], float] = _time.monotonic,
                 node: str = "",
                 providers: Optional[Dict[str, Callable]] = None,
                 history=None):
        self.cfg = cfg or HealthConfig()
        self.reg = registry or telemetry.get_registry()
        self.tracer = tracer or tracing.get_tracer()
        self.clock = clock
        self.node = node
        #: flight data recorder (opendht_tpu_torch/history.py).
        #: When attached, EVERY windowed delta — SLO windows, the
        #: scheduler-lag p95, the timeout ratio — reads through its
        #: retained frames instead of this evaluator's private
        #: ``_Window`` prior-snapshot state: ONE delta codepath (the
        #: ``quantile_from_buckets`` consolidation move,
        #: applied to the windowing layer), and the evidence the
        #: verdict was derived from survives in the ring for the
        #: post-mortem bundle.  The recorder must share this
        #: evaluator's clock (runtime/runner.py passes the scheduler
        #: clock to both).
        self.history = history
        #: optional hook fired AFTER a verdict transition is recorded:
        #: ``on_transition(prev, new, report)`` — runtime/runner.py
        #: captures the black-box bundle here.  Exceptions
        #: are swallowed: a broken bundle hook must not kill the tick.
        self.on_transition: Optional[Callable] = None
        # node-keyed export labels: co-resident nodes share the process
        # registry (semantics), so an unlabeled verdict gauge
        # would be last-writer-wins across nodes; standalone evaluators
        # (node="") stay unlabeled
        self._labels = {"node": node} if node else {}
        self.providers = dict(providers or {})
        keep = self.cfg.slow_window * 1.25
        self._slos = [_SloState(o, keep) for o in self.cfg.slos]
        self._lag_win = _Window(keep)
        self._timeout_win = _Window(keep)
        self._signal_levels: Dict[str, str] = {}
        self._verdict = "unknown"
        self._since = self.clock()
        self._report: dict = {"verdict": "unknown", "since": self._since,
                              "signals": {}, "slo": {}, "unknown": []}

    # ----------------------------------------------------------- sampling
    def _slo_sample(self, st: _SloState) -> tuple:
        """Current cumulative (total, bad[, buckets]) of one objective.
        Read through the non-mutating :meth:`~telemetry.MetricsRegistry
        .series` accessor — the get-or-create factories would register
        permanently-zero series for ops that never ran, polluting every
        later ``/stats`` scrape."""
        o = st.obj
        if o.kind == "availability":
            ok = bad = 0.0
            for key, m in self.reg.series("dht_ops_total").items():
                labels = dict(key)
                if labels.get("op") != o.op:
                    continue
                if labels.get("ok") == "false":
                    bad += m.value
                else:
                    ok += m.value
            return (ok + bad, bad)
        for key, m in self.reg.series("dht_op_seconds").items():
            if dict(key).get("op") == o.op:
                count, _total, buckets = m.raw()
                return (count, buckets)
        return (0, {})

    def _slo_window(self, st: _SloState, now: float,
                    window: float) -> Optional[tuple]:
        """Windowed ``(total, bad)`` of one objective; None before two
        snapshots exist (the window itself is not computable yet)."""
        d = st.win.delta(now, window)
        if d is None:
            return None
        base, cur, _span = d
        if st.obj.kind == "availability":
            return max(cur[0] - base[0], 0.0), max(cur[1] - base[1], 0.0)
        dtotal = max(cur[0] - base[0], 0.0)
        dbuckets = _sub_buckets(cur[1], base[1])
        return dtotal, _count_over(dbuckets, st.obj.threshold_s)

    def _slo_window_hist(self, st: _SloState, now: float,
                         window: float) -> Optional[tuple]:
        """Windowed ``(total, bad)`` read through the attached history
        recorder's frames — same None-before-coverage
        contract as :meth:`_slo_window`.  Series names are the exact
        Prometheus forms the recorder keys frames by (labels sorted,
        telemetry._series_name)."""
        o = st.obj
        t0 = now - window
        if o.kind == "availability":
            ok = self.history.counter_delta(
                'dht_ops_total{ok="true",op="%s"}' % o.op, t0, now)
            if ok is None:        # no frame covers the window yet
                return None
            bad = self.history.counter_delta(
                'dht_ops_total{ok="false",op="%s"}' % o.op, t0, now) or 0.0
            return ok + bad, bad
        d = self.history.hist_delta('dht_op_seconds{op="%s"}' % o.op,
                                    t0, now)
        if d is None:
            return None
        count, _sum, buckets = d
        return count, _count_over(buckets, o.threshold_s)

    def _eval_slo(self, st: _SloState, now: float) -> None:
        cfg = self.cfg
        if self.history is None:
            st.win.push(now, self._slo_sample(st))
        budget = max(1.0 - st.obj.objective, 1e-9)
        burns = {}
        clears = {}
        any_data = False
        for wname, wlen in (("fast", cfg.fast_window),
                            ("slow", cfg.slow_window)):
            w = (self._slo_window_hist(st, now, wlen)
                 if self.history is not None
                 else self._slo_window(st, now, wlen))
            total, bad = w if w is not None else (0.0, 0.0)
            if w is not None and total >= cfg.min_events:
                any_data = True
                burns[wname] = {"events": total, "bad": bad,
                                "rate": bad / total,
                                "burn": (bad / total) / budget}
            else:
                burns[wname] = {"events": total, "bad": bad,
                                "rate": None, "burn": None}
            # clearing evidence: computable whenever the window is —
            # an empty window means the failure rolled out (burn 0)
            clears[wname] = (None if w is None else
                             ((bad / total) / budget if total else 0.0))
        st.fast_active = _latch(st.fast_active, burns["fast"]["burn"],
                                clears["fast"], cfg.fast_burn,
                                cfg.recover_ratio)
        st.slow_active = _latch(st.slow_active, burns["slow"]["burn"],
                                clears["slow"], cfg.slow_burn,
                                cfg.recover_ratio)
        prev = st.level
        st.level = (UNHEALTHY if st.fast_active
                    else DEGRADED if st.slow_active else HEALTHY)
        st.detail = {
            "kind": st.obj.kind, "op": st.obj.op,
            "objective": st.obj.objective,
            "threshold_s": (st.obj.threshold_s
                            if st.obj.kind == "latency" else None),
            "level": st.level, "unknown": not any_data,
            "fast": burns["fast"], "slow": burns["slow"],
        }
        for wname in ("fast", "slow"):
            b = burns[wname]["burn"]
            self.reg.gauge("dht_slo_burn_rate", objective=st.obj.name,
                           window=wname, **self._labels).set(
                -1.0 if b is None else b)
        self.reg.gauge("dht_slo_violation", objective=st.obj.name,
                       **self._labels).set(_RANK[st.level])
        if _RANK[st.level] > _RANK.get(prev, 0) and self.tracer.enabled:
            self.tracer.event(
                "slo_violation", node=self.node, objective=st.obj.name,
                level=st.level, op=st.obj.op,
                fast_burn=burns["fast"]["burn"],
                slow_burn=burns["slow"]["burn"])

    # ------------------------------------------------------------ signals
    def _builtin_signals(self, now: float) -> Dict[str, Optional[float]]:
        cfg = self.cfg
        out: Dict[str, Optional[float]] = {}
        if self.history is not None:
            # the same two windowed signals, read through the
            # recorder's frames (family-prefix matching folds the
            # type-labeled request series exactly like the series()
            # sums below) — no private window state
            t0 = now - cfg.fast_window
            out["scheduler_lag"] = self.history.quantile(
                "dht_scheduler_tick_lag_seconds", 0.95, t0, now)
            dsent = self.history.counter_delta(
                "dht_net_requests_sent_total", t0, now)
            dexp = self.history.counter_delta(
                "dht_net_requests_expired_total", t0, now)
            ratio = None
            if dsent is not None and dsent >= cfg.min_events:
                ratio = max(dexp or 0.0, 0.0) / dsent
            out["timeout_ratio"] = ratio
            return out
        # scheduler tick lag: windowed p95 of the histogram
        count, _s, buckets = self.reg.histogram(
            "dht_scheduler_tick_lag_seconds").raw()
        self._lag_win.push(now, (count, buckets))
        d = self._lag_win.delta(now, cfg.fast_window)
        lag = None
        if d is not None:
            lag = _delta_quantile(_sub_buckets(d[1][1], d[0][1]), 0.95)
        out["scheduler_lag"] = lag
        # request timeout ratio: expired / sent deltas over every type
        sent = sum(m.value for m in
                   self.reg.series("dht_net_requests_sent_total").values())
        expired = sum(m.value for m in self.reg.series(
            "dht_net_requests_expired_total").values())
        self._timeout_win.push(now, (sent, expired))
        d = self._timeout_win.delta(now, cfg.fast_window)
        ratio = None
        if d is not None:
            dsent = d[1][0] - d[0][0]
            if dsent >= cfg.min_events:
                ratio = max(d[1][1] - d[0][1], 0.0) / dsent
        out["timeout_ratio"] = ratio
        return out

    def _eval_signals(self, now: float) -> Dict[str, dict]:
        cfg = self.cfg
        values = self._builtin_signals(now)
        for name, fn in self.providers.items():
            try:
                values[name] = fn()
            except Exception:
                log.exception("health signal provider %r failed", name)
                values[name] = None
        out: Dict[str, dict] = {}
        for name, value in values.items():
            deg, unh = cfg.signal_thresholds.get(name, (0.5, 0.9))
            prev = self._signal_levels.get(name, HEALTHY)
            if value is None:
                level = prev       # no data neither trips nor clears
                unknown = True
            else:
                unknown = False
                # hysteresis on the same recover_ratio as the SLOs
                d_thr = deg * (cfg.recover_ratio
                               if _RANK.get(prev, 0) >= 1 else 1.0)
                u_thr = unh * (cfg.recover_ratio
                               if _RANK.get(prev, 0) >= 2 else 1.0)
                level = (UNHEALTHY if value >= u_thr
                         else DEGRADED if value >= d_thr else HEALTHY)
                if level == UNHEALTHY and name in cfg.degrade_only:
                    level = DEGRADED
            self._signal_levels[name] = level
            out[name] = {"level": level, "value": value,
                         "unknown": unknown,
                         "degraded": deg, "unhealthy": unh}
            # the gauge reports the RETAINED level while the source is
            # unknown (an alert on >= degraded must not clear mid-
            # incident just because the signal went dark); -1 only
            # when unknown AND healthy
            self.reg.gauge("dht_health_signal", signal=name,
                           **self._labels).set(
                -1.0 if value is None and level == HEALTHY
                else _RANK[level])
        return out

    # --------------------------------------------------------------- tick
    def tick(self, now: Optional[float] = None) -> dict:
        """One evaluation pass; returns (and retains) the report dict."""
        now = self.clock() if now is None else now
        for st in self._slos:
            self._eval_slo(st, now)
        signals = self._eval_signals(now)
        worst = HEALTHY
        causes: List[str] = []
        for name, sig in signals.items():
            if _RANK[sig["level"]] > _RANK[worst]:
                worst, causes = sig["level"], [name]
            elif sig["level"] == worst and _RANK[worst] > 0:
                causes.append(name)
        for st in self._slos:
            if _RANK[st.level] > _RANK[worst]:
                worst, causes = st.level, [st.obj.name]
            elif st.level == worst and _RANK[worst] > 0:
                causes.append(st.obj.name)
        unknown = sorted(
            [n for n, s in signals.items() if s["unknown"]]
            + [st.obj.name for st in self._slos
               if st.detail.get("unknown")])
        prev_verdict = self._verdict
        if worst != self._verdict:
            self._verdict = worst
            self._since = now
            if self.tracer.enabled:
                self.tracer.event("health_transition", node=self.node,
                                  **{"from": prev_verdict, "to": worst,
                                     "causes": sorted(set(causes))})
        self.reg.gauge("dht_health_status", **self._labels).set(
            _RANK[worst])
        report = {
            "verdict": worst,
            "since": self._since,
            "time": now,
            "causes": sorted(set(causes)),
            "signals": signals,
            "slo": {st.obj.name: st.detail for st in self._slos},
            "unknown": unknown,
        }
        self._report = report
        if worst != prev_verdict and self.on_transition is not None:
            try:
                self.on_transition(prev_verdict, worst, report)
            except Exception:
                log.exception("health on_transition hook failed")
        return report

    def report(self) -> dict:
        """The last tick's report (atomic reference swap: safe to read
        from proxy handler threads while the DHT thread ticks)."""
        return self._report

    @property
    def verdict(self) -> str:
        return self._verdict


# ============================================================ node glue
_STATUS_VALUE = {"CONNECTED": 0.0, "CONNECTING": 1.0, "DISCONNECTED": 2.0}


class NodeHealth:
    """Per-node glue: derives the node-level signals from a live
    :class:`~opendht_tpu_torch.runtime.dht.Dht` and runs the evaluator on a
    periodic scheduler tick (``runtime/runner.py`` constructs and
    attaches one per node when ``Config.health.period > 0``)."""

    def __init__(self, dht, cfg: Optional[HealthConfig] = None,
                 node: str = "", history=None):
        self._dht = dht
        self._node_id = str(getattr(dht, "myid", "") or "")
        self.cfg = cfg or HealthConfig()
        self.evaluator = HealthEvaluator(
            self.cfg, clock=dht.scheduler.time, node=node,
            history=history,
            providers={
                "connectivity": self._connectivity,
                "ingest_queue": self._ingest_queue,
                "stale_buckets": self._stale_buckets,
                "shard_imbalance": self._shard_imbalance,
                "cache_hit_ratio": self._cache_hit_ratio,
                "stage_budget": self._stage_budget,
                "pipeline_occupancy": self._pipeline_occupancy,
                "peer_flap": self._peer_flap,
            })
        self._job = None

    # ------------------------------------------------------------ signals
    def _connectivity(self) -> float:
        return _STATUS_VALUE.get(self._dht.get_status().name, 2.0)

    def _ingest_queue(self) -> float:
        wb = self._dht.wave_builder
        if not wb.enabled:
            return 0.0           # no admission queue to saturate
        if wb.queue_max <= 0:
            # a zero bound sheds EVERY new op (WaveBuilder.admit:
            # len(pending) >= 0) — the most-saturated state, not the
            # least (this read 0.0 = healthiest)
            return 1.0
        return wb.pending() / wb.queue_max

    #: a family's stale fraction only counts when its table has at
    #: least this many occupied buckets — below it (small / freshly
    #: bootstrapped clusters) one never-replied peer swings the
    #: fraction 0→1 and a "stale" verdict would be pure noise (a
    #: 100k-node swarm sits at ~17+ occupied buckets)
    STALE_MIN_OCCUPIED = 8

    def _stale_buckets(self) -> Optional[float]:
        """Max per-family stale-bucket fraction of THIS node, read off
        the node-keyed gauges the maintenance sweep publishes
        (no extra device launch on the health tick — the sweep already
        ran; the node label keeps co-resident nodes from reading each
        other's sweeps).  Families whose occupancy is below
        :data:`STALE_MIN_OCCUPIED` are skipped; with no qualifying
        family the signal is unknown."""
        reg = telemetry.get_registry()
        fractions = reg.series("dht_maintenance_stale_fraction")
        occupied = reg.series("dht_maintenance_occupied_buckets")
        vals = [m.value for key, m in fractions.items()
                if dict(key).get("node") == self._node_id
                and occupied.get(key) is not None
                and occupied[key].value >= self.STALE_MIN_OCCUPIED]
        return max(vals) if vals else None

    def _shard_imbalance(self) -> Optional[float]:
        """Max/mean per-shard keyspace traffic from the keyspace
        observatory (not ported: reads as absent) — already folded over
        the live t-sharded row boundaries (or the uniform virtual
        split) on the observatory's own tick, so this is one attribute
        read.  None (unknown) while the window holds fewer than
        ``min_observed`` ids — a quiet node is not imbalanced."""
        ks = getattr(self._dht, "keyspace", None)
        return ks.imbalance() if ks is not None else None

    def _cache_hit_ratio(self) -> Optional[float]:
        """Windowed MISS fraction of the hot-key serving
        cache (``1 − hotcache.hit_ratio()``) — the engine's thresholds
        compare "bigger is worse", so the signal value is the miss
        side of the ratio the ``dht_cache_hit_ratio`` gauge and
        ``dhtmon --min-cache-hit`` report.  None (unknown, never
        trips) while the cache is disabled/dark or saw no eligible
        probes in the last observatory window — a quiet cache is not a
        cold one.  Degrade-only in the verdict
        (:class:`HealthConfig`.degrade_only)."""
        hc = getattr(self._dht, "hotcache", None)
        if hc is None:
            return None
        ratio = hc.hit_ratio()
        return None if ratio is None else 1.0 - ratio

    def _stage_budget(self) -> Optional[float]:
        """Worst-stage p95/budget ratio from the latency
        waterfall over the window since the last health tick (the
        profiler diffs its stage histograms against the previous call's
        baselines, so the tick cadence IS the window).  None (unknown,
        never trips) while no stage accrued enough new samples — a
        quiet node has no slow stages.  Degrade-only in the verdict
        (:class:`HealthConfig`.degrade_only)."""
        from . import waterfall
        return waterfall.get_profiler().stage_budget()

    def _pipeline_occupancy(self) -> Optional[float]:
        """Occupancy collapse from the pipeline observatory:
        windowed fraction of wall clock lost to STARVED device-idle
        bubbles (the tick cadence IS the window, stage_budget-style).
        Healthy idleness — queue_empty, cache_served — never counts,
        so an idle node stays healthy and a flooded-but-starved one
        degrades.  None (unknown, never trips) while the observatory
        is off or the window saw no pipeline activity.  Degrade-only
        in the verdict (:class:`HealthConfig`.degrade_only), with the
        engine's standard hysteresis on recovery."""
        wb = getattr(self._dht, "wave_builder", None)
        obs = getattr(wb, "observatory", None)
        if obs is None or not obs.enabled:
            return None
        return obs.collapse()

    def _peer_flap(self) -> Optional[float]:
        """Worst single-link fail ratio from the per-peer
        ledger (opendht_tpu_torch/peers.py): expired / finished requests of
        the worst peer with at least ``Config.peers.min_signal_events``
        requests — the per-link view next to the cluster-wide
        ``timeout_ratio``.  None (unknown, never trips) while the
        ledger is off or no peer has enough traffic to judge.
        Degrade-only in the verdict
        (:class:`HealthConfig`.degrade_only)."""
        led = getattr(self._dht, "peers", None)
        if led is None or not getattr(led, "enabled", False):
            return None
        return led.fail_signal()

    # --------------------------------------------------------------- tick
    def attach(self, scheduler) -> None:
        """Schedule the periodic evaluation on the node scheduler."""
        if self.cfg.period <= 0 or self._job is not None:
            return
        # _sched must exist before the job can possibly fire: attach on
        # a LIVE node races _tick_job's reschedule otherwise
        self._sched = scheduler
        self._job = scheduler.add(scheduler.time() + self.cfg.period,
                                  self._tick_job)

    def _tick_job(self) -> None:
        try:
            self.tick()
        finally:
            self._job = self._sched.add(
                self._sched.time() + self.cfg.period, self._tick_job)

    def tick(self) -> dict:
        return self.evaluator.tick()

    def report(self) -> dict:
        return self.evaluator.report()
