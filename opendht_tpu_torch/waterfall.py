"""Per-op latency waterfall: the always-on stage profiler.

A copy of the JAX package's ``waterfall.py`` with its behaviour
unchanged, except that the OPEN-bound tracker (``OpenBoundTracker``) is
left out: it compares live numbers against the accelerator bounds of the
JAX package's ``perf_budgets.json``, which were set for a TPU, and only
the runner (not ported yet) attaches it.  The text below is the
original's, less that tracker.

Observability used to report one opaque number per op — a host
wall-clock around ``block_until_ready`` (``dht_op_seconds``).  This
module decomposes where those milliseconds actually go, continuously
and at <1% overhead (captures/waterfall_overhead.json), the
Google-Wide-Profiling posture: a Dapper-style trace says *which* op was
slow, the always-on stage profiler says *why*.

**Stages** (one labeled histogram family, ``dht_stage_seconds{stage=}``):

- ``queue_wait`` — admission → wave pickup, off the enqueue
  stamp (``_Entry.t_wall``); the continuous-batching coalesce tax.
- ``cache_probe`` — the hot-cache XOR-compare launch + serve
  window at the head of every wave.
- ``device_compile`` — the FIRST timed launch per (family, k) group
  shape: XLA compilation rides that call, and folding it into the
  serving device stage would poison the p99 forever.  Split host-side
  by first-launch tracking — the kernels themselves are untouched.
- ``dispatch`` — the host-side async-dispatch cost of a wave, measured
  AT LAUNCH (the ``find_closest_nodes_launch`` call itself).
- ``device_wait`` — the blocking wait actually paid when results are
  used (``BatchedResolve.consume``), measured AT CONSUME.  For
  ``ingest_pipeline_depth=1`` this collapses to the old timed
  launch→block span of ``find_closest_nodes_batched``; at depth 2+ the
  wave's host-overlap window (launch → drain pump) is deliberately NOT
  device cost — it shows as the ``dht.search.wave`` span's wall
  duration, the ``dht_ingest_pipeline_inflight`` gauge (+ windowed
  ``_peak``) and the pipeline observatory's device
  lane (``pipeline_observatory.py``).  ``device_launch`` is a
  one-release alias of ``device_wait`` (:data:`STAGE_ALIASES`) so
  existing ``dhtmon --max-stage`` invocations keep matching.
- ``scatter_back`` — results materialized → each op's scatter callback
  returned (result fan-out + trace recording).
- ``rpc_wait`` — network hop RTTs off the per-hop spans
  (``net/request.py`` completion; overlaps the device stages, so it is
  excluded from the per-op sum pin below).

Hot buckets carry **exemplars**: each observation under a sampled trace
stamps its bucket with the op's trace id
(:meth:`~opendht_tpu.telemetry.Histogram.observe` ``exemplar=``), so a
p99 bucket links directly to a reconstructable trace via the
trace assembler (``testing/trace_assembler.assemble_trace``).

**Per-op records**: a bounded ring of ``{kind, trace_id, stages{...},
end_to_end}`` dicts, one per wave-carried op.  The decomposition's
contract — stage sum ≈ end-to-end wall-clock (admission → scatter
returned) within tolerance — is pinned in tests/test_waterfall.py; the
unattributed remainder is the wave-assembly glue (grouping loop, metric
writes), all host-side.

**SLIs**: :meth:`StageProfiler.stage_budget` derives a windowed
worst-stage p95/budget ratio feeding the health engine as the
degrade-only ``stage_budget`` signal (a slow stage is an efficiency
problem, not a liveness one).

Surfaces: proxy ``GET /profile`` (+ ``?fmt=folded`` flamegraph stacks),
the ``profile`` REPL cmd, a ``waterfall`` section in ``dhtscanner
--json``, ``dhtmon --max-stage STAGE=SEC``, and — because the history
recorder samples every registry family — stage frames ride the history
ring and appear in black-box bundles automatically.

Import-light (stdlib + telemetry/tracing spine only at module import);
the profiler is process-global like the registry it feeds
(:func:`get_profiler`), so per-node cardinality remains the embedder's
concern — same documented aggregation rule as telemetry.py.
"""

from __future__ import annotations

import threading
import time as _time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import telemetry

__all__ = [
    "STAGES", "STAGE_ALIASES", "DEFAULT_STAGE_BUDGETS", "WaterfallConfig",
    "StageProfiler", "get_profiler",
]

#: the waterfall stages, in serving-path order (rpc_wait overlaps the
#: device stages — it is a parallel plane, not a pipeline step).
#: The old overlapped ``device_launch`` stage is split into
#: ``dispatch`` (host-side async-dispatch cost, measured AT LAUNCH)
#: and ``device_wait`` (the blocking wait actually paid at consume) —
#: at depth >= 2 the two happen pumps apart, and folding them into one
#: stage made in-flight device time reappear as queue_wait.
STAGES = ("queue_wait", "cache_probe", "device_compile", "dispatch",
          "device_wait", "scatter_back", "rpc_wait")

#: one-release compatibility aliases: old stage name →
#: canonical stage.  ``observe("device_launch", ...)`` and ``dhtmon
#: --max-stage device_launch=...`` keep working against the
#: ``device_wait`` histogram; snapshots mirror the entry under both
#: keys with an ``alias_of`` marker.  Scheduled for removal next
#: release — switch invocations to ``device_wait``.
STAGE_ALIASES = {"device_launch": "device_wait"}

#: per-stage latency budgets (seconds) the ``stage_budget`` health
#: signal and ``dhtmon --max-stage`` default to: generous CPU-safe
#: ceilings — a stage sitting at its budget's p95 is *degraded*, at 2x
#: *unhealthy-grade* (but the signal is degrade-only in the verdict)
DEFAULT_STAGE_BUDGETS = {
    "queue_wait": 0.020,      # 10x the default ingest deadline knob
    "cache_probe": 0.050,
    "device_compile": 120.0,  # one-time XLA lowering, not a serving SLI
    "dispatch": 0.050,        # host async-dispatch share of a wave
    "device_wait": 0.250,
    "scatter_back": 0.050,
    "rpc_wait": 3.5,          # 3 attempts x 1 s + slack (request.py)
}

#: minimum new observations inside a budget window before the signal
#: reports (one slow wave at boot is not a trend)
_BUDGET_MIN_EVENTS = 4


@dataclass
class WaterfallConfig:
    """Knob surface (``runtime.config.Config.waterfall``)."""

    #: master switch: False stops stage observation and per-op records
    #: (results are identical either way — the profiler only observes)
    enabled: bool = True
    #: bounded per-op record ring (the sum≈end-to-end evidence)
    op_ring: int = 256
    #: per-stage budget overrides (seconds) merged over
    #: :data:`DEFAULT_STAGE_BUDGETS`
    budgets: dict = field(default_factory=dict)
    #: seconds between OPEN-bound tracker refreshes on the node
    #: scheduler; 0 disables the tracker tick
    open_bound_period: float = 5.0


class StageProfiler:
    """Always-on per-stage latency aggregator (see module docstring).

    One instance per process (:func:`get_profiler`); every hook is a
    cached-handle histogram observe — cheap enough for the per-RPC and
    per-wave hot paths."""

    def __init__(self, cfg: Optional[WaterfallConfig] = None,
                 reg: Optional[telemetry.MetricsRegistry] = None):
        self.cfg = cfg or WaterfallConfig()
        self._reg = reg or telemetry.get_registry()
        self.enabled = self.cfg.enabled
        self._h = {s: self._reg.histogram("dht_stage_seconds", stage=s)
                   for s in STAGES}
        # aliases map to the SAME Histogram object: an old-name observe
        # or a direct _h["device_launch"] access lands in the canonical
        # series — nothing double-counts, nothing goes dark
        for old, new in STAGE_ALIASES.items():
            self._h[old] = self._h[new]
        self._ops: deque = deque(maxlen=max(1, self.cfg.op_ring))
        self._compiled: set = set()       # (af, k) groups already launched
        self.budgets = dict(DEFAULT_STAGE_BUDGETS)
        self.budgets.update(self._resolve_budget_aliases(self.cfg.budgets))
        # budget-window baselines: stage -> (count, sum, {bucket: n})
        self._win_prev: Dict[str, tuple] = {}
        self._lock = threading.Lock()
        self._publish_budgets()

    @staticmethod
    def _resolve_budget_aliases(budgets: Optional[dict]) -> dict:
        """Config budget overrides keyed by an aliased stage name apply
        to the canonical stage (one-release compatibility)."""
        return {STAGE_ALIASES.get(k, k): v for k, v in (budgets or {}).items()}

    def _publish_budgets(self) -> None:
        """Stage budgets as ``dht_stage_budget_seconds{stage=}`` gauges
        on the profiler's registry, so every scrape carries the
        thresholds next to the achieved ``dht_stage_seconds``
        distributions (a dashboard plots p95 vs budget without repo
        access)."""
        for stage, sec in self.budgets.items():
            self._reg.gauge("dht_stage_budget_seconds", stage=stage).set(sec)

    def configure(self, cfg: WaterfallConfig) -> None:
        """Re-apply a node's config to the process-global profiler
        (the documented aggregation rule: last node wins, like the
        shared registry)."""
        self.cfg = cfg
        self.enabled = cfg.enabled
        self.budgets = dict(DEFAULT_STAGE_BUDGETS)
        self.budgets.update(self._resolve_budget_aliases(cfg.budgets))
        if self._ops.maxlen != max(1, cfg.op_ring):
            self._ops = deque(self._ops, maxlen=max(1, cfg.op_ring))
        self._publish_budgets()

    # ------------------------------------------------------------ observes
    def observe(self, stage: str, seconds: float,
                exemplar: Optional[str] = None) -> None:
        """One stage sample; ``exemplar`` is the op's 32-hex trace id
        (stamped on the landing bucket so a hot bucket links to a
        reconstructable trace)."""
        if not self.enabled:
            return
        self._h[stage].observe(seconds, exemplar=exemplar)

    def first_launch(self, key) -> bool:
        """True exactly once per launch-group shape ``key`` — the
        compile-vs-execute split: the first timed launch of a group
        carries XLA lowering and lands in ``device_compile``."""
        if key in self._compiled:
            return False
        with self._lock:
            if key in self._compiled:
                return False
            self._compiled.add(key)
            return True

    def record_op(self, kind: str, stages: Dict[str, float],
                  end_to_end: float,
                  trace_id: Optional[str] = None) -> None:
        """Append one per-op decomposition record to the bounded ring."""
        if not self.enabled:
            return
        self._ops.append({
            "kind": kind,
            "trace_id": trace_id,
            "stages": stages,
            "end_to_end": end_to_end,
            "t": _time.time(),
        })

    def ops(self) -> List[dict]:
        return list(self._ops)

    # ---------------------------------------------------------------- SLIs
    def stage_budget(self) -> Optional[float]:
        """Windowed worst-stage p95/budget ratio — the degrade-only
        ``stage_budget`` health signal's value.  Each call diffs the
        stage histograms against the previous call's baselines (the
        health tick cadence IS the window), so the signal tracks
        current behavior, not boot history.  None (unknown) when no
        stage accrued :data:`_BUDGET_MIN_EVENTS` new samples —
        ``device_compile`` is excluded (one-time cost, budgeted but
        not a serving trend)."""
        worst = None
        with self._lock:
            for stage in STAGES:
                if stage == "device_compile":
                    continue
                cur = self._h[stage].raw()
                prev = self._win_prev.get(stage, (0, 0.0, {}))
                self._win_prev[stage] = cur
                dcount = cur[0] - prev[0]
                if dcount < _BUDGET_MIN_EVENTS:
                    continue
                db = {i: c - prev[2].get(i, 0)
                      for i, c in cur[2].items()
                      if c - prev[2].get(i, 0) > 0}
                p95 = telemetry.quantile_from_buckets(
                    sorted(db.items()), dcount, 0.95)
                ratio = p95 / self.budgets[stage]
                if worst is None or ratio > worst:
                    worst = ratio
        return worst

    # -------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """JSON-able waterfall: per-stage count/sum/p50/p95/p99 with
        bucket exemplars, the budgets, and the recent per-op records —
        what ``GET /profile``, the REPL ``profile`` cmd and the
        scanner's ``waterfall`` section all serve."""
        stages = {}
        for s in STAGES:
            h = self._h[s]
            d = h.to_dict()
            d["p50"] = h.quantile(0.50)
            d["p95"] = h.quantile(0.95)
            d["p99"] = h.quantile(0.99)
            stages[s] = d
        # one-release alias mirror: readers keyed on the old name see
        # the canonical stage's data, marked so they can migrate
        for old, new in STAGE_ALIASES.items():
            stages[old] = dict(stages[new], alias_of=new)
        return {
            "enabled": self.enabled,
            "stages": stages,
            "budgets": dict(self.budgets),
            "ops": self.ops(),
        }

    def folded(self) -> str:
        """Flamegraph-shaped folded stacks (``stack weight`` lines,
        weight = cumulative stage microseconds): feed straight into
        ``flamegraph.pl`` / speedscope.  The op root frame carries the
        end-to-end sums so the stage children visually subdivide it."""
        lines = []
        for s in STAGES:
            h = self._h[s]
            us = int(h.sum * 1e6)
            if us > 0:
                lines.append("dht;op;%s %d" % (s, us))
        return "\n".join(lines) + ("\n" if lines else "")


_global_profiler: Optional[StageProfiler] = None
_profiler_lock = threading.Lock()


def get_profiler() -> StageProfiler:
    """The process-global stage profiler every layer feeds by default
    (the waterfall analogue of ``telemetry.get_registry``)."""
    global _global_profiler
    if _global_profiler is None:
        with _profiler_lock:
            if _global_profiler is None:
                _global_profiler = StageProfiler()
    return _global_profiler
