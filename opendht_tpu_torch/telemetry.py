"""Unified telemetry: one metrics spine from kernel rounds to the proxy.

A copy of the JAX package's ``telemetry.py`` with its behaviour
unchanged, except that spans annotate the PyTorch profiler
(``torch.profiler.record_function``) instead of JAX's, so a
``torch.profiler`` trace of the card shows each span.  The text below is
the original's.

The repo's perf story used to live in three disconnected islands —
``net/engine.py MessageStats``, ``proxy/server.py ServerStats`` and
``runtime/dht.py get_nodes_stats`` — plus one-off ``benchmarks/exp_*``
scripts for anything kernel-side.  This module is the shared spine they
all feed (↔ the reference exposing ``Dht::getNodesStats`` and the proxy
``STATS /`` route as a product surface, dht_proxy_server.cpp:206-232):

- :class:`MetricsRegistry` — zero-dependency counters, gauges and
  log-bucketed histograms, labeled by name + sorted ``(key, value)``
  tuples.  One process-global default instance (:func:`get_registry`)
  aggregates every component; a multi-node test process sums its nodes
  into the same series (documented, deliberate — per-node cardinality
  is the embedder's concern, label if you need the split).
- :meth:`MetricsRegistry.span` — a host-side ``perf_counter`` timer
  that also enters a ``jax.profiler.TraceAnnotation`` of the SAME name,
  so device traces (``jax.profiler.trace``) align with the host spans
  that wrap ``block_until_ready``.  Instrumentation stays off the
  kernel trace: spans time *around* compiled calls, never inside them,
  so kernels remain bit-identical with telemetry enabled.
- Export: :meth:`snapshot` (JSON-able dict — ``DhtRunner.get_metrics``),
  :meth:`prometheus` (text exposition v0.0.4 — the proxy ``GET /stats``
  route), and the ``stats`` REPL command in tools/dhtnode.py.

Everything is cheap enough to leave on by default (one dict lookup +
a few float ops per event; hot callers cache the metric handles).  Flip
``get_registry().enabled = False`` to skip span timing/blocking in
latency-critical embeddings; recorded kernels and results are identical
either way (captures/telemetry_overhead.json quantifies the on-cost).

Import-light by design: stdlib only at module import (the jax profiler
is looked up lazily inside :meth:`span`), so the scheduler/net layers
keep working in minimal containers without the jax wheel.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Span",
    "get_registry", "quantile_from_buckets", "snapshot_diff",
]

# histogram buckets are powers of two: bucket i covers
# (2^(i-1-_H_OFFSET), 2^(i-_H_OFFSET)]; index 0 is the catch-all for
# v <= 2^-_H_OFFSET (~1 ns for seconds-valued series), the last for
# anything above 2^(_H_SPAN-_H_OFFSET).  One scheme for every series —
# seconds, wave widths, hop counts — keeps quantile math and the
# exposition identical everywhere.
_H_OFFSET = 30
_H_SPAN = 94                  # up to 2^64


def _bucket_index(v: float) -> int:
    if not v > 0.0:
        return 0
    e = math.frexp(v)[1]      # v in (2^(e-1), 2^e]  (frexp: m in [0.5, 1))
    if math.ldexp(1.0, e - 1) == v:
        e -= 1                # exact power of two sits in the lower bucket
    return min(max(e + _H_OFFSET, 0), _H_SPAN - 1)


def _bucket_le(i: int) -> float:
    return math.ldexp(1.0, i - _H_OFFSET)


def quantile_from_buckets(items, total: int, q: float) -> float:
    """Linear-interpolated quantile over sorted ``(bucket_index,
    count)`` pairs of the log-bucket scheme — the ONE copy of the
    interpolation used by :meth:`Histogram.quantile` and the windowed
    bucket-delta readers in opendht_tpu/health.py (keeping the two
    from diverging).  0.0 when ``total`` is zero."""
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0
    for i, c in items:
        if cum + c >= target:
            lo = 0.0 if i == 0 else _bucket_le(i - 1)
            hi = _bucket_le(i)
            frac = (target - cum) / c if c else 1.0
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += c
    return _bucket_le(items[-1][0])


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (queue depths, table health)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Log-bucketed (base-2) distribution: count, sum, sparse buckets.

    The power-of-two scheme gives ~±50% bucket resolution over the full
    dynamic range from nanoseconds to hours with at most ``_H_SPAN``
    buckets and no per-metric configuration — quantiles interpolate
    linearly inside the landing bucket, which is accurate enough for
    p50/p95 alerting (testing/network_monitor.py) and far cheaper than
    exact reservoirs on the per-packet hot paths."""

    __slots__ = ("count", "sum", "buckets", "exemplars", "_lock")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.buckets: Dict[int, int] = {}
        # per-bucket latest exemplar: bucket -> (value,
        # trace id) — a hot bucket links to a reconstructable trace
        # through the assembler.  JSON/snapshot side only; the
        # prometheus() v0.0.4 text has no exemplar syntax and stays
        # byte-compatible with pre-exemplar scrapers.
        self.exemplars: Dict[int, tuple] = {}
        self._lock = threading.Lock()

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        v = float(v)
        i = _bucket_index(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.buckets[i] = self.buckets.get(i, 0) + 1
            if exemplar is not None:
                self.exemplars[i] = (v, exemplar)

    def observe_many(self, values: Iterable[float]) -> None:
        """Bulk insert (one lock, numpy-bucketed when available) — used
        for per-query series like hop counts at wave widths of 10^5+."""
        try:
            import numpy as np
            v = np.asarray(list(values) if not hasattr(values, "__len__")
                           else values, dtype=np.float64).ravel()
        except Exception:
            for x in values:
                self.observe(x)
            return
        if v.size == 0:
            return
        pos = v > 0.0
        e = np.zeros(v.shape, dtype=np.int64)
        if pos.any():
            ex = np.frexp(v[pos])[1].astype(np.int64)
            # exact powers of two belong to the lower bucket
            ex -= (np.ldexp(1.0, ex - 1) == v[pos])
            e[pos] = ex
        idx = np.where(pos, np.clip(e + _H_OFFSET, 0, _H_SPAN - 1), 0)
        counts = np.bincount(idx, minlength=_H_SPAN)
        nz = np.nonzero(counts)[0]
        with self._lock:
            self.count += int(v.size)
            self.sum += float(v.sum())
            for i in nz:
                i = int(i)
                self.buckets[i] = self.buckets.get(i, 0) + int(counts[i])

    def quantile(self, q: float) -> float:
        """Approximate quantile by linear interpolation inside the
        landing bucket; 0.0 when empty."""
        with self._lock:
            total = self.count
            items = sorted(self.buckets.items())
        return quantile_from_buckets(items, total, q)

    def raw(self) -> tuple:
        """Consistent ``(count, sum, {bucket_index: count})`` snapshot —
        the windowed readers (opendht_tpu/health.py) diff two of these
        to get a bucket-exact view of one time window without any new
        instrumentation on the observing side."""
        with self._lock:
            return self.count, self.sum, dict(self.buckets)

    def to_dict(self) -> dict:
        with self._lock:
            items = sorted(self.buckets.items())
            count, total = self.count, self.sum
            ex = sorted(self.exemplars.items())
        out = {
            "count": count,
            "sum": total,
            "buckets": [[_bucket_le(i), c] for i, c in items],
        }
        if ex:
            # [upper bound, exemplar value, trace id] — absent (not
            # empty) when no exemplar was ever stamped, so existing
            # dict-shape consumers see no new key until they opt in
            out["exemplars"] = [[_bucket_le(i), v, t] for i, (v, t) in ex]
        return out


class Span:
    """Result handle of :meth:`MetricsRegistry.span`: ``elapsed`` holds
    the wall seconds once the ``with`` block exits."""

    __slots__ = ("elapsed",)

    def __init__(self):
        self.elapsed = 0.0


class _SpanCtx:
    __slots__ = ("_hist", "_name", "_ann", "_t0", "_span")

    def __init__(self, hist: Optional[Histogram], name: str):
        self._hist = hist
        self._name = name
        self._ann = None
        self._span = Span()

    def __enter__(self) -> Span:
        ann_cls = _trace_annotation()
        if ann_cls is not None:
            try:
                self._ann = ann_cls(self._name)
                self._ann.__enter__()
            except Exception:
                self._ann = None
        self._t0 = time.perf_counter()
        return self._span

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        if self._ann is not None:
            try:
                self._ann.__exit__(*exc)
            except Exception:
                pass
        self._span.elapsed = dt
        if self._hist is not None:
            self._hist.observe(dt)


_TRACE_ANNOTATION: "list | None" = None


def _trace_annotation():
    """torch.profiler.record_function, resolved once, None without torch
    (the JAX package resolves jax.profiler.TraceAnnotation here)."""
    global _TRACE_ANNOTATION
    if _TRACE_ANNOTATION is None:
        try:
            from torch.profiler import record_function
            _TRACE_ANNOTATION = [record_function]
        except ImportError:
            _TRACE_ANNOTATION = [None]
    return _TRACE_ANNOTATION[0]


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _series_name(name: str, labels: Tuple[Tuple[str, str], ...],
                 extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = list(labels) + ([extra] if extra else [])
    if not pairs:
        return name
    inner = ",".join('%s="%s"' % (k, _escape(v)) for k, v in pairs)
    return "%s{%s}" % (name, inner)


class MetricsRegistry:
    """Get-or-create metric store with JSON + Prometheus export."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (kind, {label_key -> metric})
        self._metrics: Dict[str, Tuple[str, dict]] = {}
        #: master switch for span *timing* (metrics stay writable; hot
        #: paths may consult it to skip blocking instrumentation)
        self.enabled = True

    # ------------------------------------------------------------- factories
    def _get(self, kind: str, name: str, labels: dict):
        key = _label_key(labels)
        with self._lock:
            ent = self._metrics.get(name)
            if ent is None:
                ent = (kind, {})
                self._metrics[name] = ent
            elif ent[0] != kind:
                raise ValueError(
                    "metric %r already registered as %s, requested %s"
                    % (name, ent[0], kind))
            m = ent[1].get(key)
            if m is None:
                m = ent[1][key] = self._KINDS[kind]()
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    def span(self, name: str, record: bool = True, **labels) -> _SpanCtx:
        """``with reg.span("dht_x_seconds") as s: ...`` — times the block
        with ``perf_counter`` (callers put ``block_until_ready`` inside),
        observes into histogram ``name`` and emits a matching
        ``jax.profiler.TraceAnnotation`` so device traces line up with
        the host span.  ``s.elapsed`` is readable after exit.  With the
        registry disabled — or ``record=False``, for callers that feed
        the elapsed time into their own series — the histogram write is
        skipped but the annotation still fires (profiles stay labeled)."""
        hist = (self.histogram(name, **labels)
                if self.enabled and record else None)
        return _SpanCtx(hist, name)

    def families(self) -> Dict[str, str]:
        """``{family_name: kind}`` of every registered metric family —
        the non-mutating enumeration the history recorder
        walks each tick (``snapshot()`` would compute quantiles for
        every histogram in the process; the recorder only needs names
        to feed :meth:`series`)."""
        with self._lock:
            return {n: kind for n, (kind, _d) in self._metrics.items()}

    def series(self, name: str) -> dict:
        """All label series of one metric family as ``{label_key:
        metric}`` (empty when the family was never written).  Lets a
        reader aggregate over labels — e.g. the health evaluator's
        timeout ratio sums every ``type=`` series — without the full
        :meth:`snapshot` (which computes quantiles for every
        histogram in the process)."""
        with self._lock:
            ent = self._metrics.get(name)
            return dict(ent[1]) if ent is not None else {}

    # --------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """JSON-able dump: ``{"counters": {...}, "gauges": {...},
        "histograms": {series: {count, sum, p50, p95, p99, buckets}}}``.
        Series keys use the Prometheus form ``name{k="v"}``."""
        with self._lock:
            metrics = {n: (k, dict(d)) for n, (k, d) in self._metrics.items()}
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(metrics):
            kind, series = metrics[name]
            for key in sorted(series):
                m = series[key]
                sname = _series_name(name, key)
                if kind == "counter":
                    out["counters"][sname] = m.value
                elif kind == "gauge":
                    out["gauges"][sname] = m.value
                else:
                    d = m.to_dict()
                    d["p50"] = m.quantile(0.50)
                    d["p95"] = m.quantile(0.95)
                    d["p99"] = m.quantile(0.99)
                    out["histograms"][sname] = d
        return out

    def prometheus(self) -> str:
        """Text exposition format v0.0.4 (one ``# TYPE`` line per
        family; histograms as cumulative ``_bucket``/``_sum``/``_count``
        with the standard ``le`` label)."""
        with self._lock:
            metrics = {n: (k, dict(d)) for n, (k, d) in self._metrics.items()}
        lines: List[str] = []
        for name in sorted(metrics):
            kind, series = metrics[name]
            lines.append("# TYPE %s %s" % (name, kind))
            for key in sorted(series):
                m = series[key]
                if kind == "histogram":
                    d = m.to_dict()
                    cum = 0
                    for le, c in d["buckets"]:
                        cum += c
                        lines.append("%s %d" % (_series_name(
                            name + "_bucket", key, ("le", _fmt(le))), cum))
                    lines.append("%s %d" % (_series_name(
                        name + "_bucket", key, ("le", "+Inf")), d["count"]))
                    lines.append("%s %s" % (
                        _series_name(name + "_sum", key), _fmt(d["sum"])))
                    lines.append("%s %d" % (
                        _series_name(name + "_count", key), d["count"]))
                else:
                    lines.append("%s %s" % (
                        _series_name(name, key), _fmt(float(m.value))))
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every metric IN PLACE (tests; not part of the serving
        surface).  Identity-preserving: hot paths cache metric handles
        (engine/scheduler per-instance, request.py/table.py module
        caches), so clearing the dict would orphan those writers —
        instead each existing object is zeroed and keeps reporting."""
        with self._lock:
            for _kind, series in self._metrics.values():
                for m in series.values():
                    if isinstance(m, Histogram):
                        with m._lock:
                            m.count = 0
                            m.sum = 0.0
                            m.buckets.clear()
                            m.exemplars.clear()
                    else:
                        m.value = 0


def snapshot_diff(before: dict, after: dict) -> dict:
    """Per-series delta of two :meth:`MetricsRegistry.snapshot` dicts
    (the overhead benchmarks and the tracing/telemetry
    tests all need "what advanced between these two points" — this
    replaces the hand-rolled registry subtraction).

    Returns the same ``{"counters", "gauges", "histograms"}`` shape:
    counters/gauges as value deltas (zero-delta series dropped),
    histograms as ``{"count": Δcount, "sum": Δsum}`` for series whose
    count moved.  Series present only in ``after`` diff against zero."""
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for kind in ("counters", "gauges"):
        b = before.get(kind, {})
        a = after.get(kind, {})
        for key in sorted(set(a) | set(b)):
            d = a.get(key, 0) - b.get(key, 0)
            if d:
                out[kind][key] = d
    bh = before.get("histograms", {})
    ah = after.get("histograms", {})
    for key in sorted(set(ah) | set(bh)):
        ad = ah.get(key, {})
        bd = bh.get(key, {})
        dc = ad.get("count", 0) - bd.get("count", 0)
        if dc:
            out["histograms"][key] = {
                "count": dc,
                "sum": ad.get("sum", 0.0) - bd.get("sum", 0.0),
            }
    return out


_global_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry every layer feeds by default."""
    return _global_registry
