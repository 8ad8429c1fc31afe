"""Distributed tracing + flight recorder.

A copy of the JAX package's ``tracing.py`` (stdlib only) with its
behaviour unchanged, environment variables included; the text below is
the original's.

The metrics spine (telemetry.py) answers "how fast is the system";
this module answers "why did THIS lookup take 150 ms".  Dapper-style (Sigelman et al.,
2010) request-scoped tracing over the multi-hop DHT pipeline:

- :class:`TraceContext` — (trace_id 128b, span_id 64b, flags) minted
  per operation; head-based sampling: the root decides, the flag rides
  the wire, children obey.
- :class:`Tracer` — records finished spans AND structured
  flight-recorder events into ONE bounded ring (``deque(maxlen=N)``,
  oldest evicted, O(1) append).  The ring is the TPU-native analogue of
  the reference's postmortem surfaces (``Dht::dumpTables`` /
  ``getNodesStats``, src/dht.cpp:1424-1444): every node keeps the last
  N request state transitions, timeouts, rate-limit drops, compactions
  and churn swaps, dumpable at any time (``trace``/``dump`` in
  tools/dhtnode.py, ``GET /trace`` on the proxy).
- Wire propagation: the context serializes as ONE optional top-level
  msgpack key (:data:`TRACE_WIRE_KEY`) on query packets —
  ``{"i": 16B trace id, "s": 8B parent span id, "f": flags}``.  Old
  parsers ignore unknown top-level keys (proven by
  tests/test_wire_fuzz.py + tools/compat_check.py), and
  :func:`decode_wire` is strictly bounded: any malformed or hostile
  oversized blob decodes to ``None``, never raises, never echoes.
- Export three ways: ``DhtRunner.get_trace(trace_id)`` (JSON span
  list), :func:`to_chrome_trace` (Chrome trace-event / Perfetto
  ``ph:"X"`` with pid=node, tid=op), and the cross-node assembler in
  testing/trace_assembler.py that reconstructs one lookup's full span
  tree from every cluster node's ring.

Host-side only, like the telemetry spine: spans wrap the SAME
uninstrumented jitted engines (core/search.py records the wave/round
spans from the already-measured envelope elapsed — the compiled
computation is untouched, kernels bit-identical with tracing on,
pinned in tests/test_tracing.py).

Sampling knobs: default always-on (tests, debugging).  Production
paths rate-limit new roots via :meth:`Tracer.set_sample_rate` or the
``OPENDHT_TPU_TRACE_RATE`` env var (roots per second; unsampled ops
cost one contextvar read and emit no wire bytes).  ``Tracer.enabled =
False`` turns every hook into a single attribute check.

Import-light by design (stdlib only) so net/scheduler layers keep
working in minimal containers.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import random
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "TRACE_WIRE_KEY", "TraceContext", "Span", "Tracer", "activate",
    "current", "decode_wire", "get_tracer", "run_with", "to_chrome_trace",
]

#: the optional top-level msgpack key carrying the context on queries
TRACE_WIRE_KEY = "tr"

FLAG_SAMPLED = 1

_rng = random.Random()          # ids need uniqueness, not secrecy


def _new_id(bits: int) -> int:
    return _rng.getrandbits(bits) or 1


class TraceContext:
    """Immutable (trace_id, span_id, flags) triple.  ``span_id`` is the
    id of the span that OWNS this context — a child span parents to it."""

    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: int, span_id: int,
                 flags: int = FLAG_SAMPLED):
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = flags

    @property
    def sampled(self) -> bool:
        return bool(self.flags & FLAG_SAMPLED)

    @classmethod
    def new_root(cls, sampled: bool = True) -> "TraceContext":
        return cls(_new_id(128), _new_id(64),
                   FLAG_SAMPLED if sampled else 0)

    def child(self) -> "TraceContext":
        """Same trace, fresh span id, flags inherited."""
        return TraceContext(self.trace_id, _new_id(64), self.flags)

    @property
    def trace_hex(self) -> str:
        return "%032x" % self.trace_id

    @property
    def span_hex(self) -> str:
        return "%016x" % self.span_id

    def to_wire(self) -> dict:
        return {"i": self.trace_id.to_bytes(16, "big"),
                "s": self.span_id.to_bytes(8, "big"),
                "f": self.flags & 0xFF}

    def __repr__(self):
        return "TraceContext(%s/%s f=%d)" % (self.trace_hex, self.span_hex,
                                             self.flags)


def decode_wire(obj) -> Optional[TraceContext]:
    """Bounded decode of the wire key — ``None`` on ANYTHING that is not
    exactly the expected shape (wrong type, wrong lengths, hostile
    oversized blobs).  Never raises: the ingress path calls this on
    attacker-controlled bytes."""
    try:
        if not isinstance(obj, dict) or len(obj) > 8:
            return None
        i, s = obj.get("i"), obj.get("s")
        if not isinstance(i, (bytes, bytearray)) or len(i) != 16:
            return None
        if not isinstance(s, (bytes, bytearray)) or len(s) != 8:
            return None
        f = obj.get("f", FLAG_SAMPLED)
        if not isinstance(f, int):
            return None
        tid = int.from_bytes(bytes(i), "big")
        sid = int.from_bytes(bytes(s), "big")
        if not tid or not sid:
            return None
        return TraceContext(tid, sid, f & 0xFF)
    except Exception:
        return None


# ------------------------------------------------------------- ambient ctx
_CURRENT: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("opendht_tpu_trace_ctx", default=None)


def current() -> Optional[TraceContext]:
    """The ambient trace context of this task/thread (or None)."""
    return _CURRENT.get()


def current_trace_hex() -> Optional[str]:
    """The ambient trace id as its canonical 32-hex form, or None —
    the exemplar stamp: waterfall stage observations made
    under a sampled op link their histogram bucket to a trace the
    trace assembler can reconstruct.  One contextvar read + one
    format on the sampled path; a single None-check otherwise."""
    ctx = _CURRENT.get()
    return ctx.trace_hex if ctx is not None else None


class activate:
    """``with tracing.activate(ctx): ...`` — sets the ambient context
    for the block (including to None: a search step must not inherit a
    foreign op's context from whatever ran before it)."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx

    def __enter__(self):
        self._token = _CURRENT.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        _CURRENT.reset(self._token)


def run_with(ctx: Optional[TraceContext], fn):
    """Call ``fn()`` under ``ctx`` as the ambient context (no-op wrapper
    when ctx is None — the unsampled fast path adds one ``is None``)."""
    if ctx is None:
        return fn()
    token = _CURRENT.set(ctx)
    try:
        return fn()
    finally:
        _CURRENT.reset(token)


# ------------------------------------------------------------------- spans
class Span:
    """Active recording handle; records into the ring on :meth:`end`.
    Usable as a context manager (activates its context for the block)."""

    __slots__ = ("_tracer", "name", "kind", "ctx", "parent_id", "node",
                 "start", "attrs", "_t0", "_ended", "_token")

    def __init__(self, tracer: "Tracer", name: str, ctx: TraceContext,
                 parent_id: Optional[int], kind: str, node: str,
                 attrs: dict):
        self._tracer = tracer
        self.name = name
        self.kind = kind
        self.ctx = ctx
        self.parent_id = parent_id
        self.node = node
        self.attrs = attrs
        self.start = time.time()
        self._t0 = time.perf_counter()
        self._ended = False
        self._token = None

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self) -> None:
        if self._ended:
            return
        self._ended = True
        self._tracer._append_span(
            self.name, self.ctx, self.parent_id, self.kind, self.node,
            self.start, time.perf_counter() - self._t0, self.attrs)

    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self.ctx)
        return self

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        self.end()


class _NoopSpan:
    """Shared do-nothing span: every hook stays unconditional at the
    call site while the disabled/unsampled path costs ~nothing."""

    __slots__ = ()
    ctx = None
    parent_id = None

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class _RateSampler:
    """Token bucket: admit at most ``per_sec`` new root traces per
    second (burst = one second's budget)."""

    def __init__(self, per_sec: float):
        self.per_sec = float(per_sec)
        self._tokens = self.per_sec           # rate 0 = sample nothing
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def __call__(self) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self._tokens
                               + (now - self._last) * self.per_sec,
                               max(self.per_sec, 1.0))
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


class Tracer:
    """Span recorder + flight recorder over one bounded ring."""

    def __init__(self, capacity: int = 8192, node: str = ""):
        self.capacity = int(capacity)
        self.node = node
        #: master switch: False turns every hook into one attribute read
        self.enabled = True
        # deque(maxlen): bounded memory, oldest-evicted, O(1) append
        # (append is atomic under the GIL; the lock guards snapshots)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._sampler = None            # None = always sample new roots

    # ------------------------------------------------------------ sampling
    def set_sample_rate(self, per_sec: "float | None") -> None:
        """Head-based sampling budget for NEW root traces (child spans
        always follow their parent's flag).  ``None`` = always-on."""
        self._sampler = None if per_sec is None else _RateSampler(per_sec)

    def set_sampler(self, fn) -> None:
        """Custom root sampler: callable returning bool (None resets)."""
        self._sampler = fn

    def _sample_root(self) -> bool:
        s = self._sampler
        return True if s is None else bool(s())

    # ------------------------------------------------------------- spans
    def span(self, name: str, *, parent: Optional[TraceContext] = None,
             kind: str = "internal", node: Optional[str] = None,
             **attrs) -> "Span | _NoopSpan":
        """Open a span.  ``parent=None`` starts a new root (consults the
        head sampler); an unsampled parent or a disabled tracer returns
        the shared no-op span."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is None:
            if not self._sample_root():
                return NOOP_SPAN
            ctx = TraceContext.new_root()
            parent_id = None
        else:
            if not parent.sampled:
                return NOOP_SPAN
            ctx = parent.child()
            parent_id = parent.span_id
        return Span(self, name, ctx, parent_id, kind,
                    node if node is not None else self.node, attrs)

    def record(self, name: str, start: float, dur: float, *,
               parent: Optional[TraceContext] = None,
               kind: str = "internal", node: Optional[str] = None,
               **attrs) -> Optional[TraceContext]:
        """Retro-record a span whose timing is already known (the search
        envelope measures first, records after).  Returns the new span's
        context (for parenting children) or None when not sampled."""
        if not self.enabled:
            return None
        if parent is None:
            if not self._sample_root():
                return None
            ctx = TraceContext.new_root()
            parent_id = None
        else:
            if not parent.sampled:
                return None
            ctx = parent.child()
            parent_id = parent.span_id
        self._append_span(name, ctx, parent_id, kind,
                          node if node is not None else self.node,
                          start, dur, attrs)
        return ctx

    def _append_span(self, name: str, ctx: TraceContext,
                     parent_id: Optional[int], kind: str, node: str,
                     start: float, dur: float, attrs: dict) -> None:
        self._ring.append({
            "seq": next(self._seq),
            "trace_id": ctx.trace_hex,
            "span_id": ctx.span_hex,
            "parent_id": ("%016x" % parent_id) if parent_id else None,
            "name": name,
            "kind": kind,
            "node": node,
            "start": start,
            "dur": max(float(dur), 0.0),
            "attrs": attrs,
        })

    # ---------------------------------------------------- flight recorder
    def event(self, name: str, *, node: Optional[str] = None,
              **attrs) -> None:
        """Record one structured flight-recorder event (request state
        transitions, timeouts, rate-limit drops, compactions, churn
        swaps).  Always-on while the tracer is enabled — events are not
        sampled; the bounded ring is the budget."""
        if not self.enabled:
            return
        self._ring.append({
            "seq": next(self._seq),
            "ev": name,
            "t": time.time(),
            "node": node if node is not None else self.node,
            "attrs": attrs,
        })

    # ------------------------------------------------------------- export
    def records(self) -> List[dict]:
        """Consistent snapshot of the whole ring (spans + events)."""
        with self._lock:
            return list(self._ring)

    def spans(self, trace_id=None) -> List[dict]:
        """Finished spans, optionally filtered to one trace.
        ``trace_id`` accepts an int, a (up to) 32-hex string, or a
        TraceContext.  A MALFORMED id (non-hex, oversized — see
        :func:`_trace_hex`) matches nothing: the caller asked for one
        trace, so a bogus id must return ``[]``, never the whole
        ring."""
        out = [r for r in self.records() if "ev" not in r]
        if trace_id is None:
            return out
        want = _trace_hex(trace_id)
        if want is None:
            return []
        return [r for r in out if r["trace_id"] == want]

    def events(self, limit: Optional[int] = None,
               name: Optional[str] = None) -> List[dict]:
        """Flight events, optionally name-filtered (substring match,
        e.g. ``"health"`` keeps ``health_transition``)."""
        out = [r for r in self.records()
               if "ev" in r and (name is None or name in r["ev"])]
        return out[-limit:] if limit else out

    def dump(self, name: Optional[str] = None) -> dict:
        """The full flight-recorder dump (↔ ``Dht::dumpTables`` as a
        structured artifact): node tag, capacity, every retained span
        and event.  ``name`` filters spans AND events by name
        substring at dump time — a read-side projection only: the ring
        and its eviction order are untouched."""
        recs = self.records()
        if name is not None:
            recs = [r for r in recs if name in r.get("ev", r.get("name", ""))]
        return {
            "node": self.node,
            "capacity": self.capacity,
            "spans": [r for r in recs if "ev" not in r],
            "events": [r for r in recs if "ev" in r],
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


def _trace_hex(trace_id) -> Optional[str]:
    """Normalize a trace id to its canonical 32-hex form; ``None`` for
    anything MALFORMED (non-hex characters, > 32 hex digits, empty) —
    the distinction the proxy's ``GET /trace/<id>`` route needs: a
    bogus id is a 400, a well-formed unknown id is an empty span list
    (the old normalization char-stripped ``0``/
    ``x`` and silently truncated, so both cases looked identical)."""
    if trace_id is None:
        return None
    if isinstance(trace_id, TraceContext):
        return trace_id.trace_hex
    if isinstance(trace_id, int):
        return "%032x" % (trace_id & ((1 << 128) - 1))
    s = str(trace_id).strip().lower()
    if s.startswith("0x"):
        s = s[2:]
    # charset check, NOT int(s, 16): Python's int() accepts digit-group
    # underscores and sign prefixes, so 'a_b'/'+ab'/'-1' would pass as
    # well-formed
    if not s or len(s) > 32 or any(c not in "0123456789abcdef" for c in s):
        return None
    return s.rjust(32, "0")


# ------------------------------------------------------ chrome trace export
def to_chrome_trace(records: Optional[Iterable[dict]] = None,
                    tracer: Optional[Tracer] = None) -> dict:
    """Chrome trace-event JSON (Perfetto-loadable): spans as ``ph:"X"``
    complete events with pid = node (one process per DHT node, named
    via ``process_name`` metadata) and tid = op (named via
    ``thread_name``), ``ts``/``dur`` in microseconds; flight-recorder
    events as ``ph:"i"`` instants.  ``json.dump`` the result into a
    ``.json`` and load it in ``ui.perfetto.dev`` / ``chrome://tracing``."""
    if records is None:
        records = (tracer or get_tracer()).records()
    events: List[dict] = []
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}

    def pid_of(node: str) -> int:
        pid = pids.get(node)
        if pid is None:
            pid = pids[node] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": node or "dht-node"}})
        return pid

    def tid_of(pid: int, op: str) -> int:
        key = (pid, op)
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = sum(1 for k in tids if k[0] == pid) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": op}})
        return tid

    for r in records:
        if "ev" in r:
            events.append({
                "ph": "i", "s": "p", "name": r["ev"],
                "pid": pid_of(r.get("node", "")), "tid": 0,
                "ts": r["t"] * 1e6,
                "args": dict(r.get("attrs", {})),
            })
        else:
            pid = pid_of(r.get("node", ""))
            args: Dict[str, Any] = {
                "trace_id": r["trace_id"], "span_id": r["span_id"],
            }
            if r.get("parent_id"):
                args["parent_id"] = r["parent_id"]
            args.update(r.get("attrs", {}))
            events.append({
                "ph": "X", "name": r["name"],
                "cat": r.get("kind", "internal"),
                "pid": pid, "tid": tid_of(pid, r["name"]),
                "ts": r["start"] * 1e6, "dur": r["dur"] * 1e6,
                "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# --------------------------------------------------------- global instance
def _default_capacity() -> int:
    try:
        return max(int(os.environ.get("OPENDHT_TPU_TRACE_RING", "8192")), 16)
    except ValueError:
        return 8192


_global_tracer = Tracer(capacity=_default_capacity())
_rate_env = os.environ.get("OPENDHT_TPU_TRACE_RATE", "")
if _rate_env:
    try:
        _global_tracer.set_sample_rate(float(_rate_env))
    except ValueError:
        pass


def get_tracer() -> Tracer:
    """The process-global tracer every layer feeds by default.  A
    multi-node test process shares one ring; spans carry a per-node tag
    so the cross-node assembler groups correctly either way."""
    return _global_tracer
