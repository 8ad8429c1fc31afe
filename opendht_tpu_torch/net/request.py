"""In-flight RPC state machine (reference src/request.h).

A copy of the JAX package's ``net/request.py`` with its behaviour unchanged.

PENDING → COMPLETED (reply matched by tid) | EXPIRED (3 attempts × 1 s
timed out) | CANCELLED.  ``on_expired(req, done)`` fires once with
done=False after the first re-attempt (early hint used to solicit other
candidates) and once with done=True on final expiry.

Every terminal transition feeds the telemetry spine: completion counts
into ``dht_net_requests_completed_total{type=}`` with the request's RTT
observed into ``dht_net_rtt_seconds{type=}`` (reply_time − start, both
stamped by the engine on scheduler time), expiry into
``dht_net_requests_expired_total{type=}`` (plus the censored-attempt
counter ``dht_net_attempt_timeouts_total{type=}`` — an expired
request's attempts all timed out and never reached the RTT histogram,
so without it loss silently thins the latency surface),
cancellation into ``dht_net_requests_cancelled_total{type=}``.  The
matching send-side counters (sent / per-attempt timeouts) live in
:mod:`~opendht_tpu.net.engine`.

the engine attaches the per-peer ledger
(:mod:`~opendht_tpu.peers`) to ``ledger`` at send time and stamps
``rto`` with the peer's adaptive retransmit timeout (exactly
``MAX_RESPONSE_TIME`` when the knob is off or the peer has no RTT
samples — the fixed-timeout behaviour pin); terminal transitions
report back so per-peer completed/expired/cancelled counts and the
Jacobson/Karels estimator stay attributed per link.

Distributed tracing: a request sent under a sampled trace
context carries the engine-opened per-hop client span in
``trace_span``; the terminal transition stamps the outcome and closes
it, so the span's duration is the full send→reply (or →expiry) life of
the RPC including retries.  Expiry/cancellation additionally drop a
flight-recorder event (the exceptional state transitions; completions
are already the span)."""

from __future__ import annotations

import enum
from typing import TYPE_CHECKING, Callable, Dict, Optional

from .. import telemetry, tracing
from .node import MAX_RESPONSE_TIME, Node

if TYPE_CHECKING:
    from .parsed_message import MessageType, ParsedMessage

MAX_ATTEMPT_COUNT = 3           # request.h:108

_NEVER = float("-inf")

# metric handles cached per (event, message-type): the lifecycle runs
# once per RPC, but a busy node retires thousands of RPCs per second —
# the registry's get-or-create lock stays off that path
_m_cache: Dict[tuple, object] = {}


def _metric(kind: str, name: str, mtype: "MessageType"):
    key = (name, mtype)
    m = _m_cache.get(key)
    if m is None:
        reg = telemetry.get_registry()
        # the wire name ("put"/"get"/...) — matches the type labels the
        # engine's dht_net_messages_total counters use
        label = mtype.value if hasattr(mtype, "value") else str(mtype)
        m = (reg.histogram(name, type=label) if kind == "histogram"
             else reg.counter(name, type=label))
        _m_cache[key] = m
    return m


class RequestState(enum.Enum):
    PENDING = "pending"
    CANCELLED = "cancelled"
    EXPIRED = "expired"
    COMPLETED = "completed"


class Request:
    __slots__ = ("node", "tid", "type", "msg", "on_done", "on_expired",
                 "socket_id", "state", "attempt_count", "start", "last_try",
                 "reply_time", "trace_span", "rto", "ledger")

    def __init__(self, msg_type: "MessageType", tid: int, node: Node,
                 msg: bytes,
                 on_done: Optional[Callable[["Request", "ParsedMessage"], None]],
                 on_expired: Optional[Callable[["Request", bool], None]],
                 socket_id: int = 0, trace_span=None):
        self.node = node
        self.tid = tid
        self.type = msg_type
        self.msg = msg
        self.on_done = on_done
        self.on_expired = on_expired
        self.socket_id = socket_id
        self.state = RequestState.PENDING
        self.attempt_count = 0
        self.start = _NEVER
        self.last_try = _NEVER
        self.reply_time = _NEVER
        self.trace_span = trace_span      # per-hop client span
        # per-attempt retransmit timeout; the engine overwrites it from
        # the peer ledger when Config.peers.adaptive_rto is on, and the
        # ledger default keeps it at the reference's fixed value
        self.rto = MAX_RESPONSE_TIME
        self.ledger = None                # peers.PeerLedger, set at send

    # -- state predicates --------------------------------------------------
    @property
    def pending(self) -> bool:
        return self.state is RequestState.PENDING

    @property
    def completed(self) -> bool:
        return self.state is RequestState.COMPLETED

    @property
    def expired(self) -> bool:
        return self.state is RequestState.EXPIRED

    @property
    def cancelled(self) -> bool:
        return self.state is RequestState.CANCELLED

    @property
    def over(self) -> bool:
        return not self.pending

    def is_expired(self, now: float) -> bool:
        """All attempts used and the last one timed out (request.h:110-112).
        ``>=``, not ``>``: retries are scheduled at exactly
        last_try + rto, and discrete-event drivers land on that
        instant — strict compare would retry dead nodes forever.
        ``rto`` is the per-peer adaptive timeout when enabled and is
        pinned to ``MAX_RESPONSE_TIME`` otherwise."""
        return (self.pending
                and now >= self.last_try + self.rto
                and self.attempt_count >= MAX_ATTEMPT_COUNT)

    # -- transitions (request.h:88-105) ------------------------------------
    def _finish_span(self, outcome: str) -> None:
        sp = self.trace_span
        if sp is not None:
            sp.set(outcome=outcome, attempts=self.attempt_count,
                   tid=self.tid)
            sp.end()
            self.trace_span = None

    def set_expired(self) -> None:
        if self.pending:
            self.state = RequestState.EXPIRED
            _metric("counter", "dht_net_requests_expired_total",
                    self.type).inc()
            # every attempt of an expired request
            # timed out without reaching dht_net_rtt_seconds — count
            # the censored attempts so loss shows up next to RTT
            # instead of silently thinning the histogram (a request
            # expired before any attempt — node.set_expired — still
            # censors one solicited answer)
            _metric("counter", "dht_net_attempt_timeouts_total",
                    self.type).inc(max(self.attempt_count, 1))
            if self.ledger is not None:
                self.ledger.on_request_expired(self)
            tr = tracing.get_tracer()
            if tr.enabled:
                tr.event("request_expired", type=self.type.value,
                         tid=self.tid, attempts=self.attempt_count)
            self._finish_span("expired")
            if self.on_expired:
                self.on_expired(self, True)
            self._clear()

    def set_done(self, msg: "ParsedMessage") -> None:
        if self.pending:
            self.state = RequestState.COMPLETED
            _metric("counter", "dht_net_requests_completed_total",
                    self.type).inc()
            rtt = None
            if self.reply_time != _NEVER and self.start != _NEVER:
                rtt = max(self.reply_time - self.start, 0.0)
                _metric("histogram", "dht_net_rtt_seconds", self.type) \
                    .observe(rtt)
                # the same RTT is the waterfall's rpc_wait
                # stage — the network plane of the per-op story (runs
                # concurrent with the device stages, so it is excluded
                # from the per-op sum pin); a hop sent under a sampled
                # trace stamps its bucket with the hop span's trace id
                from .. import waterfall
                wf = waterfall.get_profiler()
                if wf.enabled:
                    sp = self.trace_span
                    wf.observe("rpc_wait", rtt,
                               exemplar=(sp.ctx.trace_hex
                                         if sp is not None else None))
            if self.ledger is not None:
                self.ledger.on_request_completed(self, rtt)
            self._finish_span("completed")
            if self.on_done:
                self.on_done(self, msg)
            self._clear()

    def cancel(self) -> None:
        if self.pending:
            self.state = RequestState.CANCELLED
            _metric("counter", "dht_net_requests_cancelled_total",
                    self.type).inc()
            if self.ledger is not None:
                self.ledger.on_request_cancelled(self)
            tr = tracing.get_tracer()
            if tr.enabled:
                tr.event("request_cancelled", type=self.type.value,
                         tid=self.tid)
            self._finish_span("cancelled")
            self._clear()

    def close_socket(self) -> int:
        sid = self.socket_id
        self.socket_id = 0
        return sid

    def _clear(self) -> None:
        self.on_done = None
        self.on_expired = None
        self.msg = b""
        self.ledger = None

    def state_char(self) -> str:
        return {"pending": "f", "cancelled": "c", "expired": "e",
                "completed": "a"}[self.state.value]
