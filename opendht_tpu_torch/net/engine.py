"""The transport engine (reference src/network_engine.cpp,
include/opendht/network_engine.h).

A copy of the JAX package's ``net/engine.py`` with its behaviour unchanged.

Serializes each RPC as a msgpack map (key order byte-identical to the
reference), drives the request lifecycle (3 × 1 s retries via the
scheduler), parses and dispatches incoming packets to the nine upward
callbacks, fragments/reassembles oversized values, applies per-IP and
global ingress rate limits, filters martians, blacklists misbehaving
peers, and packs closest-node sets into compact 26 B / 38 B triples.

Transport-agnostic: datagrams leave through an injected
``send_fn(data: bytes, addr: SockAddr) -> int`` (0 on success, errno
otherwise) so the same engine runs over asyncio UDP, the native C++
datagram engine, or a loopback test harness."""

from __future__ import annotations

import socket as _socket
from dataclasses import dataclass, field as _field
from typing import Callable, Dict, List, Optional, Tuple

from .. import telemetry, tracing, waterfall
from ..infohash import InfoHash
from ..rate_limiter import RateLimiter
from ..scheduler import Scheduler
from ..sockaddr import SockAddr
from ..utils import DhtException, WANT4, WANT6, pack_msg, wall_now
from ..core.value import Query, Value, FieldValueIndex
from .node import Node, SocketCb
from .node_cache import NodeCache
from .parsed_message import (
    MessageType, ParsedMessage, REQUEST_TYPES, pack_tid, unpack_tid,
)
from .request import Request

# ---- constants (network_engine.h:424-441, network_engine.cpp:61-62) -------
MAX_REQUESTS_PER_SEC = 1600
SEND_NODES = 8
NODE4_INFO_BUF_LEN = 20 + 4 + 2
NODE6_INFO_BUF_LEN = 20 + 16 + 2
UDP_REPLY_TIME = 15.0
RX_MAX_PACKET_TIME = 10.0
RX_TIMEOUT = 3.0
BLACKLISTED_MAX = 10
MTU = 1280
MAX_PACKET_VALUE_SIZE = 600
AGENT = "RNG1"                      # my_v, network_engine.cpp:54

_FATAL_SEND_ERRNOS = frozenset({
    101,  # ENETUNREACH
    113,  # EHOSTUNREACH
    97,   # EAFNOSUPPORT
    32,   # EPIPE
    1,    # EPERM
})
_EAGAIN = 11


class DhtProtocolException(DhtException):
    """Peer protocol errors (network_engine.h:47-79)."""

    NON_AUTHORITATIVE_INFORMATION = 203   # incomplete request packet
    UNAUTHORIZED = 401                    # wrong token
    NOT_FOUND = 404                       # storage not found
    INVALID_TID_SIZE = 421
    UNKNOWN_TID = 422
    WRONG_NODE_INFO_BUF_LEN = 423

    GET_NO_INFOHASH = "Get_values with no info_hash"
    LISTEN_NO_INFOHASH = "Listen with no info_hash"
    LISTEN_WRONG_TOKEN = "Listen with wrong token"
    PUT_NO_INFOHASH = "Put with no info_hash"
    PUT_WRONG_TOKEN = "Put with wrong token"
    PUT_INVALID_ID = "Put with invalid id"
    STORAGE_NOT_FOUND = "Access operation for unknown storage"

    def __init__(self, code: int, msg: str = "", failing_node_id: InfoHash = None):
        super().__init__(msg)
        self.code = code
        self.msg = msg
        self.failing_node_id = failing_node_id or InfoHash()


@dataclass
class RequestAnswer:
    """What a reply carries back up to the DHT layer
    (network_engine.h:86-97)."""
    ntoken: bytes = b""
    vid: int = 0
    values: List[Value] = _field(default_factory=list)
    refreshed_values: List[int] = _field(default_factory=list)
    expired_values: List[int] = _field(default_factory=list)
    fields: List[FieldValueIndex] = _field(default_factory=list)
    nodes4: List[Node] = _field(default_factory=list)
    nodes6: List[Node] = _field(default_factory=list)

    @classmethod
    def from_msg(cls, msg: ParsedMessage) -> "RequestAnswer":
        return cls(ntoken=msg.token, vid=msg.value_id, values=msg.values,
                   refreshed_values=msg.refreshed_values,
                   expired_values=msg.expired_values, fields=msg.fields,
                   nodes4=msg.nodes4, nodes6=msg.nodes6)


@dataclass
class EngineCallbacks:
    """The nine upward callbacks into the DHT core
    (network_engine.h:123-201)."""
    on_error: Callable[[Request, DhtProtocolException], None] = lambda r, e: None
    on_new_node: Callable[[Node, int], None] = lambda n, c: None
    on_reported_addr: Callable[[InfoHash, SockAddr], None] = lambda i, a: None
    on_ping: Callable[[Node], "RequestAnswer"] = lambda n: RequestAnswer()
    on_find_node: Callable[[Node, InfoHash, int], "RequestAnswer"] = \
        lambda n, t, w: RequestAnswer()
    on_get_values: Callable[[Node, InfoHash, int, Query], "RequestAnswer"] = \
        lambda n, h, w, q: RequestAnswer()
    on_listen: Callable[[Node, InfoHash, bytes, int, Query], "RequestAnswer"] = \
        lambda n, h, t, s, q: RequestAnswer()
    on_announce: Callable[[Node, InfoHash, bytes, List[Value], Optional[float]],
                          "RequestAnswer"] = lambda n, h, t, v, c: RequestAnswer()
    on_refresh: Callable[[Node, InfoHash, bytes, int], "RequestAnswer"] = \
        lambda n, h, t, v: RequestAnswer()


@dataclass
class MessageStats:
    ping: int = 0
    find: int = 0
    get: int = 0
    put: int = 0
    listen: int = 0
    refresh: int = 0

    def as_list(self) -> List[int]:
        return [self.ping, self.find, self.get, self.listen, self.put]


class _PartialMessage:
    __slots__ = ("from_addr", "start", "last_part", "msg")

    def __init__(self, from_addr: SockAddr, now: float, msg: ParsedMessage):
        self.from_addr = from_addr
        self.start = now
        self.last_part = now
        self.msg = msg


def is_martian(addr: SockAddr) -> bool:
    """Addresses no sane peer sends from (network_engine.cpp:361-386)."""
    if addr.port == 0 or addr.ip is None:
        return True
    packed = addr.ip.packed
    if addr.family == _socket.AF_INET:
        return packed[0] == 0 or (packed[0] & 0xE0) == 0xE0
    if addr.family == _socket.AF_INET6:
        return (packed[0] == 0xFF
                or (packed[0] == 0xFE and (packed[1] & 0xC0) == 0x80)
                or packed == bytes(16)
                or packed[:12] == b"\0" * 10 + b"\xff\xff")
    return True


class NetworkEngine:
    def __init__(self, myid: InfoHash, network: int,
                 send_fn: Callable[[bytes, SockAddr], int],
                 scheduler: Scheduler,
                 callbacks: EngineCallbacks,
                 is_client: bool = False,
                 max_req_per_sec: int = MAX_REQUESTS_PER_SEC):
        self.myid = myid
        self.network = network
        self._send_fn = send_fn
        self.scheduler = scheduler
        self.cb = callbacks
        self.is_client = is_client
        self.cache = NodeCache()
        self.requests: Dict[int, Request] = {}       # anonymous-node requests
        self._partials: Dict[int, _PartialMessage] = {}
        self.in_stats = MessageStats()
        self.out_stats = MessageStats()
        self.blacklist: set[SockAddr] = set()
        self.reply_via: Optional[Node] = None   # see deserialize_nodes
        # configurable ingress budget (the reference hardcodes 1600/s
        # global + 200/s per IP, network_engine.h:424,519-523)
        self.max_req_per_sec = max(int(max_req_per_sec), 8)
        self._rate_limiter = RateLimiter(self.max_req_per_sec)
        self._ip_limiters: Dict[tuple, RateLimiter] = {}  # keyed by ip only
        self._limiter_maintenance = 0
        # telemetry: the registry mirrors of the MessageStats island
        # (counters labeled by direction+type) plus the send-side request
        # lifecycle; handles cached — one dict lookup per packet
        reg = telemetry.get_registry()
        self._m_msgs: Dict[tuple, telemetry.Counter] = {
            (d, t): reg.counter("dht_net_messages_total", direction=d, type=t)
            for d in ("in", "out")
            for t in ("ping", "find", "get", "put", "listen", "refresh")}
        self._m_ratelimit_drops = reg.counter("dht_net_ratelimit_drops_total")
        self._m_sent: Dict[object, telemetry.Counter] = {}
        self._m_timeouts = reg.counter("dht_net_request_timeouts_total")
        # distributed tracing: client spans on outgoing
        # queries (the wire context is the span's own ctx), server
        # spans around incoming request dispatch, flight-recorder
        # events on drops/timeouts.  One tracer per process; spans are
        # tagged with this engine's node id so multi-node test
        # processes still assemble per-node trees.
        self._tracer = tracing.get_tracer()
        self._node_tag = str(myid)
        # adversarial chaos plane: optional per-packet fault
        # hook consulted by _send.  None (the default) leaves the send
        # path byte-identical to pre-chaos builds; armed by
        # opendht_tpu/chaos.py arm_engine under the Config.chaos_enabled
        # guard.  hook(data, addr) -> True means the hook consumed the
        # packet (dropped, or rescheduled with extra delay).
        self.fault_hook: Optional[Callable[[bytes, SockAddr], bool]] = None
        # per-peer network observatory: optional
        # peers.PeerLedger attached by runtime.dht.Dht under the
        # Config.peers guard.  None (the default) leaves the request
        # lifecycle byte- and timing-identical to earlier builds;
        # attached, every request carries the ledger + the peer's
        # adaptive RTO (MAX_RESPONSE_TIME until RTT samples exist).
        self.peers = None

    def _count_msg(self, direction: str, mtype: str) -> None:
        c = self._m_msgs.get((direction, mtype))
        if c is not None:
            c.inc()

    def _count_sent(self, req: Request) -> None:
        c = self._m_sent.get(req.type)
        if c is None:
            c = self._m_sent[req.type] = telemetry.get_registry().counter(
                "dht_net_requests_sent_total", type=req.type.value)
        c.inc()

    # ------------------------------------------------------------------ util
    def _header(self, body_key: str, body: dict, y: str, tid: int,
                query: Optional[str] = None,
                trace: "tracing.TraceContext | None" = None) -> bytes:
        """Assemble the outer packet map in the reference's key order:
        a/r/e, [q], t, y, v, [n], [tr] (network_engine.cpp:677-1305;
        ``tr`` is this port's optional trace-context key — appended
        LAST so every byte before it is unchanged when absent, and old
        parsers skip it as an unknown top-level key)."""
        out: dict = {body_key: body}
        if query is not None:
            out["q"] = query
        if self.is_client:
            # advertise client mode so peers keep us out of routing tables
            # (parsed on rx as 's', parsed_message.h:143-144; the reference
            # reads but never sends it — emitting is forward-compatible)
            out["s"] = True
        out["t"] = pack_tid(tid)
        out["y"] = y
        out["v"] = AGENT
        if self.network:
            out["n"] = self.network
        if trace is not None:
            out[tracing.TRACE_WIRE_KEY] = trace.to_wire()
        return pack_msg(out)

    def _trace_client(self, mtype: str, node: Node):
        """Open the per-RPC client span when an ambient sampled trace
        context is active (the runner op / search step activated it);
        returns ``(span_or_None, wire_ctx_or_None)``.  The span's OWN
        context is what rides the wire, so the receiving node's server
        span parents to this hop."""
        ctx = tracing.current()
        if ctx is None or not ctx.sampled or not self._tracer.enabled:
            return None, None
        span = self._tracer.span("dht.rpc." + mtype, parent=ctx,
                                 kind="client", node=self._node_tag,
                                 peer=str(node.addr))
        return span, span.ctx

    def _send(self, data: bytes, addr: SockAddr) -> int:
        hook = self.fault_hook
        if hook is not None and hook(data, addr):
            return 0
        try:
            return self._send_fn(data, addr) or 0
        except OSError as e:
            return e.errno or 1

    @staticmethod
    def _want_list(want: int) -> list:
        fams = []
        if want & WANT4:
            fams.append(_socket.AF_INET)
        if want & WANT6:
            fams.append(_socket.AF_INET6)
        return fams

    def get_cached_nodes(self, target: InfoHash, family: int, count: int
                         ) -> List[Node]:
        return self.cache.get_cached_nodes(target, family, count)

    def get_node_message_stats(self, incoming: bool) -> List[int]:
        st = self.in_stats if incoming else self.out_stats
        out = st.as_list()
        st.__init__()
        return out

    def connectivity_changed(self, family: int = 0) -> None:
        self.cache.clear_bad_nodes(family)

    def clear(self) -> None:
        for req in self.requests.values():
            req.cancel()
            req.node.set_expired()
        self.requests.clear()

    def blacklist_node(self, node: Node) -> None:
        node.set_expired()
        self.blacklist.add(node.addr)

    def is_blacklisted(self, addr: SockAddr) -> bool:
        return addr in self.blacklist

    # ---------------------------------------------------- request lifecycle
    def _send_request(self, req: Request) -> None:
        """(network_engine.cpp:323-336)"""
        if not req.node.id:
            self.requests[req.tid] = req
        req.start = self.scheduler.time()
        req.node.requested(req)
        self._count_sent(req)
        peers = self.peers
        if peers is not None:
            req.ledger = peers
            req.rto = peers.rto(req.node)
            peers.on_send(req.node, req.type.value, len(req.msg))
        self._request_step(req)

    def _request_step(self, req: Request) -> None:
        """One attempt + retry scheduling (network_engine.cpp:279-321)."""
        if not req.pending:
            return
        now = self.scheduler.time()
        node = req.node
        if req.is_expired(now):
            node.set_expired()
            if not node.id:
                self.requests.pop(req.tid, None)
            # an expired RPC is the rpc_wait stage's tail —
            # set_done only sees replies, so without this sample the
            # waterfall's network plane would show nothing but the
            # happy path (the 3.5 s stage budget ≈ full expiry)
            if req.start != float("-inf"):
                wf = waterfall.get_profiler()
                if wf.enabled:
                    sp = req.trace_span
                    wf.observe("rpc_wait", max(0.0, now - req.start),
                               exemplar=(sp.ctx.trace_hex
                                         if sp is not None else None))
            req.set_expired()
            return
        if req.attempt_count == 1 and req.on_expired:
            req.on_expired(req, False)     # early hint: first retry underway

        err = self._send(req.msg, node.addr)
        if err in _FATAL_SEND_ERRNOS:
            node.set_expired()
            if not node.id:
                self.requests.pop(req.tid, None)
        else:
            if err != _EAGAIN:
                if req.attempt_count >= 1:
                    # a real retransmission: the previous attempt timed
                    # out (counting here, not at step entry, so EAGAIN
                    # reschedules of the SAME attempt count once)
                    self._m_timeouts.inc()
                    if req.ledger is not None:
                        # per-peer attempt-timeout + resent
                        # bytes, then refresh the RTO for the NEXT
                        # attempt (the estimator may have new samples
                        # from the peer's other in-flight requests)
                        req.ledger.on_retransmit(req)
                        req.rto = req.ledger.rto(node)
                    if self._tracer.enabled:
                        self._tracer.event(
                            "request_timeout", node=self._node_tag,
                            type=req.type.value, tid=req.tid,
                            attempt=req.attempt_count)
                req.attempt_count += 1
            req.last_try = now
            self.scheduler.add(req.last_try + req.rto,
                               lambda: self._request_step(req))

    # -------------------------------------------------------- rate limiting
    def _rate_limit(self, addr: SockAddr) -> bool:
        """(network_engine.cpp:340-359): per-IP (200/s) then global
        (1600/s) sliding windows."""
        now = self.scheduler.time()
        self._limiter_maintenance += 1
        if self._limiter_maintenance == self.max_req_per_sec // 8:
            for key in list(self._ip_limiters):
                if self._ip_limiters[key].maintain(now) == 0:
                    del self._ip_limiters[key]
            self._limiter_maintenance = 0
        key = (addr.family, addr.ip.packed if addr.ip else b"")
        lim = self._ip_limiters.get(key)
        if lim is None:
            lim = self._ip_limiters[key] = RateLimiter(
                self.max_req_per_sec // 8)
        return lim.limit(now) and self._rate_limiter.limit(now)

    # ------------------------------------------------------------ rx path
    def process_message(self, data: bytes, from_addr: SockAddr) -> None:
        """Entry point for every received datagram
        (network_engine.cpp:403-489)."""
        if is_martian(from_addr) or self.is_blacklisted(from_addr):
            return
        try:
            msg = ParsedMessage.from_bytes(data)
        except Exception:
            return
        if msg.network != self.network:
            return
        now = self.scheduler.time()

        if msg.type is MessageType.VALUE_DATA:
            pm = self._partials.get(msg.tid)
            if pm is None or not pm.from_addr.same_ip(from_addr):
                self._rate_limit(from_addr)
                return
            if pm.msg.append(msg):
                pm.last_part = now
                if pm.msg.complete():
                    del self._partials[msg.tid]
                    self._process(pm.msg, from_addr)
                else:
                    self.scheduler.add(
                        now + RX_TIMEOUT,
                        lambda t=msg.tid: self._maintain_rx_buffer(t))
            return

        if msg.id == self.myid or not msg.id:
            return          # self-message
        if msg.type in REQUEST_TYPES and not self._rate_limit(from_addr):
            self._m_ratelimit_drops.inc()
            if self._tracer.enabled:
                self._tracer.event("ratelimit_drop", node=self._node_tag,
                                   type=msg.type.value,
                                   addr=str(from_addr))
            return

        if not msg.value_parts:
            self._process(msg, from_addr, nbytes=len(data))
        elif msg.tid not in self._partials:
            self._partials[msg.tid] = _PartialMessage(from_addr, now, msg)
            self.scheduler.add(now + RX_MAX_PACKET_TIME,
                               lambda t=msg.tid: self._maintain_rx_buffer(t))
            self.scheduler.add(now + RX_TIMEOUT,
                               lambda t=msg.tid: self._maintain_rx_buffer(t))

    def _maintain_rx_buffer(self, tid: int) -> None:
        """Drop stalled partial messages (network_engine.cpp:1293-1305)."""
        pm = self._partials.get(tid)
        if pm is None:
            return
        now = self.scheduler.time()
        if (pm.start + RX_MAX_PACKET_TIME < now
                or pm.last_part + RX_TIMEOUT < now):
            del self._partials[tid]

    def _process(self, msg: ParsedMessage, from_addr: SockAddr,
                 nbytes: int = 0) -> None:
        """Dispatch one complete message (network_engine.cpp:491-633).
        ``nbytes`` is the raw datagram size for per-peer byte
        attribution (0 for reassembled multi-part values — the
        fragments' raw sizes are not retained)."""
        now = self.scheduler.time()
        node = self.cache.get_node(msg.id, from_addr, now, confirm=True,
                                   client=msg.is_client)
        if self.peers is not None:
            self.peers.on_received(node, msg.type.value, nbytes)
        # an incoming request carrying a sampled wire context
        # records a server span around the whole handler + reply send,
        # parented to the sender's per-hop client span — that link is
        # what the cross-node assembler stitches trees from.
        tctx = msg.trace_ctx
        span = (self._tracer.span("dht.server." + msg.type.value,
                                  parent=tctx, kind="server",
                                  node=self._node_tag,
                                  peer=str(from_addr))
                if (tctx is not None and tctx.sampled
                    and msg.type in REQUEST_TYPES
                    and self._tracer.enabled)
                else tracing.NOOP_SPAN)
        try:
            with span:
                try:
                    self._dispatch(msg, node, from_addr, now)
                except DhtProtocolException as e:
                    span.set(error=e.code)      # before the span ends
                    raise
        except DhtProtocolException as e:
            if msg.type in REQUEST_TYPES:
                self.send_error(from_addr, msg.tid, e.code, e.msg,
                                include_id=True)

    def _dispatch(self, msg: ParsedMessage, node: Node, from_addr: SockAddr,
                  now: float) -> None:
        if msg.type is MessageType.VALUE_UPDATE:
            rsocket = node.get_socket(msg.tid)
            if rsocket is None:
                raise DhtProtocolException(DhtProtocolException.UNKNOWN_TID,
                                           "Can't find socket", msg.id)
            node.received(now)
            # reply-confirmed nodes are reported unconditionally; the
            # client filter only applies to confirm=1 query paths
            # (network_engine.cpp:496-528,570-572)
            self.cb.on_new_node(node, 2)
            self.deserialize_nodes(msg, from_addr, via=node)
            rsocket.on_receive(node, msg)
            return

        if msg.type in (MessageType.ERROR, MessageType.REPLY):
            rsocket = node.get_socket(msg.tid)
            req = node.get_request(msg.tid)
            if req is None and rsocket is None:
                # maybe an answer to an anonymous (bootstrap) request
                anon = self.requests.get(msg.tid)
                if anon is not None and not anon.node.id:
                    req = anon
                    req.node = node
                    del self.requests[msg.tid]
                else:
                    node.received(now, req)
                    if not node.is_client:
                        self.cb.on_new_node(node, 1)
                    raise DhtProtocolException(
                        DhtProtocolException.UNKNOWN_TID,
                        "Can't find transaction", msg.id)
            node.received(now, req)
            self.cb.on_new_node(node, 2)
            self.cb.on_reported_addr(msg.id, msg.addr)

            if req is not None and req.over:
                return      # response to a dead request

            if msg.type is MessageType.ERROR:
                if (msg.id and req is not None and (
                        (msg.error_code == DhtProtocolException.NOT_FOUND
                         and req.type is MessageType.REFRESH)
                        or (msg.error_code == DhtProtocolException.UNAUTHORIZED
                            and req.type in (MessageType.ANNOUNCE_VALUE,
                                             MessageType.LISTEN)))):
                    req.last_try = float("-inf")
                    req.reply_time = float("-inf")
                    self.cb.on_error(req, DhtProtocolException(msg.error_code))
                return

            if req is not None:
                if req.type in (MessageType.ANNOUNCE_VALUE, MessageType.LISTEN):
                    node.auth_success()
                req.reply_time = now
                self.deserialize_nodes(msg, from_addr, via=node)
                req.set_done(msg)
            else:
                self.deserialize_nodes(msg, from_addr, via=node)
                rsocket.on_receive(node, msg)
            return

        # -------- incoming requests
        node.received(now)
        if not node.is_client:
            self.cb.on_new_node(node, 1)
        if msg.type is MessageType.PING:
            self.in_stats.ping += 1
            self._count_msg("in", "ping")
            self.cb.on_ping(node)
            self.send_pong(from_addr, msg.tid)
        elif msg.type is MessageType.FIND_NODE:
            self.in_stats.find += 1
            self._count_msg("in", "find")
            answer = self.cb.on_find_node(node, msg.target, msg.want)
            n4, n6 = self.buffer_nodes(from_addr.family, msg.target, msg.want,
                                       answer.nodes4, answer.nodes6)
            self.send_nodes_values(from_addr, msg.tid, n4, n6, [], Query(),
                                   answer.ntoken)
        elif msg.type is MessageType.GET_VALUES:
            self.in_stats.get += 1
            self._count_msg("in", "get")
            answer = self.cb.on_get_values(node, msg.info_hash, msg.want,
                                           msg.query)
            n4, n6 = self.buffer_nodes(from_addr.family, msg.info_hash,
                                       msg.want, answer.nodes4, answer.nodes6)
            self.send_nodes_values(from_addr, msg.tid, n4, n6, answer.values,
                                   msg.query, answer.ntoken)
        elif msg.type is MessageType.ANNOUNCE_VALUE:
            self.in_stats.put += 1
            self._count_msg("in", "put")
            self.cb.on_announce(node, msg.info_hash, msg.token, msg.values,
                                msg.created)
            # if the store failed we still confirm, to stop backtracking
            # polluting the DHT (network_engine.cpp:600-607)
            for v in msg.values:
                self.send_value_announced(from_addr, msg.tid, v.id)
        elif msg.type is MessageType.REFRESH:
            self.in_stats.refresh += 1
            self._count_msg("in", "refresh")
            self.cb.on_refresh(node, msg.info_hash, msg.token, msg.value_id)
            self.send_value_announced(from_addr, msg.tid, msg.value_id)
        elif msg.type is MessageType.LISTEN:
            self.in_stats.listen += 1
            self._count_msg("in", "listen")
            self.cb.on_listen(node, msg.info_hash, msg.token, msg.socket_id,
                              msg.query)
            self.send_listen_confirmation(from_addr, msg.tid)

    # ------------------------------------------------- node (de)serialization
    def deserialize_nodes(self, msg: ParsedMessage, from_addr: SockAddr,
                          via: Optional[Node] = None) -> None:
        """Unpack compact n4/n6 blobs into interned Nodes
        (network_engine.cpp:851-887).

        ``via`` (the replying node) is exposed as ``self.reply_via`` for
        the duration of the on_new_node callbacks, so the DHT core can
        attribute discoveries to the reply that carried them (per-search
        hop accounting, live_search.SearchNode.depth).  The engine is
        single-threaded under the scheduler, so a context attribute is
        race-free."""
        if (len(msg.nodes4_raw) % NODE4_INFO_BUF_LEN
                or len(msg.nodes6_raw) % NODE6_INFO_BUF_LEN):
            raise DhtProtocolException(
                DhtProtocolException.WRONG_NODE_INFO_BUF_LEN)
        now = self.scheduler.time()
        self.reply_via = via
        try:
            for raw, step, fam, out in (
                    (msg.nodes4_raw, NODE4_INFO_BUF_LEN, _socket.AF_INET,
                     msg.nodes4),
                    (msg.nodes6_raw, NODE6_INFO_BUF_LEN, _socket.AF_INET6,
                     msg.nodes6)):
                for off in range(0, len(raw), step):
                    ni = raw[off:off + step]
                    ni_id = InfoHash(ni[:20])
                    if ni_id == self.myid:
                        continue
                    addr = SockAddr(ni[20:step - 2],
                                    int.from_bytes(ni[step - 2:step], "big"))
                    if addr.is_loopback() and from_addr.family == fam:
                        # peer told us about a node on its own loopback:
                        # reinterpret relative to the peer's address
                        addr = SockAddr(from_addr.ip, addr.port)
                    if is_martian(addr) or self.is_blacklisted(addr):
                        continue
                    n = self.cache.get_node(ni_id, addr, now, confirm=False)
                    out.append(n)
                    self.cb.on_new_node(n, 0)
        finally:
            self.reply_via = None

    def buffer_nodes(self, family: int, target: InfoHash, want: int,
                     nodes4: List[Node], nodes6: List[Node]
                     ) -> Tuple[bytes, bytes]:
        """Sort by XOR distance to target, truncate to SEND_NODES, pack
        compact (network_engine.cpp:1002-1050)."""
        if want < 0:
            want = WANT4 if family == _socket.AF_INET else WANT6

        def pack(nodes: List[Node]) -> bytes:
            key_sorted = sorted(
                nodes,
                key=lambda n: bytes(target.xor(n.id)))
            return b"".join(
                bytes(n.id) + n.addr.to_compact()
                for n in key_sorted[:SEND_NODES])

        b4 = pack(nodes4) if want & WANT4 else b""
        b6 = pack(nodes6) if want & WANT6 else b""
        return b4, b6

    # ------------------------------------------------------------ tx: queries
    def send_ping(self, node: Node, on_done=None, on_expired=None) -> Request:
        tid = node.get_new_tid()
        span, tctx = self._trace_client("ping", node)
        data = self._header("a", {"id": bytes(self.myid)}, "q", tid,
                            query="ping", trace=tctx)
        req = Request(MessageType.PING, tid, node, data,
                      (lambda r, m: on_done(r, RequestAnswer.from_msg(m)))
                      if on_done else None,
                      on_expired, trace_span=span)
        self._send_request(req)
        self.out_stats.ping += 1
        self._count_msg("out", "ping")
        return req

    def send_find_node(self, node: Node, target: InfoHash, want: int = -1,
                       on_done=None, on_expired=None) -> Request:
        tid = node.get_new_tid()
        body: dict = {"id": bytes(self.myid), "target": bytes(target)}
        if want > 0:
            body["w"] = self._want_list(want)
        span, tctx = self._trace_client("find", node)
        data = self._header("a", body, "q", tid, query="find", trace=tctx)
        req = Request(MessageType.FIND_NODE, tid, node, data,
                      (lambda r, m: on_done(r, RequestAnswer.from_msg(m)))
                      if on_done else None,
                      on_expired, trace_span=span)
        self._send_request(req)
        self.out_stats.find += 1
        self._count_msg("out", "find")
        return req

    def send_get_values(self, node: Node, info_hash: InfoHash, query: Query,
                        want: int = -1, on_done=None, on_expired=None) -> Request:
        tid = node.get_new_tid()
        body: dict = {"id": bytes(self.myid), "h": bytes(info_hash)}
        if not query.where.empty() or not query.select.empty():
            body["q"] = query.wire_obj()
        if want > 0:
            body["w"] = self._want_list(want)
        span, tctx = self._trace_client("get", node)
        data = self._header("a", body, "q", tid, query="get", trace=tctx)
        req = Request(MessageType.GET_VALUES, tid, node, data,
                      (lambda r, m: on_done(r, RequestAnswer.from_msg(m)))
                      if on_done else None,
                      on_expired, trace_span=span)
        self._send_request(req)
        self.out_stats.get += 1
        self._count_msg("out", "get")
        return req

    def send_listen(self, node: Node, info_hash: InfoHash, query: Query,
                    token: bytes, previous: Optional[Request],
                    on_done=None, on_expired=None,
                    socket_cb: Optional[SocketCb] = None) -> Optional[Request]:
        """(network_engine.cpp:1053-1117): reuse the previous contract's
        push socket on refresh, else open a fresh one."""
        if previous is not None and previous.node is node:
            sid = previous.socket_id
        else:
            sid = node.open_socket(socket_cb) if socket_cb else 0
        if not sid:
            return None
        tid = node.get_new_tid()
        body: dict = {"id": bytes(self.myid), "h": bytes(info_hash),
                      "token": token, "sid": pack_tid(sid)}
        if not query.where.empty() or not query.select.empty():
            body["q"] = query.wire_obj()
        span, tctx = self._trace_client("listen", node)
        data = self._header("a", body, "q", tid, query="listen", trace=tctx)
        req = Request(MessageType.LISTEN, tid, node, data,
                      (lambda r, m: on_done(r, RequestAnswer.from_msg(m)))
                      if on_done else None,
                      on_expired, socket_id=sid, trace_span=span)
        self._send_request(req)
        self.out_stats.listen += 1
        self._count_msg("out", "listen")
        return req

    def send_announce_value(self, node: Node, info_hash: InfoHash, value: Value,
                            created: Optional[float], token: bytes,
                            on_done=None, on_expired=None) -> Request:
        tid = node.get_new_tid()
        values_wire, parts = self._pack_values([value])
        body: dict = {"id": bytes(self.myid), "h": bytes(info_hash),
                      "values": values_wire}
        if created is not None and created < wall_now():
            body["c"] = int(created)
        body["token"] = token
        span, tctx = self._trace_client("put", node)
        data = self._header("a", body, "q", tid, query="put", trace=tctx)

        def done(r, m: ParsedMessage):
            if m.value_id != Value.INVALID_ID and on_done:
                on_done(r, RequestAnswer(vid=m.value_id))

        req = Request(MessageType.ANNOUNCE_VALUE, tid, node, data,
                      done if on_done else None, on_expired,
                      trace_span=span)
        self._send_request(req)
        if parts:
            self._send_value_parts(tid, parts, node.addr)
        self.out_stats.put += 1
        self._count_msg("out", "put")
        return req

    def send_refresh_value(self, node: Node, info_hash: InfoHash, vid: int,
                           token: bytes, on_done=None, on_expired=None) -> Request:
        tid = node.get_new_tid()
        body = {"id": bytes(self.myid), "h": bytes(info_hash), "vid": vid,
                "token": token}
        span, tctx = self._trace_client("refresh", node)
        data = self._header("a", body, "q", tid, query="refresh", trace=tctx)

        def done(r, m: ParsedMessage):
            if m.value_id != Value.INVALID_ID and on_done:
                on_done(r, RequestAnswer(vid=m.value_id))

        req = Request(MessageType.REFRESH, tid, node, data,
                      done if on_done else None, on_expired,
                      trace_span=span)
        self._send_request(req)
        self.out_stats.refresh += 1
        self._count_msg("out", "refresh")
        return req

    # ------------------------------------------------------------ tx: replies
    def send_pong(self, addr: SockAddr, tid: int) -> None:
        body = {"id": bytes(self.myid), "sa": addr.ip.packed}
        self._send(self._header("r", body, "r", tid), addr)

    def send_listen_confirmation(self, addr: SockAddr, tid: int) -> None:
        self.send_pong(addr, tid)

    def send_value_announced(self, addr: SockAddr, tid: int, vid: int) -> None:
        body = {"id": bytes(self.myid), "vid": vid, "sa": addr.ip.packed}
        self._send(self._header("r", body, "r", tid), addr)

    def send_nodes_values(self, addr: SockAddr, tid: int, nodes4: bytes,
                          nodes6: bytes, values: List[Value], query: Query,
                          token: bytes) -> None:
        """(network_engine.cpp:944-1000)"""
        body: dict = {"id": bytes(self.myid), "sa": addr.ip.packed}
        if nodes4:
            body["n4"] = nodes4
        if nodes6:
            body["n6"] = nodes6
        if token:
            body["token"] = token
        parts: List[bytes] = []
        if values:
            fields = query.select.get_selection()
            if not fields:
                body["values"], parts = self._pack_values(values)
            else:
                flat: list = []
                for v in values:
                    flat.extend(v.pack_fields(fields))
                body["fields"] = {"f": [int(f) for f in fields], "v": flat}
        self._send(self._header("r", body, "r", tid), addr)
        if parts:
            self._send_value_parts(tid, parts, addr)

    def send_error(self, addr: SockAddr, tid: int, code: int, message: str,
                   include_id: bool = False) -> None:
        out: dict = {"e": [code, message]}
        if include_id:
            out["r"] = {"id": bytes(self.myid)}
        out["t"] = pack_tid(tid)
        out["y"] = "e"
        out["v"] = AGENT
        if self.network:
            out["n"] = self.network
        self._send(pack_msg(out), addr)

    # ------------------------------------------------- listen push channel
    def tell_listener(self, node: Node, socket_id: int, info_hash: InfoHash,
                      want: int, ntoken: bytes, nodes4: List[Node],
                      nodes6: List[Node], values: List[Value],
                      query: Query) -> None:
        """Push changed values over the peer's listen socket
        (network_engine.cpp:173-185)."""
        n4, n6 = self.buffer_nodes(node.family, info_hash, want, nodes4, nodes6)
        self.send_nodes_values(node.addr, socket_id, n4, n6, values, query,
                               ntoken)

    def _tell_listener_ids(self, node: Node, socket_id: int, token: bytes,
                           vids: List[int], key: str) -> None:
        body: dict = {"id": bytes(self.myid)}
        if token:
            body["token"] = token
        if vids:
            body[key] = vids
        # the u-channel packs 't' as a plain msgpack uint — the ONE
        # departure from the bin4 TransId every other message uses
        # (tellListenerRefreshed/Expired pack the Tid integer directly,
        # network_engine.cpp:206,236; both sides' parsers accept both
        # forms, parsed_message.h:29-36, but byte-compat means emitting
        # what the reference emits)
        out: dict = {"u": body, "t": int(socket_id), "y": "r", "v": AGENT}
        if self.network:
            out["n"] = self.network
        self._send(pack_msg(out), node.addr)

    def tell_listener_refreshed(self, node: Node, socket_id: int,
                                info_hash: InfoHash, token: bytes,
                                vids: List[int]) -> None:
        self._tell_listener_ids(node, socket_id, token, vids, "re")

    def tell_listener_expired(self, node: Node, socket_id: int,
                              info_hash: InfoHash, token: bytes,
                              vids: List[int]) -> None:
        self._tell_listener_ids(node, socket_id, token, vids, "exp")

    # ------------------------------------------------------- fragmentation
    def _pack_values(self, values: List[Value]) -> Tuple[list, List[bytes]]:
        """Pack a value set for the 'values' wire array: inline wire
        objects when everything fits one packet, else integer sizes + the
        serialized blobs to stream as parts (network_engine.cpp:889-911)."""
        svals = [v.get_packed() for v in values]
        total = sum(len(b) for b in svals)
        if len(svals) < 50 and total < MAX_PACKET_VALUE_SIZE:
            return [v.wire_obj() for v in values], []
        return [len(b) for b in svals], svals

    def _send_value_parts(self, tid: int, svals: List[bytes],
                          addr: SockAddr) -> None:
        """Stream serialized values as MTU-sized ValueData packets
        (network_engine.cpp:913-941)."""
        for i, blob in enumerate(svals):
            start = 0
            while True:
                end = min(start + MTU, len(blob))
                out: dict = {}
                if self.network:
                    out["n"] = self.network
                out["y"] = "v"
                out["t"] = pack_tid(tid)
                out["p"] = {i: {"o": start, "d": blob[start:end]}}
                self._send(pack_msg(out), addr)
                start = end
                if start >= len(blob):
                    break
