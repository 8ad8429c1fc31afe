"""Live per-target search state (reference src/search.h).

A copy of the JAX package's ``runtime/live_search.py`` with its behaviour unchanged.

This is the *protocol* half of the lookup engine: per-node write tokens,
get/listen/announce request tracking, α-throttling and the k=8 sync
rule, driven over the real network by :class:`~.dht.Dht`.  The *math*
half — which candidates are closest — comes from the TPU node table
(``core/table.py``); the batched offline simulator lives in
``core/search.py``.

Semantics mirror the reference exactly: a search keeps ≤ SEARCH_NODES
candidates sorted by XOR distance to the target (``Search::insertNode``,
src/search.h:636-722); it is *synced* when the first TARGET_NODES good
candidates hold fresh tokens (src/search.h:734-747); gets complete when
those nodes have answered (src/search.h:767-780); announces/listens are
sent only to synced nodes and refreshed before expiry
(src/search.h:325-347).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, TYPE_CHECKING

from ..infohash import InfoHash
from ..core.op_cache import SearchCache
from ..core.value import Filter, Query, Value
from ..core.value_cache import ValueCache
from ..net.node import NODE_EXPIRE_TIME, Node
from ..net.request import Request
from ..scheduler import Job, Scheduler
from ..utils import TIME_MAX

if TYPE_CHECKING:
    from ..core.value import TypeStore

_NEVER = float("-inf")

# protocol constants (reference dht.h:305-342)
SEARCH_NODES = 14                    # candidate set size (dht.h:308)
MAX_REQUESTED_SEARCH_NODES = 4       # α in-flight gets (dht.h:321)
LISTEN_NODES = 4                     # listen replication (dht.h:324)
TARGET_NODES = 8                     # k convergence/replication (routing_table.h:26)
SEARCH_MAX_BAD_NODES = 25            # ⇒ connectivity change (dht.h:310-318)
SEARCH_EXPIRE_TIME = 62 * 60.0       # idle search GC (dht.h:332)
LISTEN_EXPIRE_TIME = 30.0            # remote listener lifetime (dht.h:338)
REANNOUNCE_MARGIN = 10.0             # refresh this early (dht.h:340)


def acked_request(now: float) -> Request:
    """Synthetic completed request: marks a value as already announced
    without a wire round-trip (reference dht.cpp:573-577)."""
    from ..net.request import RequestState
    req = Request(None, 0, None, b"", None, None)
    req.state = RequestState.COMPLETED
    req.reply_time = now
    return req


def cancelled_request() -> Request:
    """Dummy request standing for 'this get is already satisfied'
    (reference dht.cpp:222-230)."""
    from ..net.request import RequestState
    req = Request(None, 0, None, b"", None, None)
    req.state = RequestState.CANCELLED
    return req


@dataclass
class Get:
    """One pending 'get' op attached to a search (src/search.h:32-39)."""
    start: float
    filter: Optional[Filter]
    query: Query
    query_cb: Optional[Callable] = None
    get_cb: Optional[Callable] = None
    done_cb: Optional[Callable] = None


@dataclass
class Announce:
    """One pending 'put' op (src/search.h:44-49)."""
    permanent: bool
    value: Value
    created: float
    callback: Optional[Callable] = None


@dataclass
class SearchListener:
    """(src/search.h:381-382 SearchListener)"""
    query: Query
    filter: Optional[Filter]
    get_cb: Callable


class CachedListenStatus:
    """Listen contract with one node: push-socket request + value cache
    (src/search.h:64-73)."""

    __slots__ = ("cache", "cache_expiration_job", "req")

    def __init__(self, cb):
        self.cache = ValueCache(cb)
        self.cache_expiration_job: Optional[Job] = None
        self.req: Optional[Request] = None


class SearchNode:
    """Per-(search, node) protocol state (src/search.h:51-355)."""

    __slots__ = ("node", "probe_query", "pagination_queries", "get_status",
                 "listen_status", "acked", "token", "last_get_reply",
                 "candidate", "sync_job", "depth")

    def __init__(self, node: Node):
        self.node = node
        # discovery generation within this search: 0 = seeded from the
        # local table/bootstrap, d+1 = learned from a depth-d node's
        # reply.  Drives the protocol-level hop metric (Search.
        # current_hops) validated against core/search.py's simulator.
        self.depth = 0
        self.probe_query: Optional[Query] = None
        # get query → sub-queries substituting it (pagination)
        self.pagination_queries: Dict[Query, List[Query]] = {}
        self.get_status: Dict[Query, Request] = {}
        self.listen_status: Dict[Query, CachedListenStatus] = {}
        # value id → (announce/refresh request, next refresh time)
        self.acked: Dict[int, tuple] = {}
        self.token = b""
        self.last_get_reply = _NEVER
        self.candidate = False
        self.sync_job: Optional[Job] = None

    # -- sync ---------------------------------------------------------------
    def is_synced(self, now: float) -> bool:
        """Fresh token ⇒ can listen/announce (src/search.h:112-115)."""
        return (not self.node.expired and bool(self.token)
                and self.last_get_reply >= now - NODE_EXPIRE_TIME)

    def get_sync_time(self, now: float) -> float:
        if self.node.expired or not self.token:
            return now
        return self.last_get_reply + NODE_EXPIRE_TIME

    def can_get(self, now: float, update: float, q: Optional[Query]) -> bool:
        """Whether a 'get'(q) should be sent to this node now
        (src/search.h:139-161)."""
        if self.node.expired:
            return False
        pending = False
        completed_sq = False
        pending_sq = False
        for sq, req in self.get_status.items():
            if req is not None and req.pending:
                pending = True
            if q is not None and req is not None and q.is_satisfied_by(sq):
                if req.pending:
                    pending_sq = True
                elif req.completed and not update > req.reply_time:
                    completed_sq = True
        return (not pending and now > self.last_get_reply + NODE_EXPIRE_TIME) or \
            not (completed_sq or pending_sq or self.has_started_pagination(q))

    def has_started_pagination(self, q: Optional[Query]) -> bool:
        """(src/search.h:169-180)"""
        pqs = self.pagination_queries.get(q)
        if not pqs:
            return False
        return any(pq in self.get_status for pq in pqs)

    def is_done(self, get: Get) -> bool:
        """Node finished answering this get (incl. all pagination
        sub-requests) (src/search.h:193-211)."""
        if self.has_started_pagination(get.query):
            return not any(
                (req := self.get_status.get(pq)) is not None and req.pending
                for pq in self.pagination_queries.get(get.query, ()))
        req = self.get_status.get(get.query)
        return req is not None and not req.pending

    def cancel_get(self) -> None:
        for req in self.get_status.values():
            if req.pending:
                self.node.cancel_request(req)
        self.get_status.clear()

    # -- listen -------------------------------------------------------------
    def on_values(self, q: Query, answer, types: "TypeStore",
                  scheduler: Scheduler) -> None:
        """Feed pushed/polled values into the per-query cache
        (src/search.h:216-226)."""
        ls = self.listen_status.get(q)
        if ls is not None:
            nxt = ls.cache.on_values(answer.values, answer.refreshed_values,
                                     answer.expired_values, types,
                                     scheduler.time())
            ls.cache_expiration_job = scheduler.edit(
                ls.cache_expiration_job, nxt)

    def expire_values(self, q: Query, scheduler: Scheduler) -> None:
        ls = self.listen_status.get(q)
        if ls is not None:
            nxt = ls.cache.expire_values(scheduler.time())
            ls.cache_expiration_job = scheduler.edit(
                ls.cache_expiration_job, nxt)

    def is_listening(self, now: float, q: Optional[Query] = None) -> bool:
        """(src/search.h:296-311)"""
        statuses = ([self.listen_status[q]] if q is not None
                    and q in self.listen_status
                    else ([] if q is not None
                          else list(self.listen_status.values())))
        return any(ls.req is not None
                   and ls.req.reply_time + LISTEN_EXPIRE_TIME > now
                   for ls in statuses)

    def cancel_listen(self, q: Optional[Query] = None) -> None:
        if q is None:
            for ls in self.listen_status.values():
                self.node.cancel_request(ls.req)
                if ls.cache_expiration_job:
                    ls.cache_expiration_job.cancel()
            self.listen_status.clear()
        else:
            ls = self.listen_status.pop(q, None)
            if ls is not None:
                self.node.cancel_request(ls.req)
                if ls.cache_expiration_job:
                    ls.cache_expiration_job.cancel()

    def get_listen_time(self, q: Query) -> float:
        """When the listen(q) contract must be refreshed
        (src/search.h:341-347)."""
        ls = self.listen_status.get(q)
        if ls is None or ls.req is None:
            return _NEVER
        if ls.req.pending:
            return TIME_MAX
        return ls.req.reply_time + LISTEN_EXPIRE_TIME - REANNOUNCE_MARGIN

    # -- announce -----------------------------------------------------------
    def is_announced(self, vid: int) -> bool:
        ack = self.acked.get(vid)
        return ack is not None and ack[0] is not None and ack[0].completed

    def cancel_announce(self) -> None:
        for req, _ in self.acked.values():
            if req is not None and req.pending:
                self.node.cancel_request(req)
        self.acked.clear()

    def get_announce_time(self, vid: int) -> float:
        """When a put(vid) should go out, assuming synced
        (src/search.h:325-337)."""
        ack = self.acked.get(vid)
        probe = (self.get_status.get(self.probe_query)
                 if self.probe_query is not None else None)
        ack_req = ack[0] if ack is not None else None
        if ack_req is None and (probe is None or not probe.pending):
            return _NEVER
        if (probe is not None and probe.pending) or ack_req is None \
                or ack_req.pending:
            return TIME_MAX
        return ack[1] - REANNOUNCE_MARGIN if ack_req.completed else _NEVER

    # -- health -------------------------------------------------------------
    def pending_get(self) -> bool:
        return any(r is not None and r.pending
                   for r in self.get_status.values())

    def is_bad(self) -> bool:
        """(src/search.h:350-352)"""
        return self.node is None or self.node.expired or self.candidate


class Search:
    """One target's candidate set + attached ops (src/search.h:361-630)."""

    def __init__(self, target: InfoHash, family: int, tid: int = 0,
                 clock: Optional[Callable[[], float]] = None):
        self.id = target
        self.af = family
        self.tid = tid
        self.refill_time = _NEVER
        #: a coalesced refill is riding the ingest wave builder (round
        #: 12): dedupes duplicate submissions and holds off the
        #: consecutive-bad-nodes expiry until the wave lands
        self.refill_pending = False
        self.step_time = _NEVER
        self.next_search_step: Optional[Job] = None
        # the trace context of the op that (re)started this
        # search — scheduler-driven steps re-activate it so every hop's
        # RPC parents under the originating get/put/listen span (a
        # reused search adopts the newest op's context, traced or not:
        # an untraced op must clear a predecessor's finished trace)
        self.trace_ctx = None
        self.expired = False
        self.done = False
        #: candidate-set bound: SEARCH_NODES normally; the
        #: announce path widens it for keys in the hot set so a
        #: closest-16 replica walk has candidates to walk (narrowed
        #: back on decay — Dht._search_send_announce re-evaluates it)
        self.capacity = SEARCH_NODES
        self.nodes: List[SearchNode] = []
        self.announce: List[Announce] = []
        self.callbacks: List[Get] = []           # kept in start-time order
        self.listeners: Dict[int, SearchListener] = {}
        self.listener_token = 1
        # clock keeps the op-dedup linger anchored to dispatch-time
        # removals (see OpCache._dispatch)
        self.cache = SearchCache(clock=clock)
        self.op_expiration_job: Optional[Job] = None

    # -- candidate set ------------------------------------------------------
    def insert_node(self, node: Node, now: float, token: bytes = b"",
                    depth: Optional[int] = None) -> bool:
        """Sorted insert by XOR distance to target, trimming to
        SEARCH_NODES live candidates (src/search.h:636-722).  Returns True
        if the node is new to this search.

        ``depth`` is the discovery generation (see SearchNode.depth):
        None leaves an existing node untouched (new nodes default to 0);
        a value applies min-rule so re-discovery through a shorter chain
        lowers the recorded depth."""
        if node.family != self.af:
            return False

        # find the node, or the sorted insertion point
        idx = len(self.nodes)
        found = False
        while idx > 0:
            sn = self.nodes[idx - 1]
            if sn.node is node:
                idx -= 1
                found = True
                break
            if self.id.xor_cmp(node.id, sn.node.id) > 0:
                break
            idx -= 1

        new_node = False
        if not found:
            cap = self.capacity
            bad = 0
            if self.expired:
                full = len(self.nodes) >= cap
                trim_at = cap if full else len(self.nodes)
            else:
                bad = self.get_number_of_bad_nodes()
                full = len(self.nodes) - bad >= cap
                trim_at = len(self.nodes)
                while trim_at - bad > cap:
                    trim_at -= 1
                    if self.nodes[trim_at].is_bad():
                        bad -= 1
            if full:
                if trim_at < len(self.nodes):
                    del self.nodes[trim_at:]
                if idx >= trim_at:
                    return False
            if not self.nodes:
                self.step_time = _NEVER
            sn_new = SearchNode(node)
            if depth is not None:
                sn_new.depth = depth
            self.nodes.insert(idx, sn_new)
            new_node = True
            if node.expired:
                if not self.expired:
                    bad += 1
            elif self.expired:
                bad = len(self.nodes) - 1
                self.expired = False
            while len(self.nodes) - bad > cap:
                if not self.expired and self.nodes[-1].is_bad():
                    bad -= 1
                self.nodes.pop()

        if found and depth is not None and depth < self.nodes[idx].depth:
            self.nodes[idx].depth = depth
        if token:
            sn = self.nodes[idx]
            sn.candidate = False
            sn.last_get_reply = now
            if len(token) <= 64:
                sn.token = token
            self.expired = False
        if new_node:
            self.remove_expired_node(now)
        return new_node

    def get_node(self, node: Node) -> Optional[SearchNode]:
        for sn in self.nodes:
            if sn.node is node:
                return sn
        return None

    def get_nodes(self) -> List[Node]:
        return [sn.node for sn in self.nodes]

    def current_hops(self, k: int = TARGET_NODES) -> Optional[int]:
        """Protocol-level hop count: the deepest discovery generation
        among the first k candidates that have replied, i.e. how many
        sequential reply rounds separated the final converged set from
        the seeds.  Comparable to core/search.py simulate_lookups'
        ``hops`` output (its round counter equals this depth metric:
        a node merged in round r carries generation r).  None until at
        least one candidate replied."""
        depths = [sn.depth for sn in self.nodes[:k]
                  if sn.last_get_reply > _NEVER]
        return max(depths) if depths else None

    def remove_expired_node(self, now: float) -> bool:
        """(src/search.h:539-551)"""
        for i in range(len(self.nodes) - 1, -1, -1):
            if self.nodes[i].node.is_removable(now):
                del self.nodes[i]
                return True
        return False

    # -- health -------------------------------------------------------------
    def get_number_of_bad_nodes(self) -> int:
        return sum(1 for sn in self.nodes if sn.is_bad())

    def get_number_of_consecutive_bad_nodes(self) -> int:
        count = 0
        for sn in self.nodes:
            if not sn.is_bad():
                break
            count += 1
        return count

    def currently_solicited_node_count(self) -> int:
        return sum(1 for sn in self.nodes
                   if not sn.is_bad() and sn.pending_get())

    # -- state predicates ---------------------------------------------------
    def is_synced(self, now: float) -> bool:
        """First k live candidates hold fresh tokens
        (src/search.h:734-747)."""
        i = 0
        for sn in self.nodes:
            if sn.is_bad():
                continue
            if not sn.is_synced(now):
                return False
            i += 1
            if i == TARGET_NODES:
                break
        return i > 0

    def is_done(self, get: Get) -> bool:
        """(src/search.h:767-780)"""
        i = 0
        for sn in self.nodes:
            if sn.is_bad():
                continue
            if not sn.is_done(get):
                return False
            i += 1
            if i == TARGET_NODES:
                break
        return True

    def is_announced(self, vid: int) -> bool:
        """(src/search.h:782-797)"""
        if not self.nodes:
            return False
        i = 0
        for sn in self.nodes:
            if sn.is_bad():
                continue
            if not sn.is_announced(vid):
                return False
            i += 1
            if i == TARGET_NODES:
                return True
        return i > 0

    def is_listening(self, now: float) -> bool:
        """(src/search.h:799-820)"""
        if not self.nodes or not self.listeners:
            return False
        i = 0
        for sn in self.nodes:
            if sn.is_bad():
                continue
            if not sn.is_listening(now):
                return False
            i += 1
            if i == LISTEN_NODES:
                break
        return i > 0

    def get_last_get_time(self, q: Optional[Query] = None) -> float:
        last = _NEVER
        for g in self.callbacks:
            if q is None or q.is_satisfied_by(g.query):
                last = max(last, g.start)
        return last

    # -- completion ---------------------------------------------------------
    def set_get_done(self, get: Get) -> None:
        """One get op is over: drop its per-node request state and fire the
        done callback (src/search.h:448-461)."""
        for sn in self.nodes:
            for pq in sn.pagination_queries.get(get.query, ()):
                sn.get_status.pop(pq, None)
            sn.get_status.pop(get.query, None)
        if get.done_cb:
            get.done_cb(True, self.get_nodes())

    def set_done(self) -> None:
        """(src/search.h:467-475)"""
        for sn in self.nodes:
            sn.get_status.clear()
            sn.listen_status.clear()
            sn.acked.clear()
        self.done = True

    def get_next_step_time(self, now: float) -> float:
        """Earliest *future* time this search needs a step: announce and
        listen refreshes on the nodes that carry them.  Drives the
        step job's self-rescheduling so permanent puts and listens are
        refreshed before their remote expiry even on an otherwise idle
        node (the reference leaves this to ambient traffic —
        src/dht.cpp:651-653 commented out — which strands refreshes on
        quiet networks; newer upstream adds the same scheduling)."""
        if self.expired or self.done or not self.is_synced(now):
            return TIME_MAX
        nxt = TIME_MAX
        if self.announce:
            i = 0
            for sn in self.nodes:
                if sn.is_bad():
                    continue
                for a in self.announce:
                    t = sn.get_announce_time(a.value.id)
                    if now < t < nxt:
                        nxt = t
                if not sn.candidate:
                    i += 1
                    if i == TARGET_NODES:
                        break
        if self.listeners:
            i = 0
            for sn in self.nodes:
                if sn.is_bad():
                    continue
                for q in list(sn.listen_status):
                    t = sn.get_listen_time(q)
                    if now < t < nxt:
                        nxt = t
                if not sn.candidate:
                    i += 1
                    if i == LISTEN_NODES:
                        break
        return nxt

    def check_announced(self, vid: int = Value.INVALID_ID) -> None:
        """Fire callbacks of fully-announced values; drop non-permanent
        ones (src/search.h:592-619)."""
        kept: List[Announce] = []
        cleared_vids: List[int] = []
        for a in self.announce:
            if vid != Value.INVALID_ID and (a.value is None
                                            or a.value.id != vid):
                kept.append(a)
                continue
            if self.is_announced(a.value.id):
                if a.callback:
                    a.callback(True, self.get_nodes())
                    a.callback = None
                if not a.permanent:
                    cleared_vids.append(a.value.id)
                    continue
            kept.append(a)
        for cleared in cleared_vids:
            for sn in self.nodes:
                sn.acked.pop(cleared, None)
        self.announce = kept

    def expire(self) -> None:
        """All nodes gone/expired — likely connectivity change
        (src/search.h:557-590)."""
        self.expired = True
        self.nodes.clear()
        if not self.announce and not self.listeners:
            self.set_done()
        get_cbs, self.callbacks = self.callbacks, []
        for g in get_cbs:
            if g.done_cb:
                g.done_cb(False, [])
        a_cbs = []
        kept = []
        for a in self.announce:
            if a.callback:
                a_cbs.append(a.callback)
                a.callback = None
            if a.permanent:
                kept.append(a)
        self.announce = kept
        for cb in a_cbs:
            cb(False, [])

    def clear(self) -> None:
        self.announce.clear()
        self.callbacks.clear()
        self.listeners.clear()
        self.nodes.clear()
        if self.next_search_step:
            self.next_search_step.cancel()
            self.next_search_step = None

    def stop(self) -> None:
        """Destructor semantics (src/search.h:388-399)."""
        if self.op_expiration_job:
            self.op_expiration_job.cancel()
        for get in self.callbacks:
            if get.done_cb:
                get.done_cb(False, [])
                get.done_cb = None
        for put in self.announce:
            if put.callback:
                put.callback(False, [])
                put.callback = None
        for sn in self.nodes:
            sn.cancel_get()
            sn.cancel_listen()
            sn.cancel_announce()

    # -- listen attach ------------------------------------------------------
    def add_listener(self, get_cb, f: Optional[Filter], q: Query,
                     scheduler: Scheduler,
                     on_new: Callable[[], None]) -> int:
        """Register through the dedup cache (src/search.h:479-488)."""
        def attach(query: Query, vcb) -> int:
            self.done = False
            self.listener_token += 1
            token = self.listener_token
            self.listeners[token] = SearchListener(query, f, vcb)
            on_new()
            return token
        return self.cache.listen(get_cb, q, f, attach)

    def cancel_listen_token(self, token: int, scheduler: Scheduler) -> None:
        """(src/search.h:488-512)"""
        self.cache.cancel_listen(token, scheduler.time())

        def expire_ops():
            def on_cancel(t: int):
                sl = self.listeners.pop(t, None)
                for sn in self.nodes:
                    if not self.listeners:
                        sn.cancel_listen()
                    elif sl is not None:
                        sn.cancel_listen(sl.query)
            next_expire = self.cache.expire(scheduler.time(), on_cancel)
            self.op_expiration_job = scheduler.edit(
                self.op_expiration_job, next_expire)

        if self.op_expiration_job is None or self.op_expiration_job.cancelled:
            self.op_expiration_job = scheduler.add(TIME_MAX, expire_ops)
            # re-point the job body at itself for rescheduling
            self.op_expiration_job.func = expire_ops
        self.op_expiration_job = scheduler.edit(
            self.op_expiration_job, self.cache.get_expiration())
