"""In-process virtual UDP network for driving whole Dht nodes.

The tier-3 analogue of the reference's netns cluster harness
(python/tools/dht/network.py, virtual_network_builder.py) with no real
sockets: every node's injected ``send_fn`` enqueues datagrams on a
shared event queue, a virtual clock advances to the next packet arrival
or scheduler wakeup, and delivery calls the destination's
``periodic(data, from_addr)``.  Deterministic, immune to wall-clock
flakiness, and able to jump hours of protocol time (token rotation,
value expiry) in milliseconds.  Optional per-packet loss and delay play
the role of netem (benchmark.py -l/-d).

The port's copy of the JAX package's ``testing/virtual_net.py`` over the
port's ``Dht``, chaos plane and scheduler, behaviour unchanged.  The
device is explicit: ``VirtualNet(device=None)`` puts every node's tables
on the CUDA card (raising without one); tests pass ``device="cpu"``.
"""

from __future__ import annotations

import heapq
import itertools
import random
from typing import Callable, Dict, List, Optional

from .._device import resolve_device
from ..chaos import FaultInjector, FaultPlan, LinkRule, Phase
from ..runtime import Config, Dht
from ..scheduler import Scheduler
from ..sockaddr import SockAddr
from ..utils import TIME_MAX

#: held-back duplicate copies arrive this far after the original so the
#: two deliveries are distinct events, like real dup-on-retransmit
DUP_GAP = 1e-4


class VirtualNet:
    def __init__(self, *, delay: float = 0.01, jitter: float = 0.0,
                 loss: float = 0.0, seed: int = 42,
                 plan: Optional[FaultPlan] = None, device=None):
        #: where every node's tables live (None = the CUDA card)
        self.device = resolve_device(device)
        self.clock = 0.0
        self.delay = delay
        self.jitter = jitter
        self.loss = loss
        self.rng = random.Random(seed)
        self.nodes: Dict[tuple, Dht] = {}
        self._queue: list = []          # (arrival, seq, data, src, dst_key)
        self._seq = itertools.count()
        self._next_port = 20000
        self.dropped = 0
        #: drop accounting split per netem rule: the legacy uniform
        #: loss counts under "uniform"; FaultPlan rules/partitions
        #: under their own names
        self.dropped_by_rule: Dict[str, int] = {}
        # adversarial chaos plane: an armed FaultInjector is
        # consulted on every send BEFORE the uniform netem — per-link
        # asymmetric loss/dup/reorder/partitions ride the one seam the
        # real-UDP harness and the live engine share.
        self.injector: Optional[FaultInjector] = None
        if plan is not None:
            self.arm(plan)
        # lazy min-heap over per-node next-job times: O(log N) per event
        # instead of scanning every scheduler per event (the O(N·events)
        # scan capped clusters at a few hundred nodes; hop-parity needs
        # 2K-8K).  Entries (t, key) are stale unless _ntimes[key] == t.
        self._ntimes: Dict[tuple, float] = {}
        self._sheap: list = []

    # --------------------------------------------------------- chaos plane
    def arm(self, plan: FaultPlan) -> FaultInjector:
        """Arm a FaultPlan at the current virtual time; phase windows
        are relative to now.  Partitions heal when their phase ends."""
        self.injector = FaultInjector(plan)
        self.injector.arm(self.clock)
        return self.injector

    def disarm(self) -> None:
        self.injector = None

    def add_link_rule(self, rule: LinkRule,
                      membership: Optional[Dict[tuple, str]] = None) -> None:
        """Static (always-on) per-link netem without writing a plan —
        the -l/-d uniform knobs generalized to asymmetric per-link
        loss/dup/reorder/delay."""
        if self.injector is None:
            self.arm(FaultPlan([Phase("netem")], membership=membership))
        elif membership:
            self.injector.plan.membership.update(membership)
        for ph in self.injector.plan.phases:
            if ph.name == "netem" and ph.duration is None:
                ph.rules.append(rule)
                return
        self.injector.plan.phases.append(Phase("netem", rules=[rule]))

    def set_group(self, dht: Dht, group: str) -> None:
        """Assign a node to a plan group (partitions/link rules match
        on groups)."""
        if self.injector is None:
            self.arm(FaultPlan([]))
        key = (dht.bound_addr.host, dht.bound_addr.port)
        self.injector.plan.membership[key] = group

    def _drop(self, rule: str) -> None:
        self.dropped += 1
        self.dropped_by_rule[rule] = self.dropped_by_rule.get(rule, 0) + 1

    def _enqueue(self, arrival: float, data: bytes, src, dst_key) -> None:
        heapq.heappush(self._queue,
                       (arrival, next(self._seq), data, src, dst_key))

    # ------------------------------------------------------------- topology
    def add_node(self, config: Optional[Config] = None,
                 host: str = "127.0.0.1", port: Optional[int] = None) -> Dht:
        if port is None:
            port = self._next_port
            self._next_port += 1
        addr = SockAddr(host, port)
        key = (addr.host, addr.port)

        def send_fn(data: bytes, dest: SockAddr, _src=addr) -> int:
            src_key = (_src.host, _src.port)
            dst_key = (dest.host, dest.port)
            extra = 0.0
            copies = 1
            inj = self.injector
            if inj is not None and inj.armed:
                fate = inj.fate(src_key, dst_key, self.clock)
                if fate.drop:
                    self._drop(fate.rule or "chaos")
                    return 0
                extra = fate.delay
                copies += fate.dup
            arrival = self.clock + self.delay + extra + \
                (self.rng.random() * self.jitter if self.jitter else 0.0)
            # netem order: duplication happens in the network, then
            # each copy is independently subject to the uniform loss;
            # copies trail THEIR original's (jittered) arrival so a
            # dup can never overtake it
            for i in range(copies):
                if self.loss and self.rng.random() < self.loss:
                    self._drop("uniform")
                    continue
                self._enqueue(arrival + i * DUP_GAP, data, _src, dst_key)
            return 0

        dht = Dht(send_fn, config, Scheduler(clock=lambda: self.clock),
                  has_v6=False, device=self.device)
        dht.bound_addr = addr
        self.nodes[key] = dht
        return dht

    def bootstrap_node(self, dht: Dht, seed_node: Dht) -> None:
        """Point one node at the seed and ping it (↔ the runner's
        bootstrap thread, reference src/dhtrunner.cpp:819-875)."""
        dht.insert_node(seed_node.myid, seed_node.bound_addr)
        dht.ping_node(seed_node.bound_addr)

    def remove_node(self, dht: Dht) -> None:
        """Kill a node: it stops receiving and its scheduler stops running
        (↔ DhtNetworkSubProcess node shutdown, reference
        python/tools/dht/network.py:377-436)."""
        key = (dht.bound_addr.host, dht.bound_addr.port)
        self.nodes.pop(key, None)
        # drop the cached wakeup too: a later add_node on the same
        # (host, port) with an equal next_job_time would otherwise be
        # skipped by _refresh's equality check and never run
        self._ntimes.pop(key, None)

    def replace_cluster(self, count: int, seed_node: Dht,
                        config: Optional[Config] = None) -> List[Dht]:
        """Kill ``count`` random nodes (never the seed) and start as many
        fresh ones bootstrapped at the seed (↔ the reference's cluster
        replacement during PerformanceTest rounds, dht/tests.py:905-910)."""
        candidates = [d for d in self.nodes.values() if d is not seed_node]
        victims = self.rng.sample(candidates, min(count, len(candidates)))
        for v in victims:
            self.remove_node(v)
        fresh = []
        for _ in victims:
            d = self.add_node(config)
            self.bootstrap_node(d, seed_node)
            fresh.append(d)
        return fresh

    def step_storm(self, storm, seed_node: Dht,
                   config: Optional[Config] = None) -> tuple:
        """Apply one join/leave storm step from a :class:`~opendht_tpu_torch.
        chaos.Storm`: every non-seed node leaves with ``leave_rate``,
        and ``join_rate`` × current-size fresh nodes bootstrap at the
        seed.  Returns (left, joined) counts; deterministic under the
        net's seed."""
        victims = [d for d in list(self.nodes.values())
                   if d is not seed_node
                   and self.rng.random() < storm.leave_rate]
        for v in victims:
            self.remove_node(v)
        joins = 0
        target = int(storm.join_rate * max(len(self.nodes), 1))
        for _ in range(target):
            d = self.add_node(config)
            self.bootstrap_node(d, seed_node)
            joins += 1
        return len(victims), joins

    def storers_of(self, key) -> List[Dht]:
        """Nodes currently holding values for ``key`` locally."""
        return [d for d in self.nodes.values() if d.get_local(key)]

    def seed_converged(self, *, k: int = 8, quiesce: bool = True,
                       seed: int = 0) -> None:
        """Install a CONVERGED Kademlia routing table in every node
        directly — up to ``k`` random peers per common-prefix bucket —
        instead of hundreds of virtual seconds of bootstrap chatter.

        A converged network's steady state is exactly "≤ k live peers
        in every occupied cb(self, ·) bucket" (the admission rule of
        reference src/routing_table.cpp:204-262), so building it by
        construction changes nothing the protocol tests observe except
        the cost: the 8192-node hop-parity point drops from ~90 min of
        event processing (the RUN_XL_CLUSTER gate) to the cost
        of one vectorized O(N²)-byte common-prefix pass + bulk loads.

        ``quiesce`` pushes every node's confirm-nodes maintenance an
        hour out so a seeded cluster stays silent until the test drives
        traffic (observer lookups complete in ~1 virtual second; the
        N-node self-search storm at +3-5 s would otherwise dominate the
        run for zero reply-quality gain at that horizon).
        """
        import numpy as np
        import socket as _socket
        items = [d for d in self.nodes.values()
                 if _socket.AF_INET in d.tables]
        n = len(items)
        if n < 2:
            return
        from ..ops import ids as IK
        rng = np.random.default_rng(seed)
        ids_bytes = np.stack([
            np.frombuffer(bytes(d.myid), dtype=np.uint8) for d in items])
        ids_u32 = IK.ids_from_bytes(ids_bytes)      # canonical limb packing
        addrs = [d.bound_addr for d in items]
        clz8 = 8 - np.array([int(v).bit_length() for v in range(256)],
                            dtype=np.int16)
        now = self.clock
        for i, d in enumerate(items):
            x = ids_bytes ^ ids_bytes[i]                     # [n, 20]
            nzmask = x != 0
            first = np.argmax(nzmask, axis=1)
            anynz = nzmask.any(axis=1)
            cb = np.where(anynz,
                          8 * first + clz8[x[np.arange(n), first]],
                          160).astype(np.int16)
            # per-bucket pick of ≤ k peers, uniformly random via a
            # shuffle + stable sort; self (cb=160) excluded by mask
            perm = rng.permutation(n)
            cbp = cb[perm]
            order = np.argsort(cbp, kind="stable")
            cbs = cbp[order]
            rank = np.arange(n) - np.searchsorted(cbs, cbs, side="left")
            takes = order[(rank < k) & (cbs < 160)]
            sel = perm[takes]
            d.tables[_socket.AF_INET].bulk_load(
                ids_u32[sel], now, replied=True,
                addrs=[addrs[j] for j in sel],
                buckets=cb[sel])
            if quiesce and d._next_nodes_confirmation is not None:
                d._next_nodes_confirmation = d.scheduler.edit(
                    d._next_nodes_confirmation, now + 3600.0)
        for key in self.nodes:
            self._refresh(key)

    def bootstrap_all(self, seed_node: Dht) -> None:
        """Point every other node at the seed and ping it (↔ the runner's
        bootstrap thread, reference src/dhtrunner.cpp:819-875)."""
        for dht in self.nodes.values():
            if dht is not seed_node:
                self.bootstrap_node(dht, seed_node)

    # ------------------------------------------------------------ event loop
    def _refresh(self, key) -> None:
        """Re-cache one node's next scheduler wakeup in the lazy heap."""
        dht = self.nodes.get(key)
        if dht is None:
            self._ntimes.pop(key, None)
            return
        t = dht.scheduler.next_job_time()
        if self._ntimes.get(key) != t:
            self._ntimes[key] = t
            if t < TIME_MAX:
                heapq.heappush(self._sheap, (t, key))

    def _peek_sched(self) -> float:
        while self._sheap:
            t, key = self._sheap[0]
            if key in self.nodes and self._ntimes.get(key) == t:
                return t
            heapq.heappop(self._sheap)          # stale
        return TIME_MAX

    def _next_event_time(self) -> float:
        t = self._queue[0][0] if self._queue else TIME_MAX
        return min(t, self._peek_sched())

    def run(self, max_time: float = 30.0,
            until: Optional[Callable[[], bool]] = None,
            max_events: int = 5_000_000, check_every: int = 32) -> bool:
        """Advance virtual time; returns True as soon as `until()` holds.

        ``until`` is evaluated every ``check_every`` events (it is often
        an O(N) sweep like all_connected — per-event evaluation made big
        clusters quadratic).  Each run() entry re-syncs every node's
        cached wakeup once, so jobs scheduled by direct test calls
        between runs (obs.get(...), bootstrap) are picked up.
        """
        deadline = self.clock + max_time
        for key in self.nodes:
            self._refresh(key)
        for i in range(max_events):
            if until is not None and i % check_every == 0 and until():
                return True
            t = self._next_event_time()
            if t > deadline:
                self.clock = deadline
                break
            self.clock = max(self.clock, t)
            touched = set()
            # deliver all packets due now
            while self._queue and self._queue[0][0] <= self.clock:
                _, _, data, src, dst_key = heapq.heappop(self._queue)
                dst = self.nodes.get(dst_key)
                if dst is not None:
                    dst.periodic(data, src)
                    touched.add(dst_key)
            # run due scheduler jobs (each due node once, via the heap)
            while True:
                ts = self._peek_sched()
                if ts > self.clock:
                    break
                _, key = heapq.heappop(self._sheap)
                self._ntimes.pop(key, None)
                dht = self.nodes.get(key)
                if dht is not None:
                    dht.periodic(None, None)
                    touched.add(key)
            for key in touched:
                self._refresh(key)
        return until() if until is not None else False

    def settle(self, seconds: float) -> None:
        """Run with no exit condition for `seconds` of virtual time."""
        self.run(max_time=seconds, until=None)

    # ------------------------------------------------------------- helpers
    def connected_count(self) -> int:
        from ..runtime import NodeStatus
        return sum(1 for d in self.nodes.values()
                   if d.get_status() is NodeStatus.CONNECTED)

    def all_connected(self) -> bool:
        return self.connected_count() == len(self.nodes)
