"""The DHT node core (reference src/dht.cpp, include/opendht/dht.h).

Single-threaded and scheduler-driven like the reference: every behavior
is either a reaction to an incoming packet (``periodic``) or a scheduled
job.  Public ops (`get/put/listen/query`) attach work to per-target
:class:`~.live_search.Search` state machines; incoming RPCs are served
from the local value store and the routing table.

TPU-first redesign of the routing core: instead of scalar k-bucket
scans, both address families keep a :class:`~opendht_tpu.core.table.NodeTable`
— a numpy-backed peer slab whose closest-node queries run as batched XOR
top-k kernels on device snapshots (``find_closest_nodes`` accepts *many*
targets in one call, serving search refills, find-node replies and
announce distance checks from the same compiled kernel).  The per-packet
protocol state stays host-side where the reference keeps it; see
SURVEY.md §7's design mapping.

The port of the JAX package's ``runtime/dht.py``.  ``Dht`` takes
``device=`` (None = the CUDA card, raising without one), passed to each
family's :class:`~opendht_tpu_torch.core.table.NodeTable` and to the
node's planes; a table past ``HOST_SCAN_MAX_ROWS`` resolves through the
device snapshot (the ``window_select`` kernel) or, once it mutates, the
churn view.  The planes are the JAX node's, on by default: the keyspace
observatory (``keyspace.py``), the hot-value cache (``hotcache.py``,
with its adaptive replica set), the batched listener table
(``listeners.py``) and load-aware resharding (``reshard.py``, a tick
every 5 s on the node's scheduler).  With ``resolve_mesh_t >= 2`` the
snapshot resolve is row-sharded over a (q=1, t) ``parallel.Mesh``: on
the card it needs t CUDA cards (with fewer it logs a warning and serves
the identical unsharded path, as the JAX node does); a node on the CPU
runs up to :data:`CPU_VIRTUAL_DEVICES` virtual shards there, the JAX
tests' 8 host devices.  ``warmup`` lets a failure raise (see its
docstring) and, on the card, runs :func:`warm_device`.  Everything else
is the JAX module's behaviour, unchanged.
"""

from __future__ import annotations

import hashlib
import logging
import os
import random
import socket as _socket
from bisect import bisect_left, insort
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import telemetry, tracing
from .._device import resolve_device
from ..infohash import InfoHash
from ..ops import ids as IK
from ..sockaddr import SockAddr
from ..scheduler import Scheduler
from ..utils import TIME_MAX, WANT4, WANT6, wall_now
from ..core.storage import Storage, StorageBucket
from ..core.listener import Listener, LocalListener
from ..core.op_cache import OpValueCache
from ..core.table import NodeTable
from ..ops import _build
from ..core.value import (
    Field, FieldValueIndex, Filter, Filters, Query, Select, TypeStore, Value,
    Where, random_value_id,
)
from ..net.engine import (
    DhtProtocolException, EngineCallbacks, NetworkEngine, RequestAnswer,
)
from ..net.node import NODE_EXPIRE_TIME, MAX_RESPONSE_TIME, Node
from ..net.request import Request
from .config import Config, NodeStats, NodeStatus
from .live_search import (
    Announce, Get, LISTEN_NODES, MAX_REQUESTED_SEARCH_NODES, REANNOUNCE_MARGIN,
    SEARCH_EXPIRE_TIME, SEARCH_MAX_BAD_NODES, SEARCH_NODES, Search, SearchNode,
    TARGET_NODES, acked_request, cancelled_request,
)
from .wave_builder import WaveBuilder

log = logging.getLogger("opendht_tpu_torch.dht")


def warm_device(config: Config, device) -> None:
    """Run each device program of a node's periodic work once, on
    throwaway tensors of the shapes ``config`` gives a node: the
    keyspace sketch's update, query and decay, the hot cache's probe,
    the listener table's match and the routing table's maintenance
    sweep, each read back.  On the card this makes the process's CUDA
    context and loads the programs' kernels on the caller's thread.
    Left to a node's first wave or maintenance pass, that work held its
    protocol thread for seconds on a busy host, past the runner's 0.5 s
    queue limit, and the packets queued meanwhile were dropped.
    ``Dht.warmup`` runs it for a node on the card, and ``DhtRunner.run``
    before it starts the node's scheduler clock, so that the wait is
    not counted as its jobs' lag.  No node's state is touched.  The JAX
    node has no such step: its programs compile at first use."""
    import torch
    from ..hotcache import HotCacheConfig
    from ..keyspace import KeyspaceConfig
    from ..listeners import ListenerTableConfig
    from ..ops import radix
    from ..ops import sketch as sk
    from ..ops.cache_probe import cache_probe
    from ..ops.listener_match import listener_match
    dev = resolve_device(device)
    ids = IK.ids_from_hashes([InfoHash.get("warm-device")])
    ks = getattr(config, "keyspace", None) or KeyspaceConfig()
    if ks.enabled:
        sketch, hist = sk.sketch_init(ks.depth, ks.width, device=dev)
        sk.sketch_update(sketch, hist, ids)
        sk.sketch_query(sketch, ids).cpu()
        hist.cpu()
        sk.sketch_decay(sketch, hist, ks.decay)
    caps = ((getattr(config, "cache", None) or HotCacheConfig()).capacity,
            (getattr(config, "listeners", None)
             or ListenerTableConfig()).capacity)
    for rows, probe in zip(caps, (cache_probe, listener_match)):
        rows = max(1, int(rows))
        table = IK.to_keys(np.zeros((rows, IK.N_LIMBS), np.uint32), dev)
        valid = torch.ones(rows, dtype=torch.bool, device=dev)
        hit, slot = probe(table, valid, ids)
        hit.cpu(), slot.cpu()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    _counts, _last, stale, _targets = radix.maintenance_sweep(
        ids[0], np.repeat(ids, 8, axis=0), np.ones(8, bool),
        np.zeros(8, np.float64), 0.0, NODE_EXPIRE_TIME, gen, device=dev)
    stale.cpu()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

#: devices a node on the CPU offers its resolve mesh: t virtual shards on
#: the host, as the JAX package's tests run 8 virtual CPU devices
CPU_VIRTUAL_DEVICES = 8

_NEVER = float("-inf")

# (reference dht.h:305-357)
MAX_HASHES = 16384                   # stored keys cap (dht.h:327)
MAX_SEARCHES = 16384                 # concurrent searches cap (dht.h:330)
TOKEN_SIZE = 32                      # sha256 digest length (dht.h:342)
MAX_STORAGE_MAINTENANCE_EXPIRE_TIME = 10 * 60.0    # (dht.h:335)

#: storage-calendar quantum: per-key expiry/republish jobs
#: are binned to this many seconds and every bin shares ONE scheduler
#: heap entry, so K stored keys cost O(bins in flight) entries, not K.
#: Bins round UP, so no sweep ever fires before a key is due; the ≤10 s
#: lateness is noise against the 10-min expiry/republish horizons.
STORAGE_CALENDAR_QUANTUM = 10.0

#: the query standing for a token-only sync probe ('find_node' path)
_ANY_QUERY = Query(none=True)


def _traced_search(fn):
    """Re-activate the search's trace context around an RPC-sending
    method.  Search steps fire from scheduler jobs and reply
    callbacks, where the originating op's ambient context is long gone
    — the Search object carries it (live_search.Search.trace_ctx) and
    this wrapper restores it (including to None: a step of an untraced
    search must not inherit a foreign op's context), so the engine's
    ``send_*`` sites see the right parent for every hop."""
    def wrapper(self, sr, *args, **kw):
        with tracing.activate(sr.trace_ctx):
            return fn(self, sr, *args, **kw)
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def _quota_key(addr: SockAddr) -> tuple:
    """Per-IP quota bucket key (the reference keys StorageBucket by
    SockAddr with port zeroed, dht.h:374)."""
    return (addr.family, addr.ip.packed if addr.ip else b"")


class BatchedResolve:
    """Handle for an in-flight batched closest-NODE resolve (the wave
    pipeline's) — the Node-materializing layer over
    core/table.PendingLookup.  ``ready()`` probes without blocking;
    ``consume()`` blocks on the device result and builds the
    ``List[List[Node]]`` the synchronous entry point returns (it is
    idempotent: ``find_closest_nodes_batched = launch().consume()``).
    ``shard_t`` is the shard width of THIS launch, captured because the
    shared ``Dht.last_resolve_shard_t`` may belong to a newer
    overlapping wave by the time this one is consumed."""

    __slots__ = ("shard_t", "_pending", "_finalize", "_done", "_result")

    def __init__(self, finalize, pending=None, shard_t: int = 1):
        self._finalize = finalize
        self._pending = pending           # core PendingLookup or None
        self.shard_t = int(shard_t or 1)
        self._done = False
        self._result = None

    @classmethod
    def resolved(cls, result, shard_t: int = 1) -> "BatchedResolve":
        br = cls(None, shard_t=shard_t)
        br._done = True
        br._result = result
        return br

    def ready(self) -> bool:
        return self._done or self._pending is None or self._pending.ready()

    def consume(self) -> List[List[Node]]:
        if not self._done:
            self._result = self._finalize()
            self._done = True
            self._finalize = None
            self._pending = None
        return self._result


class Dht:
    """A complete DHT node behind an injected datagram transport.

    ``send_fn(data, addr) -> errno`` is the only way bytes leave;
    ``periodic(data, from_addr)`` is the only way bytes enter — exactly
    the reference's socket-fd boundary (dht.h:62-116), kept callable so
    the same core runs over a UDP socket or an in-process virtual
    network in tests.

    ``device``: where the routing tables' snapshots and device lookups
    live — None means the CUDA card and raises when there is none;
    tests pass ``device="cpu"``.
    """

    def __init__(self, send_fn: Callable[[bytes, SockAddr], int],
                 config: Optional[Config] = None,
                 scheduler: Optional[Scheduler] = None,
                 *, has_v4: bool = True, has_v6: bool = True, device=None):
        config = config or Config()
        self.config = config
        self.myid = config.node_id or InfoHash.get_random()
        self.is_bootstrap = config.is_bootstrap
        self.maintain_storage = config.maintain_storage
        # NB: an idle Scheduler is falsy (__len__ == 0) — test identity
        self.scheduler = scheduler if scheduler is not None else Scheduler()
        self.types = TypeStore()
        self._has = {_socket.AF_INET: has_v4, _socket.AF_INET6: has_v6}
        #: where the tables' device snapshots and the planes' device
        #: state live (None = the CUDA card, raising without one)
        self.device = resolve_device(device)

        self.engine = NetworkEngine(
            self.myid, config.network, send_fn, self.scheduler,
            EngineCallbacks(
                on_error=self._on_error,
                on_new_node=self._on_new_node,
                on_reported_addr=self._on_reported_addr,
                on_ping=self._on_ping,
                on_find_node=self._on_find_node,
                on_get_values=self._on_get_values,
                on_listen=self._on_listen,
                on_announce=self._on_announce,
                on_refresh=self._on_refresh,
            ),
            is_client=config.is_bootstrap,
            max_req_per_sec=config.max_req_per_sec)

        # device-backed routing tables, one per family (↔ buckets4/6,
        # dht.h:370-381)
        self.tables: Dict[int, NodeTable] = {
            af: NodeTable(self.myid, device=self.device)
            for af, on in self._has.items() if on}
        self.searches: Dict[int, Dict[InfoHash, Search]] = {
            af: {} for af in self.tables}
        # sorted key lists for trySearchInsert's bidirectional walk
        self._search_keys: Dict[int, List[bytes]] = {af: [] for af in self.tables}
        self._search_id = random.randint(1, 0xFFFF)
        #: (key, vid) → live local-refresh Job for permanent puts
        self._local_refresh_jobs: Dict[tuple, object] = {}

        # value store (↔ dht.h:372-377)
        self.store: Dict[InfoHash, Storage] = {}
        self.store_quota: Dict[tuple, StorageBucket] = {}
        self.total_store_size = 0
        self.total_values = 0
        self.max_store_size = config.storage_limit
        self.max_store_keys = MAX_HASHES

        # global listener registry: token → (local, v4, v6) sub-tokens
        self.listeners: Dict[int, Tuple[int, int, int]] = {}
        self._listener_token = 0

        self.reported_addr: List[Tuple[int, SockAddr]] = []
        self._pending_pings = {af: 0 for af in self.tables}
        self._table_grow_time = {af: _NEVER for af in self.tables}
        self.status_cb: Optional[Callable[[NodeStatus, NodeStatus], None]] = None
        self._last_status = {af: NodeStatus.DISCONNECTED for af in self.tables}
        self._status_checked: Dict[int, float] = {}
        self._status_recheck: Dict[int, object] = {}

        # storage calendar: bin id -> keys due at that bin;
        # one scheduler job per OCCUPIED bin replaces the per-key
        # _data_persistence/_expire_storage jobs (see _calendar_add)
        self._storage_calendar: Dict[int, set] = {}

        # continuous-batching ingest: live search refills
        # from EVERY traffic source coalesce into shared [Q] device
        # launches; new ops shed at admission under backpressure
        # (wave_builder.py; config.ingest_* knobs)
        self.wave_builder = WaveBuilder(self, config)

        # keyspace traffic observatory: device count-min sketch +
        # top-8-bit histogram over the wave target ids (one batched
        # scatter-add per ingest wave, fed by the wave builder) and
        # stored-key puts; heavy-hitter top-K + shard load-balance
        # attribution tick on this scheduler (shard_info: the live
        # resolve mesh's boundaries, else the uniform virtual split)
        from ..keyspace import KeyspaceObservatory
        self.keyspace = KeyspaceObservatory(
            getattr(config, "keyspace", None), node=str(self.myid),
            shard_info=self._keyspace_shard_info, device=self.device)
        self.keyspace.attach(self.scheduler)

        # hot-key serving cache: the acting half of the observe→act
        # loop — subscribes to the observatory tick, keeps a bounded
        # device table of the hot keys' ids (probed in one batched
        # XOR-compare before every ingest wave) + host value payloads,
        # and answers the adaptive replica-k question for the
        # announce/republish paths (hotcache.py; config.cache knobs)
        from ..hotcache import HotValueCache
        self.hotcache = HotValueCache(
            getattr(config, "cache", None), node=str(self.myid),
            local_values=lambda kb: self.get_local(InfoHash(kb)),
            clock=self.scheduler.time, device=self.device)
        self.keyspace.subscribe(self.hotcache.on_keyspace_tick)

        # load-aware resharding: the rebalance tick closing the loop on
        # the observatory's imbalance gauge — sustained windowed
        # imbalance above threshold solves new traffic-weighted shard
        # boundaries and hot-swaps them under the serving path between
        # waves (reshard.py; config.reshard knobs).  The runner
        # late-binds the history ring for windowed frame corroboration
        # (set_history).
        from ..reshard import Resharder
        self.reshard = Resharder(
            getattr(config, "reshard", None), node=str(self.myid),
            keyspace=self.keyspace, shard_t=self.resolve_mesh_t,
            on_swap=self._reshard_apply, clock=self.scheduler.time)
        self.reshard.attach(self.scheduler)

        # per-peer network observatory: bounded
        # LRU ledger over remote peers — Jacobson/Karels RTT estimator,
        # per-peer request/byte/flap attribution, and (behind
        # config.peers.adaptive_rto) the per-peer retransmit timeout
        # the engine consults instead of the fixed MAX_RESPONSE_TIME
        # (peers.py; config.peers knobs).  Attached to the engine's
        # request lifecycle seams; a disabled ledger detaches entirely
        # (engine.peers = None, the fast path without it).
        from ..peers import PeerLedger
        self.peers = PeerLedger(
            getattr(config, "peers", None), node=str(self.myid),
            clock=self.scheduler.time)
        self.engine.peers = self.peers if self.peers.enabled else None

        # wave-scale listen/push: a bounded device table of the keys
        # that currently have listeners — every stored put buffers here
        # instead of probing listener dicts synchronously, and the next
        # ingest wave (or the flush deadline) answers membership for the
        # whole buffer in ONE batched XOR-equality pass
        # (ops/listener_match.py), after which flush_listener_wave
        # dispatches one coalesced callback/tell_listener per wave per
        # listener.  listen_batching="off" is the escape hatch (the
        # exact synchronous per-put path); device failure goes dark to
        # the same path (listeners.py; config.listeners knobs).
        from ..listeners import ListenerTable
        self.listener_table = ListenerTable(
            getattr(config, "listeners", None), node=str(self.myid),
            batching=getattr(config, "listen_batching", "on"),
            live_count=self._listener_live_count,
            clock=self.scheduler.time,
            request_flush=self._arm_listener_flush, device=self.device)
        self._listener_flush_job = None

        # per-op latency waterfall: the always-on
        # stage profiler every serving layer feeds (wave builder,
        # search envelope, net engine/request) — process-global like
        # the registry; this node's config wins, same last-node-wins
        # aggregation rule (waterfall.py; config.waterfall knobs)
        from .. import waterfall as _waterfall
        self.waterfall = _waterfall.get_profiler()
        self.waterfall.configure(
            getattr(config, "waterfall", None)
            or _waterfall.WaterfallConfig())

        # t-sharded resolve (config.resolve_mesh_t): the mesh is built
        # lazily by resolve_mesh(); last_resolve_shard_t records what
        # the MOST RECENT batched resolve actually used
        self._resolve_mesh = None
        self.last_resolve_shard_t = 1

        # maintenance telemetry: handles cached once
        _reg = telemetry.get_registry()
        self._m_maint_sweeps = _reg.counter("dht_maintenance_sweeps_total")
        self._m_maint_refresh = _reg.counter(
            "dht_maintenance_refresh_sent_total")
        self._m_maint_due = _reg.counter("dht_maintenance_due_keys_total")
        self._m_maint_republished = _reg.counter(
            "dht_maintenance_republished_values_total")
        self._m_calendar_bins = _reg.gauge("dht_maintenance_calendar_bins")

        # write-token secrets, rotated every 15-45 min (dht.cpp:1369-1379)
        self._secret = os.urandom(8)
        self._oldsecret = self._secret
        self._rotate_secrets()

        now = self.scheduler.time()
        self._next_nodes_confirmation = self.scheduler.add(
            now + random.uniform(3, 5), self._confirm_nodes)
        self._expire_sweep()

    # ================================================================ plumbing
    def _table(self, af: int) -> Optional[NodeTable]:
        return self.tables.get(af)

    def is_running(self, af: int = 0) -> bool:
        if af == 0:
            return bool(self.tables)
        return af in self.tables

    def _want(self) -> int:
        w = 0
        if _socket.AF_INET in self.tables:
            w |= WANT4
        if _socket.AF_INET6 in self.tables:
            w |= WANT6
        return w

    def periodic(self, data: Optional[bytes], from_addr: Optional[SockAddr]
                 ) -> float:
        """Feed one received datagram (or None) and run due jobs; returns
        the next wakeup time (↔ Dht::periodic, src/dht.cpp:1902-1914)."""
        self.scheduler.sync_time()
        if data:
            try:
                self.engine.process_message(data, from_addr)
            except Exception:
                log.exception("can't process message from %r", from_addr)
        return self.scheduler.run()

    def warmup(self) -> None:
        """Build and run the hot table paths once, so the first real
        packet or wave doesn't stall the protocol thread: the host scan
        at both k the live path uses (``TARGET_NODES``, ``SEARCH_NODES``)
        and, for a table on the card, the kernel library (``nvcc`` at
        first use), the snapshot's sort and expansion, and one device
        lookup at each k.

        The port's differences from the JAX warmup: a failure raises
        instead of going to a debug log — a kernel that cannot build or
        launch must not hide until the first wave, where the wave
        builder would swallow it as a failed launch; and a node on the
        card also runs :func:`warm_device`."""
        now = self.scheduler.time()
        target = [InfoHash.get_random()]
        q = IK.ids_from_hashes(target)
        for table in self.tables.values():
            for k in (TARGET_NODES, SEARCH_NODES):
                table.find_closest(target, k=k, now=now)
            if table.device.type == "cuda":
                _build.library("select_kernels")
                if len(table):
                    view = table.view(now)
                    for k in (TARGET_NODES, SEARCH_NODES):
                        view.lookup(q, k=k)
        if self.device.type == "cuda":
            warm_device(self.config, self.device)

    # ======================================================== routing plumbing
    def find_closest_nodes(self, target: InfoHash, af: int,
                           count: int = TARGET_NODES) -> List[Node]:
        """k closest good/reachable peers as engine Node objects
        (↔ RoutingTable::findClosestNodes, src/routing_table.cpp:109-150;
        one row of the batched device kernel)."""
        return self.find_closest_nodes_batched([target], af, count)[0]

    def resolve_mesh(self):
        """The (q=1, t) device mesh batched resolves row-shard over when
        ``config.resolve_mesh_t >= 2`` — built once, ``None`` when
        unconfigured or when there are fewer devices than requested
        (logged; serving degrades to the identical unsharded path, never
        fails).  On the card the devices are CUDA cards; a node on the
        CPU has :data:`CPU_VIRTUAL_DEVICES` virtual ones."""
        t = int(getattr(self.config, "resolve_mesh_t", 0) or 0)
        if t <= 1:
            return None
        if self._resolve_mesh is None:
            try:
                from ..parallel import make_mesh
                if self.device.type == "cpu":
                    have = CPU_VIRTUAL_DEVICES
                else:
                    import torch
                    have = torch.cuda.device_count()
                if have < t:
                    log.warning(
                        "resolve_mesh_t=%d but only %d %s device(s); "
                        "serving the unsharded resolve path",
                        t, have, self.device.type)
                    self._resolve_mesh = False
                elif self.device.type == "cpu":
                    self._resolve_mesh = make_mesh(t, q=1, t=t,
                                                   devices=self.device)
                else:
                    self._resolve_mesh = make_mesh(t, q=1, t=t)
            except Exception:
                log.exception("resolve mesh unavailable; serving unsharded")
                self._resolve_mesh = False
        return self._resolve_mesh or None

    def resolve_mesh_t(self) -> int:
        """Active resolve-shard width (1 = unsharded) — the ingest wave
        builder stamps this on its wave spans/snapshot."""
        m = self.resolve_mesh()
        return int(m.shape["t"]) if m is not None else 1

    def _reshard_apply(self, layout) -> dict:
        """Resharder swap hook, called inside the swap span with the NEW
        layout before it is installed: when a mesh and a snapshot are
        live, eagerly rebuild the snapshot's weighted shard state (row
        movement + placement + per-shard perm map, core/table.py
        ``Snapshot._shard_state``) so the next wave doesn't pay the
        rebuild.  Runs on the DHT loop (a scheduler job), strictly
        between wave launches; waves already in flight captured the OLD
        operands at launch.  Without a mesh it launches nothing."""
        mesh = self.resolve_mesh()
        if mesh is None:
            return {"mode": "virtual"}
        table = self._table(_socket.AF_INET)
        snap = getattr(table, "_snap", None) if table is not None else None
        if snap is None or int(snap.n_valid) < layout.t:
            return {"mode": "virtual"}
        snap._shard_state(mesh, layout)
        return {"mode": "physical", "t": int(mesh.shape["t"])}

    def _keyspace_shard_info(self):
        """(t, bounds[, virtual]) for the keyspace observatory's per-shard
        load attribution: when a resolve mesh is live, the ACTUAL
        first-row ids (uint32) of shards 1..t-1 of the current v4 table
        snapshot — folding the traffic histogram over these is the real
        per-shard load.  ``(0, None)`` when unsharded (the observatory
        falls back to a uniform virtual split).

        With a reshard layout installed the boundaries are re-read from
        the CURRENT snapshot at the layout's solved split, so after a
        swap (or a snapshot rebuild) the fold follows the new edges.
        Unsharded nodes return the layout's fractional edges with
        ``virtual=True``, so the virtual fold follows the resharded
        ownership too."""
        lay = getattr(self, "reshard", None)
        lay = lay.layout if lay is not None else None
        t = self.resolve_mesh_t()
        if t <= 1:
            if lay is not None and lay.t > 1:
                return lay.t, [float(e) for e in lay.edges], True
            return 0, None
        table = self._table(_socket.AF_INET)
        snap = getattr(table, "_snap", None) if table is not None else None
        if snap is None:
            return t, None
        if lay is not None:
            n_valid = int(snap.n_valid)
            if n_valid >= t:
                rows = np.asarray(
                    snap.reshard_boundary_rows(lay, t), np.int64)
                rows = np.clip(rows, 0, max(n_valid - 1, 0))
                return t, self._snap_ids(snap, rows), False
        cap = snap.sorted_ids.shape[0]
        # mirror the actual split: _shard_state pads cap UP to a multiple
        # of t, so the per-shard row count is the ceiling
        shard_n = -(-cap // t)
        if shard_n == 0:
            return t, None
        n_valid = int(snap.n_valid)
        if n_valid <= (t - 1) * shard_n:
            # a partially filled table: a boundary row would fall past
            # the valid rows and clamp, a zero-width trailing shard that
            # reports fill level as traffic imbalance — fall back to the
            # uniform t-way ring split
            return t, None
        rows = [s * shard_n for s in range(1, t)]
        return t, self._snap_ids(snap, np.asarray(rows))

    @staticmethod
    def _snap_ids(snap, rows) -> np.ndarray:
        """uint32 ids of the snapshot's sorted ``rows``."""
        import torch
        return IK.from_keys(snap.sorted_ids[
            torch.as_tensor(np.asarray(rows, np.int64),
                            device=snap.device)])

    def find_closest_nodes_batched(self, targets: List[InfoHash], af: int,
                                   count: int = TARGET_NODES
                                   ) -> List[List[Node]]:
        """Batched form: resolve *many* targets with one device top-k
        call — the core device win for nodes serving thousands of
        concurrent requests (SURVEY.md §7 design mapping)."""
        return self.find_closest_nodes_launch(targets, af, count).consume()

    def find_closest_nodes_launch(self, targets: List[InfoHash], af: int,
                                  count: int = TARGET_NODES
                                  ) -> BatchedResolve:
        """Async form of :meth:`find_closest_nodes_batched` (the wave
        pipeline's): the device top-k is dispatched before this
        returns; the handle's ``consume()`` blocks on the device and
        materializes the Node lists.  ``handle.shard_t`` carries the
        per-launch shard width — overlapping waves must not read the
        shared ``last_resolve_shard_t`` at consume time."""
        # reset BEFORE any early return: a wave served by an empty
        # table (or one whose launch raises) must not inherit the
        # previous resolve's shard width
        self.last_resolve_shard_t = 1
        table = self._table(af)
        if table is None or len(table) == 0 or not targets:
            return BatchedResolve.resolved([[] for _ in targets])
        now = self.scheduler.time()
        rs = getattr(self, "reshard", None)
        pl = table.find_closest_launch(
            list(targets), k=count, now=now, mesh=self.resolve_mesh(),
            layout=rs.layout if rs is not None else None)
        # truth, not config: the table says whether THIS resolve ran
        # sharded (host scans and churn views ignore the mesh) — the
        # ingest wave spans/counters attribute from this flag
        shard_t = (self.resolve_mesh_t()
                   if getattr(table, "last_resolve_sharded", False) else 1)
        self.last_resolve_shard_t = shard_t

        def finalize():
            rows, _dist = pl.consume()
            # one vectorized id conversion for the whole result matrix —
            # the per-row numpy round-trip dominated big batches
            # (table.py ids_of_rows)
            ids_flat = table.ids_of_rows(rows)
            out: List[List[Node]] = []
            k_out = rows.shape[1]
            for qi in range(rows.shape[0]):
                nodes: List[Node] = []
                for j in range(k_out):
                    r = rows[qi, j]
                    if r < 0:
                        continue
                    addr = table.addr_of(int(r))
                    if addr is None:
                        continue
                    nodes.append(self.engine.cache.get_node(
                        ids_flat[qi * k_out + j], addr, now, confirm=False))
                out.append(nodes)
            return out

        return BatchedResolve(finalize, pending=pl, shard_t=shard_t)

    def _searches_of(self, af: int) -> Dict[InfoHash, Search]:
        return self.searches.get(af, {})

    def get_search_hops(self, key: InfoHash,
                        af: int = _socket.AF_INET) -> Optional[int]:
        """Protocol-level hops-to-converge of the search on ``key``: the
        deepest discovery generation among the replied top-k candidates
        (live_search.Search.current_hops).  Validated against the batched
        simulator's hop counter in tests/test_hop_parity.py."""
        sr = self._searches_of(af).get(key)
        return sr.current_hops() if sr is not None else None

    def _try_search_insert(self, node: Node) -> bool:
        """Offer a newly-heard node to searches near its id, walking
        outward from its sorted position until a live search declines
        (↔ Dht::trySearchInsert, src/dht.cpp:118-150)."""
        now = self.scheduler.time()
        srs = self._searches_of(node.family)
        keys = self._search_keys.get(node.family)
        if not srs or keys is None:
            return False
        # when this node arrived inside a reply, attribute its discovery
        # generation per search: one deeper than the replying node's
        # (hop accounting — live_search.SearchNode.depth)
        via = self.engine.reply_via
        inserted = False
        pos = bisect_left(keys, bytes(node.id))
        for rng in (range(pos, len(keys)), range(pos - 1, -1, -1)):
            for i in rng:
                sr = srs[InfoHash(keys[i])]
                depth = None
                if via is not None:
                    vsn = sr.get_node(via)
                    depth = (vsn.depth + 1) if vsn is not None else 1
                if sr.insert_node(node, now, depth=depth):
                    inserted = True
                    self._edit_step(sr, now)
                elif not sr.expired and not sr.done:
                    break
        return inserted

    def _on_new_node(self, node: Node, confirm: int) -> None:
        """(↔ Dht::onNewNode, src/dht.cpp:166-172)"""
        table = self._table(node.family)
        if table is None:
            return
        was_known = table.row_of(node.id) is not None
        row = table.insert(node.id, node.addr, self.scheduler.time(),
                           confirm=confirm)
        if row is not None and confirm == 0 \
                and table._time_reply[row] == 0.0:
            # genuinely new hearsay node admitted into the table
            self._table_grow_time[node.family] = self.scheduler.time()
        # offer to searches whenever the node is NEW to us — even if its
        # bucket was full and the table only cached it — or confirmed.
        # The reference's RoutingTable::onNewNode returns true on the
        # bucket-full path too (routing_table.cpp:254-261); gating on
        # table admission starved searches of discovered nodes once
        # buckets filled (found via the live-vs-simulator hop parity
        # check, tests/test_hop_parity.py).
        if not was_known or confirm:
            self._try_search_insert(node)
        if confirm:
            self._update_status(node.family, debounce=True)

    def _on_reported_addr(self, _id: InfoHash, addr: Optional[SockAddr]) -> None:
        """Collect peers' echoes of our public address
        (↔ Dht::reportedAddr, src/dht.cpp:152-164)."""
        if addr is None or not addr.port:
            return
        for i, (count, a) in enumerate(self.reported_addr):
            if a == addr:
                self.reported_addr[i] = (count + 1, a)
                return
        if len(self.reported_addr) < 32:
            self.reported_addr.append((1, addr))

    def get_public_address(self, family: int = 0) -> List[SockAddr]:
        """(src/dht.cpp:103-115)"""
        ordered = sorted(self.reported_addr, key=lambda e: -e[0])
        return [a for _, a in ordered if not family or a.family == family]

    # ============================================================== the tokens
    def _rotate_secrets(self) -> None:
        self._oldsecret = self._secret
        self._secret = os.urandom(8)
        self.scheduler.add(self.scheduler.time() + random.uniform(15 * 60, 45 * 60),
                           self._rotate_secrets)

    def _make_token(self, addr: SockAddr, old: bool) -> bytes:
        """sha256(secret ‖ ip ‖ port) (↔ Dht::makeToken,
        src/dht.cpp:1381-1411; crypto::hash picks SHA-256 for 32 B)."""
        if addr.ip is None:
            return b""
        secret = self._oldsecret if old else self._secret
        h = hashlib.sha256()
        h.update(secret)
        h.update(addr.ip.packed)
        h.update(addr.port.to_bytes(2, "big"))
        return h.digest()[:TOKEN_SIZE]

    def _token_match(self, token: bytes, addr: Optional[SockAddr]) -> bool:
        if addr is None or len(token) != TOKEN_SIZE:
            return False
        return token == self._make_token(addr, False) or \
            token == self._make_token(addr, True)

    # ========================================================== search driving
    def _edit_step(self, sr: Search, t: float) -> None:
        if sr.next_search_step is not None:
            sr.next_search_step = self.scheduler.edit(sr.next_search_step, t)
        else:
            sr.next_search_step = self.scheduler.add(
                t, lambda: self._search_step(sr))

    def _search(self, target: InfoHash, af: int, get_cb=None, query_cb=None,
                done_cb=None, f: Optional[Filter] = None,
                q: Optional[Query] = None) -> Optional[Search]:
        """Find-or-create the search and attach a Get op
        (↔ Dht::search, src/dht.cpp:681-746)."""
        if not self.is_running(af):
            if done_cb:
                done_cb(False, [])
            return None
        srs = self.searches[af]
        keys = self._search_keys[af]
        sr = srs.get(target)
        if sr is not None:
            sr.done = False
            sr.expired = False
        else:
            if sum(len(s) for s in self.searches.values()) >= MAX_SEARCHES:
                # reuse a finished search slot (src/dht.cpp:703-717)
                victim = next(
                    (key for key, s in srs.items()
                     if (s.done or s.expired) and not s.announce
                     and not s.listeners), None)
                if victim is None:
                    log.error("[search %s] maximum number of searches "
                              "reached", target,
                              extra={"dht_hash": bytes(target)})
                    if done_cb:
                        done_cb(False, [])
                    return None
                old = srs.pop(victim)
                old.stop()
                keys.remove(bytes(victim))
            self._search_id = (self._search_id + 1) & 0xFFFF or 1
            sr = Search(target, af, self._search_id,
                        clock=self.scheduler.time)
            srs[target] = sr
            insort(keys, bytes(target))

        # adopt the calling op's trace context (runner ops activate it
        # around the posted closure) UNCONDITIONALLY: a reused search
        # re-parents its remaining hops under the newest op — and an
        # untraced op clears a finished trace's context, so its RPCs
        # never leak spans (or wire bytes) into a trace that already
        # ended
        sr.trace_ctx = tracing.current()

        if get_cb or query_cb:
            sr.callbacks.append(Get(
                start=self.scheduler.time(), filter=f,
                query=q if q is not None else Query(),
                query_cb=query_cb, get_cb=get_cb, done_cb=done_cb))
        self._refill(sr)
        self._edit_step(sr, self.scheduler.time())
        return sr

    def _refill(self, sr: Search) -> int:
        """Seed/refresh the candidate set from the routing table — the
        batched device top-k instead of the reference's scalar cache walk
        (↔ Dht::refill, src/dht.cpp:656-677).

        With the ingest wave builder enabled the resolve rides
        the next shared ``[Q]`` wave (fill- or deadline-triggered)
        instead of paying a per-search padded launch; the nodes land via
        :meth:`_refill_apply` and the search re-steps itself.  The
        ``ingest_batching="off"`` path below is byte-for-byte the
        earlier per-op dispatch.

        A PURE-GET refill is cache-eligible — the wave builder probes
        the hot-value cache in one batched XOR-compare before the launch
        and a hit completes the get via :meth:`_refill_cache_hit`
        without the search ever joining the ``[Q]`` lookup; the
        batching-off path takes the identical decision through the
        host-side membership test (``hotcache.serve_one``)."""
        now = self.scheduler.time()
        sr.refill_time = now
        cacheable = self._cache_eligible(sr)
        if self.wave_builder.enabled:
            if not sr.refill_pending:
                sr.refill_pending = True
                self.wave_builder.submit(
                    sr.id, sr.af, SEARCH_NODES,
                    lambda nodes, _sr=sr: self._refill_apply(_sr, nodes),
                    cache_cb=(lambda values, _sr=sr:
                              self._refill_cache_hit(_sr, values))
                    if cacheable else None)
            return 0
        if cacheable:
            vals = self.hotcache.serve_one(sr.id)
            if vals is not None:
                self.keyspace.observe_hashes([sr.id], source="cache")
                self._refill_cache_hit(sr, vals)
                return 0
        return self._refill_insert(
            sr, self.find_closest_nodes(sr.id, sr.af, SEARCH_NODES))

    def _cache_eligible(self, sr: Search) -> bool:
        """Only PURE-GET searches may be served from the hot-value
        cache: an announce needs real closest nodes to put to, a listen
        needs live subscriptions, and a field query projects server-
        side — all of those always ride the wave.  Pinned result-
        equivalent cache-on vs cache-off in the JAX package's
        tests/test_hotcache.py."""
        hc = self.hotcache
        if hc is None or not hc.enabled:
            return False
        if sr.announce or sr.listeners or not sr.callbacks:
            return False
        return all(g.get_cb is not None and g.query_cb is None
                   for g in sr.callbacks)

    def _refill_cache_hit(self, sr: Search, values: List[Value]) -> None:
        """Serve a cache-eligible search from the hot-value cache: the
        cached values complete every pending get (through its own
        filter) exactly as :meth:`_search_step`'s completed-get block
        would, without the search joining a lookup launch.  The search
        object stays reusable — a later op on the same key re-opens it
        through the normal path.

        Eligibility is RE-CHECKED here: it was decided at submit time,
        and an announce/listen can join the search while the refill sat
        in the wave queue — swallowing that refill would leave the
        search with zero candidates and the put/listen would expire
        unserved.  A no-longer-eligible search falls
        through to the normal refill path instead."""
        sr.refill_pending = False
        if not self._cache_eligible(sr):
            self._refill(sr)
            if not sr.expired and not sr.done:
                self._edit_step(sr, self.scheduler.time())
            return
        completed = list(sr.callbacks)
        for get in completed:
            vals = [v for v in values
                    if get.filter is None or get.filter(v)]
            if get.get_cb and vals:
                get.get_cb(vals)
            sr.set_get_done(get)
            sr.callbacks.remove(get)
        for get in completed:
            for sn in sr.nodes:
                sn.get_status.pop(get.query, None)
                sn.pagination_queries.pop(get.query, None)
        if not sr.callbacks and not sr.announce and not sr.listeners:
            sr.set_done()

    def _refill_insert(self, sr: Search, nodes: List[Node]) -> int:
        now = self.scheduler.time()
        inserted = 0
        for n in nodes:
            if sr.insert_node(n, now):
                inserted += 1
        # fall back to the engine's interned-node cache when the table is
        # still empty (e.g. first bootstrap reply not yet confirmed)
        if not inserted and not sr.nodes:
            for n in self.engine.get_cached_nodes(sr.id, sr.af, SEARCH_NODES):
                if sr.insert_node(n, now):
                    inserted += 1
        return inserted

    def _refill_apply(self, sr: Search, nodes: List[Node]) -> None:
        """Scatter half of a coalesced refill: the wave that carried
        this search's resolve delivers its candidate rows; step the
        search at whatever round it is on (continuous batching — a
        search never blocks a wave, a wave never blocks a search)."""
        sr.refill_pending = False
        self._refill_insert(sr, nodes)
        if not sr.expired and not sr.done:
            self._edit_step(sr, self.scheduler.time())

    def _search_step(self, sr: Search) -> None:
        """One scheduler-driven step (↔ Dht::searchStep,
        src/dht.cpp:561-654)."""
        if sr.expired or sr.done:
            return
        now = self.scheduler.time()
        sr.step_time = now

        if sr.refill_time + NODE_EXPIRE_TIME < now and \
                len(sr.nodes) - sr.get_number_of_bad_nodes() < SEARCH_NODES:
            self._refill(sr)

        if sr.is_synced(now):
            if sr.callbacks or sr.announce:
                completed = [g for g in sr.callbacks if sr.is_done(g)]
                for get in completed:
                    sr.set_get_done(get)
                    sr.callbacks.remove(get)
                for get in completed:
                    for sn in sr.nodes:
                        sn.get_status.pop(get.query, None)
                        sn.pagination_queries.pop(get.query, None)
                sr.check_announced()
                if not sr.callbacks and not sr.announce and not sr.listeners:
                    sr.set_done()

            if sr.listeners:
                i = 0
                for sn in sr.nodes:
                    if not sn.is_synced(now):
                        continue
                    self._search_node_listen(sr, sn)
                    if not sn.candidate:
                        i += 1
                        if i == LISTEN_NODES:
                            break

            self._search_send_announce(sr)
            if not sr.callbacks and not sr.announce and not sr.listeners:
                sr.set_done()

        while sr.currently_solicited_node_count() < MAX_REQUESTED_SEARCH_NODES:
            if self._search_send_get_values(sr) is None:
                break

        # a refill in flight on the wave builder must finish before the
        # bad-node rule can expire the search: a freshly-admitted op's
        # candidate set is legitimately empty until its wave lands
        # (0 >= min(0, MAX) would expire it within one step otherwise)
        if not sr.refill_pending and \
                sr.get_number_of_consecutive_bad_nodes() >= min(
                len(sr.nodes), SEARCH_MAX_BAD_NODES):
            log.warning("[search %s] expired", sr.id,
                        extra={"dht_hash": bytes(sr.id)})
            sr.expire()
            self.connectivity_changed(sr.af)
            return

        # self-reschedule at the next announce/listen refresh so permanent
        # puts and listens refresh before remote expiry even when no other
        # traffic steps this search (live_search.Search.get_next_step_time)
        nxt = sr.get_next_step_time(now)
        if nxt < TIME_MAX:
            job = sr.next_search_step
            pending = job.time if (job is not None
                                   and not job.cancelled) else None
            if pending is None or nxt < pending:
                self._edit_step(sr, nxt)

    @_traced_search
    def _search_send_get_values(self, sr: Search,
                                pn: Optional[SearchNode] = None,
                                update: bool = True) -> Optional[SearchNode]:
        """Send the next solicitation (↔ Dht::searchSendGetValues,
        src/dht.cpp:312-378)."""
        if sr.done or sr.currently_solicited_node_count() \
                >= MAX_REQUESTED_SEARCH_NODES:
            return None
        now = self.scheduler.time()
        gets = sr.callbacks or [None]
        for get in gets:
            query = get.query if get is not None else _ANY_QUERY
            up = sr.get_last_get_time(query) \
                if (get is not None and update) else _NEVER
            n: Optional[SearchNode] = None
            if pn is not None and pn.can_get(now, up, query):
                n = pn
            else:
                for sn in sr.nodes:
                    if sn.can_get(now, up, query):
                        n = sn
                        break
            if get is None:
                # no pending get op: plain find_node sync probe
                if n is None:
                    return None
                n.get_status[query] = self.engine.send_find_node(
                    n.node, sr.id, -1,
                    self._mk_get_done(sr, query),
                    self._mk_get_expired(sr, query))
                return n
            if n is None:
                continue
            if query is not None and not query.select.empty():
                n.get_status[query] = self.engine.send_get_values(
                    n.node, sr.id, query, -1,
                    self._mk_get_done(sr, query),
                    self._mk_get_expired(sr, query))
            else:
                self._paginate(sr, query, n)
            return n
        return None

    def _mk_get_done(self, sr: Search, query: Query):
        def on_done(req: Request, answer: RequestAnswer):
            self._search_node_get_done(req, answer, sr, query)
        return on_done

    def _mk_get_expired(self, sr: Search, query: Query):
        def on_expired(req: Request, over: bool):
            sn = sr.get_node(req.node)
            if sn is not None:
                sn.candidate = not over
                if over:
                    sn.get_status.pop(query, None)
            self._edit_step(sr, self.scheduler.time())
        return on_expired

    def _search_node_get_done(self, req: Request, answer: RequestAnswer,
                              sr: Search, query: Query) -> None:
        """A node answered a get/find (↔ Dht::searchNodeGetDone,
        src/dht.cpp:212-240)."""
        now = self.scheduler.time()
        sr.insert_node(req.node, now, answer.ntoken)
        sn = sr.get_node(req.node)
        if sn is not None:
            # requests already satisfied by this answer need not be sent
            for g in sr.callbacks:
                if g.query.is_satisfied_by(query) and g.query != query:
                    sn.get_status[g.query] = cancelled_request()
            sync_time = sn.get_sync_time(now)
            if sn.sync_job is not None:
                sn.sync_job = self.scheduler.edit(sn.sync_job, sync_time)
            else:
                sn.sync_job = self.scheduler.add(
                    sync_time, lambda: self._search_step(sr))
        self._on_get_values_done(req.node, answer, sr, query)

    @_traced_search
    def _paginate(self, sr: Search, query: Query, n: SearchNode) -> None:
        """SELECT id probe, then per-id sub-gets — keeps every reply under
        the value-size packet cap (↔ Dht::paginate, src/dht.cpp:258-310)."""
        select_q = Query(Select().field(Field.ID), query.where)

        def on_select_done(req: Request, answer: RequestAnswer):
            if answer.fields:
                sn = sr.get_node(req.node)
                if sn is None:
                    return
                for fvi in answer.fields:
                    fv = fvi.index.get(Field.ID)
                    if fv is None or fv.value == Value.INVALID_ID:
                        continue
                    q_vid = Query(Select(), Where().id(fv.value))
                    sn.pagination_queries.setdefault(query, []).append(q_vid)
                    sn.get_status[q_vid] = self.engine.send_get_values(
                        req.node, sr.id, q_vid, -1,
                        self._mk_get_done(sr, query),
                        self._mk_get_expired(sr, q_vid))
            else:
                # peer ignored the projection: plain full answer
                self._search_node_get_done(req, answer, sr, query)

        n.pagination_queries.setdefault(query, []).append(select_q)
        # the per-id sub-gets are sent from the select reply callback —
        # restore the search's context around it
        n.get_status[select_q] = self.engine.send_get_values(
            n.node, sr.id, select_q, -1,
            lambda r, a: tracing.run_with(sr.trace_ctx,
                                          lambda: on_select_done(r, a)),
            self._mk_get_expired(sr, select_q))

    def _on_get_values_done(self, node: Node, a: RequestAnswer, sr: Search,
                            orig_query: Optional[Query]) -> None:
        """Dispatch an answer's values to the search's get ops
        (↔ Dht::onGetValuesDone, src/dht.cpp:2163-2235)."""
        if a.ntoken:
            if a.values or a.fields:
                for get in sr.callbacks:
                    if not (get.get_cb or get.query_cb):
                        continue
                    if orig_query is not None and \
                            not get.query.is_satisfied_by(orig_query):
                        continue
                    if get.query_cb:
                        if a.fields:
                            get.query_cb(a.fields)
                        elif a.values:
                            get.query_cb([
                                FieldValueIndex(
                                    v, orig_query.select if orig_query
                                    else Select())
                                for v in a.values])
                    elif get.get_cb:
                        vals = [v for v in a.values
                                if get.filter is None or get.filter(v)]
                        if vals:
                            get.get_cb(vals)
        else:
            log.warning("[node %s] no token provided; blacklisting", node.id,
                        extra={"dht_hash": bytes(node.id)})
            self.engine.blacklist_node(node)

        if not sr.done:
            self._search_send_get_values(sr)
            self._edit_step(sr, self.scheduler.time())

    # ----------------------------------------------------------- announce path
    def _replica_k(self, key: InfoHash) -> int:
        """Adaptive replica set for ``key``: closest-16
        while the key is in the hot-cache's hot set (widening relieves
        the storing-node bottleneck the way Kademlia §4.1 prescribes),
        closest-8 otherwise — and back to 8 the tick after the key
        decays out.  Consulted by the announce walk and the
        calendar-binned republish resolve (the JAX package pins it vs a
        scalar oracle in tests/test_hotcache.py)."""
        return self.hotcache.replica_k(key)

    @_traced_search
    def _search_send_announce(self, sr: Search) -> None:
        """Probe synced nodes with SELECT id,seq then put/refresh
        (↔ Dht::searchSendAnnounceValue, src/dht.cpp:380-485).

        The replica walk counts to :meth:`_replica_k` (8, or 16 for hot
        keys) instead of the fixed TARGET_NODES, and the search's
        candidate capacity widens by the same margin so the wider walk
        has candidates to reach — both re-evaluated per call, so a key
        decaying out of the hot set narrows automatically."""
        if not sr.announce:
            return
        now = self.scheduler.time()
        rk = self._replica_k(sr.id)
        sr.capacity = max(SEARCH_NODES,
                          rk + (SEARCH_NODES - TARGET_NODES))
        probe_query = Query(Select().field(Field.ID).field(Field.SEQ_NUM))
        i = 0
        for sn in sr.nodes:
            if not sn.is_synced(now):
                continue
            if not any(sn.get_announce_time(a.value.id) <= now
                       for a in sr.announce):
                # already announced/pending on this node: it still occupies
                # one of the k replica slots — count it so the walk can't
                # drift past the 8 closest while acks are in flight (the
                # reference skips without counting, dht.cpp:391-395, which
                # over-replicates under fast stepping; k-closest semantics
                # per routing_table.h:26)
                if not sn.candidate:
                    i += 1
                    if i == rk:
                        break
                continue

            def on_put_done(req: Request, answer: RequestAnswer):
                self._on_announce_done(req.node, answer, sr)
                self._search_step(sr)

            def on_put_expired(req: Request, over: bool):
                if over:
                    self._edit_step(sr, self.scheduler.time())

            def on_select_done(req: Request, answer: RequestAnswer,
                               _done=on_put_done, _exp=on_put_expired):
                now = self.scheduler.time()
                sr.insert_node(req.node, now, answer.ntoken)
                s = sr.get_node(req.node)
                if s is None:
                    return
                if not s.is_synced(now):
                    self._edit_step(sr, now)
                    return
                for a in sr.announce:
                    if s.get_announce_time(a.value.id) > now:
                        continue
                    has_value = False
                    seq_no = 0
                    for fvi in answer.fields:
                        fid = fvi.index.get(Field.ID)
                        if fid is not None and fid.value == a.value.id:
                            has_value = True
                            fseq = fvi.index.get(Field.SEQ_NUM)
                            seq_no = fseq.value if fseq is not None else 0
                            break
                    next_refresh = now + self.types.get_type(
                        a.value.type).expiration
                    if not has_value or seq_no < a.value.seq:
                        s.acked[a.value.id] = (
                            self.engine.send_announce_value(
                                s.node, sr.id, a.value,
                                None if a.permanent else a.created,
                                s.token, _done, _exp),
                            next_refresh)
                    elif has_value and a.permanent:
                        s.acked[a.value.id] = (
                            self.engine.send_refresh_value(
                                s.node, sr.id, a.value.id, s.token,
                                _done, _exp),
                            next_refresh)
                    else:
                        s.acked[a.value.id] = (acked_request(now),
                                               next_refresh)
                        self._edit_step(sr, now)

            sn.probe_query = probe_query
            # the select-done callback fires from the reply path (no
            # ambient context) and sends the put/refresh itself —
            # restore the search's context around it
            sn.get_status[probe_query] = self.engine.send_get_values(
                sn.node, sr.id, probe_query, -1,
                lambda r, a, _cb=on_select_done: tracing.run_with(
                    sr.trace_ctx, lambda: _cb(r, a)),
                self._mk_get_expired(sr, probe_query))
            if not sn.candidate:
                i += 1
                if i == rk:
                    break

    def _on_announce_done(self, node: Node, answer: RequestAnswer,
                          sr: Search) -> None:
        """(↔ Dht::onAnnounceDone, src/dht.cpp:2362-2369)"""
        self._search_send_get_values(sr)
        sr.check_announced(answer.vid)

    # ------------------------------------------------------------- listen path
    @_traced_search
    def _search_node_listen(self, sr: Search, sn: SearchNode) -> None:
        """Maintain listen contracts on one synced node
        (↔ Dht::searchSynchedNodeListen, src/dht.cpp:487-557)."""
        now = self.scheduler.time()
        for list_token, sl in list(sr.listeners.items()):
            query = sl.query
            if sn.get_listen_time(query) > now:
                continue
            ls = sn.listen_status.get(query)
            if ls is None:
                from .live_search import CachedListenStatus

                def cache_cb(values, expired, _t=list_token):
                    l = sr.listeners.get(_t)
                    if l is not None:
                        vals = (values if l.filter is None
                                else [v for v in values if l.filter(v)])
                        if vals:
                            l.get_cb(vals, expired)

                ls = sn.listen_status[query] = CachedListenStatus(cache_cb)
                node = sn.node

                def expire_cache(_q=query, _n=node):
                    s = sr.get_node(_n)
                    if s is not None:
                        s.expire_values(_q, self.scheduler)
                ls.cache_expiration_job = self.scheduler.add(
                    TIME_MAX, expire_cache)

            def on_listen_done(req: Request, answer: RequestAnswer,
                               _q=query):
                self._edit_step(sr, self.scheduler.time())
                s = sr.get_node(req.node)
                if s is not None:
                    self.scheduler.add(s.get_listen_time(_q),
                                       lambda: self._search_step(sr))
                if not sr.done:
                    self._search_send_get_values(sr)

            def on_listen_expired(req: Request, over: bool, _q=query):
                self._edit_step(sr, self.scheduler.time())
                if over:
                    s = sr.get_node(req.node)
                    if s is not None:
                        s.listen_status.pop(_q, None)

            def on_socket_values(node: Node, msg, _q=query):
                """Unsolicited pushes on the listen socket."""
                self._edit_step(sr, self.scheduler.time())
                answer = RequestAnswer.from_msg(msg)
                sr.insert_node(node, self.scheduler.time(), answer.ntoken)
                s = sr.get_node(node)
                if s is not None:
                    s.on_values(_q, answer, self.types, self.scheduler)

            new_req = self.engine.send_listen(
                sn.node, sr.id, query, sn.token, ls.req,
                on_listen_done, on_listen_expired, on_socket_values)
            ls = sn.listen_status.get(query)
            if ls is not None and new_req is not None:
                ls.req = new_req

    # ================================================================ public API
    def get(self, key: InfoHash, get_cb=None, done_cb=None,
            f: Optional[Filter] = None, where: Optional[Where] = None) -> None:
        """Iterative value lookup over both families
        (↔ Dht::get, src/dht.cpp:980-1017)."""
        if not self.wave_builder.admit("get"):
            if done_cb:
                done_cb(False, [])
            return
        log.debug("[search %s] get", key, extra={"dht_hash": bytes(key)})
        q = Query(Select(), where or Where())
        f = Filters.chain(f, q.where.get_filter())
        # captured BEFORE the search starts: an invalidation landing
        # while this get is in flight bumps the key's token and the
        # fill-on-get offer below is rejected (freshness)
        offer_token = self.hotcache.offer_token(key)
        # done when the user stops us or both family searches finish;
        # ok = user-stop or either search completing (dht.cpp:952-978)
        state = {"done": False, "stop": False, "done4": False, "done6": False,
                 "ok4": False, "ok6": False, "values": [], "nodes": []}

        def maybe_done(nodes: List[Node]):
            state["nodes"].extend(nodes)
            if state["done"]:
                return
            if state["stop"] or (state["done4"] and state["done6"]):
                state["done"] = True
                # fill-on-get (the Kademlia lookup-path caching move): a
                # completed get on a currently-hot, not-yet-cached key
                # seeds the hot-value cache with the observed value set
                # — the next hot get serves from it.  ONLY unfiltered
                # gets may seed: a where/user filter makes
                # state["values"] a SUBSET of the key's value set, and
                # caching it would drop values from later unfiltered
                # gets.  The offer token rejects a seed whose key was
                # invalidated by a put while this get was in flight —
                # the stale pre-put set must not re-enter through the
                # fill path.
                if state["values"] and f is None \
                        and self.hotcache.wants(key):
                    self.hotcache.offer(key, list(state["values"]),
                                        token=offer_token)
                if done_cb:
                    done_cb(state["stop"] or state["ok4"] or state["ok6"],
                            state["nodes"])

        def gcb(values: List[Value]) -> bool:
            if state["done"]:
                return False
            new = []
            for v in values:
                if any(sv is v or sv == v for sv in state["values"]):
                    continue
                if f is None or f(v):
                    new.append(v)
            if new:
                state["values"].extend(new)
                if get_cb is not None and not get_cb(new):
                    state["stop"] = True   # user said stop
            maybe_done([])
            return not state["stop"]

        local = self.get_local(key, f)
        if local:
            gcb(local)

        def mk_done(flag: str, ok_flag: str):
            def cb(ok: bool, nodes: List[Node]):
                state[flag] = True
                state[ok_flag] = ok
                maybe_done(nodes)
            return cb

        # preset non-running families FIRST (the put() discipline): a
        # cache-served get completes SYNCHRONOUSLY inside _search on
        # the batching-off path, and its done callback must see the
        # final flag state or the op never reports done
        ran = False
        families = ((_socket.AF_INET, "done4", "ok4"),
                    (_socket.AF_INET6, "done6", "ok6"))
        for af, flag, _ok in families:
            if not self.is_running(af):
                state[flag] = True
        for af, flag, ok_flag in families:
            if self.is_running(af):
                ran = True
                self._search(key, af, get_cb=gcb,
                             done_cb=mk_done(flag, ok_flag), f=f, q=q)
        if not ran:
            maybe_done([])

    def query(self, key: InfoHash, query_cb, done_cb=None,
              q: Optional[Query] = None) -> None:
        """Remote field query (↔ Dht::query, src/dht.cpp:1019-1064)."""
        if not self.wave_builder.admit("query"):
            if done_cb:
                done_cb(False, [])
            return
        q = q or Query()
        f = q.where.get_filter()
        state = {"done": False, "done4": False, "done6": False,
                 "fields": [], "nodes": []}

        def maybe_done(nodes):
            state["nodes"].extend(nodes)
            if not state["done"] and state["done4"] and state["done6"]:
                state["done"] = True
                if done_cb:
                    done_cb(bool(state["fields"]), state["nodes"])

        def qcb(fields: List[FieldValueIndex]) -> bool:
            if state["done"]:
                return False
            new = []
            for fv in fields:
                if any(fv.contained_in(sf) for sf in state["fields"]):
                    continue
                state["fields"] = [sf for sf in state["fields"]
                                   if not sf.contained_in(fv)]
                new.append(fv)
            if new:
                state["fields"].extend(new)
                query_cb(new)
            return True

        local = self.get_local(key, f)
        if local:
            qcb([FieldValueIndex(v, q.select) for v in local])

        def mk_done(flag: str):
            def cb(ok: bool, nodes):
                state[flag] = True
                maybe_done(nodes)
            return cb

        for af, flag in ((_socket.AF_INET, "done4"),
                         (_socket.AF_INET6, "done6")):
            if self.is_running(af):
                self._search(key, af, query_cb=qcb, done_cb=mk_done(flag), q=q)
            else:
                state[flag] = True
        maybe_done([])

    def put(self, key: InfoHash, value: Value, done_cb=None,
            created: Optional[float] = None, permanent: bool = False) -> None:
        """Store a value on the k closest nodes
        (↔ Dht::put, src/dht.cpp:913-946)."""
        if not self.wave_builder.admit("put"):
            if done_cb:
                done_cb(False, [])
            return
        if value.id == Value.INVALID_ID:
            value.id = random_value_id()
        # freshness: invalidate BEFORE the announce, even when the local
        # store rejects the value (full/over-quota) — the put is still
        # propagating to the network, and a stale cache hit must not
        # outlive it
        self.hotcache.invalidate(key)
        state = {"done": False, "done4": False, "done6": False,
                 "ok4": False, "ok6": False}

        def mk_done(flag: str, ok_flag: str):
            def cb(ok: bool, nodes: List[Node]):
                state[flag] = True
                state[ok_flag] = ok
                if done_cb and not state["done"] and \
                        state["done4"] and state["done6"]:
                    state["done"] = True
                    done_cb(state["ok4"] or state["ok6"], nodes)
            return cb

        # preset non-running families first so a synchronous callback from
        # _announce (value already announced / search unavailable) sees the
        # final flag state and can complete the put
        families = ((_socket.AF_INET, "done4", "ok4"),
                    (_socket.AF_INET6, "done6", "ok6"))
        for af, flag, _ok in families:
            if not self.is_running(af):
                state[flag] = True
        for af, flag, ok_flag in families:
            if self.is_running(af):
                self._announce(key, af, value, mk_done(flag, ok_flag),
                               created, permanent)
        if done_cb and not state["done"] and state["done4"] and state["done6"]:
            state["done"] = True
            done_cb(state["ok4"] or state["ok6"], [])
        if permanent:
            self._schedule_local_refresh(key, value)

    def _schedule_local_refresh(self, key: InfoHash, value: Value) -> None:
        """Keep the *local* copy of a permanent put alive: remote copies
        are refreshed by the announce path (send_refresh_value), but the
        putter's own storage would hit its TTL otherwise.  Runs until the
        permanent announce is cancelled on every family.  One chain per
        (key, vid) — re-puts of the same value reuse the live chain."""
        ttl = self.types.get_type(value.type).expiration
        vid = value.id
        if (key, vid) in self._local_refresh_jobs:
            return

        def local_expiration() -> Optional[float]:
            st = self.store.get(key)
            if st is not None:
                for vs in st.values:
                    if vs.data.id == vid:
                        return vs.expiration
            return None

        def arm(at: float) -> None:
            now = self.scheduler.time()
            self._local_refresh_jobs[(key, vid)] = self.scheduler.add(
                max(at, now + 1.0), local_refresh)

        def local_refresh():
            still = any(
                a.permanent and a.value.id == vid
                for srs in self.searches.values()
                for sr in ((srs.get(key),) if srs.get(key) else ())
                for a in sr.announce)
            if not still:
                self._local_refresh_jobs.pop((key, vid), None)
                return
            now = self.scheduler.time()
            st = self.store.get(key)
            new_exp = (st.refresh(now, vid, key)
                       if st is not None else None)
            if new_exp is None:
                # local copy is gone (swept or evicted) while the
                # permanent announce lives: re-store it
                self.storage_store(key, value, now)
                new_exp = local_expiration()
            if new_exp is not None:
                self._calendar_add(key, new_exp)
                arm(new_exp - REANNOUNCE_MARGIN)
            else:
                arm(now + max(ttl - REANNOUNCE_MARGIN, 1.0))

        exp = local_expiration()
        arm((exp - REANNOUNCE_MARGIN) if exp is not None
            else self.scheduler.time() + max(ttl - REANNOUNCE_MARGIN, 1.0))

    def _announce(self, key: InfoHash, af: int, value: Value, callback,
                  created: Optional[float], permanent: bool) -> None:
        """(↔ Dht::announce, src/dht.cpp:748-808)"""
        now = self.scheduler.time()
        created = min(now, created) if created is not None else now
        self.storage_store(key, value, created)

        sr = self._searches_of(af).get(key) or self._search(key, af)
        if sr is None:
            if callback:
                callback(False, [])
            return
        sr.done = False
        sr.expired = False
        existing = next((a for a in sr.announce if a.value.id == value.id),
                        None)
        if existing is None:
            sr.announce.append(Announce(permanent, value, created, callback))
            for sn in sr.nodes:
                sn.probe_query = None
                if value.id in sn.acked:
                    sn.acked[value.id] = (None, sn.acked[value.id][1])
        else:
            existing.permanent = permanent
            existing.created = created
            if existing.value != value:
                existing.value = value
                for sn in sr.nodes:
                    if value.id in sn.acked:
                        sn.acked[value.id] = (None, sn.acked[value.id][1])
                    sn.probe_query = None
            if sr.is_announced(value.id):
                if existing.callback:
                    existing.callback(True, [])
                    existing.callback = None
                if callback:
                    callback(True, [])
                return
            else:
                if existing.callback:
                    existing.callback(False, [])
                existing.callback = callback
        self._edit_step(sr, now)

    def listen(self, key: InfoHash, cb, f: Optional[Filter] = None,
               where: Optional[Where] = None) -> int:
        """Subscribe to values under a key (↔ Dht::listen,
        src/dht.cpp:827-867).  Returns a token for cancel_listen.

        Returns ``None`` when ingest backpressure sheds the op at
        admission — never by dropping an established
        listener.  Distinct from the pre-existing ``0`` return, which
        means the callback consumed locally-stored values and stopped
        (a *satisfied* listen, not a refused one); callers that only
        care about "is there a live subscription" can keep testing
        truthiness, the runner distinguishes the two."""
        if not self.wave_builder.admit("listen"):
            return None
        log.debug("[search %s] listen", key, extra={"dht_hash": bytes(key)})
        q = Query(Select(), where or Where())
        self._listener_token += 1
        token = self._listener_token
        gcb = OpValueCache.cache_callback(cb)
        filt = Filters.chain(f, q.where.get_filter())

        token_local = 0
        st = self.store.get(key)
        if st is None and len(self.store) < self.max_store_keys:
            st = self.store[key] = Storage(self.scheduler.time()
                                           + MAX_STORAGE_MAINTENANCE_EXPIRE_TIME)
        if st is not None:
            if not st.empty():
                vals = st.get(filt)
                if vals and not gcb(vals, False):
                    return 0
            st.listener_token += 1
            token_local = st.listener_token
            st.local_listeners[token_local] = LocalListener(q, filt, gcb)
            self._listener_sync(key, st)

        token4 = self._listen_to(key, _socket.AF_INET, gcb, filt, q)
        token6 = self._listen_to(key, _socket.AF_INET6, gcb, filt, q)
        self.listeners[token] = (token_local, token4, token6)
        return token

    def _listen_to(self, key: InfoHash, af: int, cb, f: Optional[Filter],
                   q: Query) -> int:
        """(↔ Dht::listenTo, src/dht.cpp:810-825)"""
        if not self.is_running(af):
            return 0
        sr = self._searches_of(af).get(key) or self._search(key, af)
        if sr is None:
            return 0
        return sr.add_listener(
            cb, f, q, self.scheduler,
            lambda: self._edit_step(sr, self.scheduler.time()))

    def cancel_listen(self, key: InfoHash, token: int) -> bool:
        """(↔ Dht::cancelListen, src/dht.cpp:869-895)"""
        entry = self.listeners.pop(token, None)
        if entry is None:
            return False
        token_local, token4, token6 = entry
        st = self.store.get(key)
        if st is not None and token_local:
            st.local_listeners.pop(token_local, None)
            self._listener_sync(key, st)
        for af, t in ((_socket.AF_INET, token4), (_socket.AF_INET6, token6)):
            sr = self._searches_of(af).get(key)
            if sr is not None and t:
                sr.cancel_listen_token(t, self.scheduler)
        return True

    def get_put(self, key: InfoHash, vid: Optional[int] = None):
        """Pending announced values (↔ Dht::getPut, src/dht.cpp:1076-1120)."""
        if vid is None:
            out = []
            for srs in self.searches.values():
                sr = srs.get(key)
                if sr is not None:
                    out.extend(a.value for a in sr.announce)
            return out
        for srs in self.searches.values():
            sr = srs.get(key)
            if sr is not None:
                for a in sr.announce:
                    if a.value.id == vid:
                        return a.value
        return None

    def cancel_put(self, key: InfoHash, vid: int) -> bool:
        """(↔ Dht::cancelPut, src/dht.cpp:1122-1144)"""
        cancelled = False
        for srs in self.searches.values():
            sr = srs.get(key)
            if sr is not None:
                before = len(sr.announce)
                sr.announce = [a for a in sr.announce if a.value.id != vid]
                cancelled |= len(sr.announce) != before
        return cancelled

    # ================================================================= storage
    def get_local(self, key: InfoHash, f: Optional[Filter] = None
                  ) -> List[Value]:
        st = self.store.get(key)
        return st.get(f) if st is not None else []

    def get_local_by_id(self, key: InfoHash, vid: int) -> Optional[Value]:
        st = self.store.get(key)
        return st.get_by_id(vid) if st is not None else None

    def storage_store(self, key: InfoHash, value: Value, created: float,
                      sa: Optional[SockAddr] = None) -> bool:
        """(↔ Dht::storageStore, src/dht.cpp:1193-1228)"""
        log.debug("[store %s] storing value %x", key, value.id,
                  extra={"dht_hash": bytes(key)})
        now = self.scheduler.time()
        created = min(created, now)
        expiration = created + self.types.get_type(value.type).expiration
        if expiration < now:
            return False
        st = self.store.get(key)
        if st is None:
            if len(self.store) >= self.max_store_keys:
                return False
            st = self.store[key] = Storage(now)
            if self.maintain_storage:
                st.maintenance_time = now + MAX_STORAGE_MAINTENANCE_EXPIRE_TIME
                st.maintenance_armed = True
                self._calendar_add(key, st.maintenance_time)
        bucket = None
        if sa is not None:
            bucket = self.store_quota.setdefault(_quota_key(sa),
                                                 StorageBucket())
        vs, diff = st.store(key, value, created, expiration, bucket)
        if vs is not None:
            self.total_store_size += diff.size_diff
            self.total_values += diff.values_diff
            self._calendar_add(key, expiration)
            # keyspace observatory: stored-key puts count as traffic too
            # — buffered host-side, flushed into the next wave's one
            # scatter-add (never an update of their own)
            self.keyspace.note_stored(key)
            # hot-cache freshness: an observed put — local API put or
            # incoming announce — invalidates the cached entry, so the
            # NEXT get takes the full path and can never be served the
            # stale value set
            self.hotcache.invalidate(key)
            if self.total_store_size > self.max_store_size:
                self._expire_store_all()
            self._storage_changed(key, st, vs.data, diff.values_diff > 0)
        return vs is not None or diff.values_diff == 0

    def _storage_changed(self, key: InfoHash, st: Storage, value: Value,
                         new_value: bool) -> None:
        """Notify local + remote listeners of a new value
        (↔ Dht::storageChanged, src/dht.cpp:1149-1191).

        With ``listen_batching="on"`` the put is
        BUFFERED on the listener table instead — the next ingest
        wave's single ``listener_match`` launch answers which buffered
        keys have listeners, and :meth:`flush_listener_wave`
        dispatches one coalesced callback/``tell_listener`` per wave
        per listener (same values, same per-listener order as the
        synchronous body below — the JAX package pins this in its
        tests/test_listener.py).
        This also batches the request-handler re-storage loops
        (``_on_announce``'s per-value ``storage_store``): a
        listen-triggered store now rides the wave cadence instead of
        probing listener dicts inside the handler."""
        if self.listener_table.note_stored(bytes(key), value, new_value):
            return
        if new_value:
            cbs = []
            for l in st.local_listeners.values():
                if l.filter is None or l.filter(value):
                    cbs.append(l.get_cb)
            for cb in cbs:
                cb([value], False)
        for node, node_listeners in list(st.listeners.items()):
            for sid, l in node_listeners.items():
                f = l.query.where.get_filter()
                if f is not None and not f(value):
                    continue
                ntoken = self._make_token(node.addr, False)
                self.engine.tell_listener(node, sid, key, 0, ntoken,
                                          [], [], [value], l.query)

    # ------------------------------------------------ wave-scale listen/push
    def _listener_live_count(self, kb: bytes) -> int:
        """The listener table's TTL-sweep re-count: how many live
        listeners (local + remote) a key has RIGHT NOW — the sweep
        refreshes rows that still have some and tombstones the rest
        (remote listeners expire silently in ``Storage.expire``; no
        cancel ever reaches :meth:`_listener_sync` for them)."""
        st = self.store.get(InfoHash(kb))
        if st is None:
            return 0
        return (len(st.local_listeners)
                + sum(len(m) for m in st.listeners.values()))

    def _listener_sync(self, key: InfoHash, st: Optional[Storage]) -> None:
        """Re-sync one key's row on the listener table after any
        listener-set mutation (listen/cancel/remote add/expiry sweep)
        — the table tracks exactly the keys with ≥1 listener, so the
        batched match and the synchronous probe answer identically."""
        lt = self.listener_table
        if not lt.enabled:
            return
        n = 0
        if st is not None:
            n = (len(st.local_listeners)
                 + sum(len(m) for m in st.listeners.values()))
        lt.sync_key(bytes(key), n)

    def _arm_listener_flush(self, delay: float) -> None:
        """The table's ``request_flush`` callback: guarantee a
        :meth:`flush_listener_wave` within ``delay`` seconds (idle
        nodes deliver on the deadline; busy nodes usually flush
        earlier, piggybacked on the next ingest wave fire)."""
        t = self.scheduler.time() + max(0.0, delay)
        job = self._listener_flush_job
        if job is not None and not job.cancelled:
            if job.time is not None and t < job.time:
                self._listener_flush_job = self.scheduler.edit(job, t)
        else:
            self._listener_flush_job = self.scheduler.add(
                t, self.flush_listener_wave)

    def flush_listener_wave(self) -> None:
        """Deliver every buffered stored put whose key has listeners:
        ONE ``listener_match`` launch over the buffer (the table's
        :meth:`~opendht_tpu_torch.listeners.ListenerTable.flush`), then one
        coalesced dispatch per listener — local callbacks get the
        key's new values as a single batch, each remote ``(node,
        sid)`` socket gets a single ``tell_listener`` with the full
        filtered value list (↔ the per-value loop in the synchronous
        ``_storage_changed`` body; order within a key is arrival
        order, so per-listener ordering is preserved).  Runs as a
        scheduler job and from the wave builder's fire."""
        self._listener_flush_job = None
        lt = self.listener_table
        if not lt.pending():
            return
        dispatches = values_n = 0
        for kb, items in lt.flush():
            key = InfoHash(kb)
            st = self.store.get(key)
            if st is None:
                continue
            new_vals = [v for v, nv in items if nv]
            all_vals = [v for v, _nv in items]
            if new_vals:
                cbs = []
                for l in st.local_listeners.values():
                    vs = ([v for v in new_vals if l.filter(v)]
                          if l.filter is not None else list(new_vals))
                    if vs:
                        cbs.append((l.get_cb, vs))
                for cb, vs in cbs:
                    cb(vs, False)
                    dispatches += 1
                    values_n += len(vs)
            for node, node_listeners in list(st.listeners.items()):
                for sid, l in node_listeners.items():
                    f = l.query.where.get_filter()
                    vs = ([v for v in all_vals if f(v)]
                          if f is not None else list(all_vals))
                    if not vs:
                        continue
                    ntoken = self._make_token(node.addr, False)
                    self.engine.tell_listener(node, sid, key, 0, ntoken,
                                              [], [], vs, l.query)
                    dispatches += 1
                    values_n += len(vs)
        lt.note_delivered(dispatches, values_n)

    def _storage_add_listener(self, key: InfoHash, node: Node,
                              socket_id: int, query: Query) -> None:
        """(↔ Dht::storageAddListener, src/dht.cpp:1230-1253)"""
        now = self.scheduler.time()
        st = self.store.get(key)
        if st is None:
            if len(self.store) >= self.max_store_keys:
                return
            st = self.store[key] = Storage(now)
        node_listeners = st.listeners.setdefault(node, {})
        l = node_listeners.get(socket_id)
        if l is None:
            vals = st.get(query.where.get_filter())
            if vals:
                closest4 = self.find_closest_nodes(key, _socket.AF_INET)
                closest6 = self.find_closest_nodes(key, _socket.AF_INET6)
                self.engine.tell_listener(
                    node, socket_id, key, WANT4 | WANT6,
                    self._make_token(node.addr, False),
                    closest4, closest6, vals, query)
            node_listeners[socket_id] = Listener(now, query, socket_id)
            self._listener_sync(key, st)
        else:
            l.refresh(now, query)
            self._listener_sync(key, st)

    def _expire_storage(self, key: InfoHash) -> None:
        st = self.store.get(key)
        if st is not None:
            self._expire_store_one(key, st)

    def _expire_store_one(self, key: InfoHash, st: Storage) -> None:
        """(↔ Dht::expireStore(iterator), src/dht.cpp:1255-1297)"""
        size_diff, expired = st.expire(key, self.scheduler.time())
        self.total_store_size += size_diff
        self.total_values -= len(expired)
        # the expiry sweep may have dropped stale remote listeners —
        # re-sync the key's listener-table row
        self._listener_sync(key, st)
        if expired:
            # a cached entry may hold the just-expired values; drop it
            # (the tick re-admits from the store's surviving set)
            self.hotcache.invalidate(key)
            vids = [v.id for v in expired]
            for node, node_listeners in list(st.listeners.items()):
                for sid in node_listeners:
                    ntoken = self._make_token(node.addr, False)
                    self.engine.tell_listener_expired(node, sid, key,
                                                      ntoken, vids)
            for l in list(st.local_listeners.values()):
                l.get_cb(expired, True)

    def _expire_store_all(self) -> None:
        """Expiry sweep + per-IP quota enforcement
        (↔ Dht::expireStore(), src/dht.cpp:1299-1348)."""
        for key in list(self.store):
            st = self.store[key]
            self._expire_store_one(key, st)
            if st.empty() and not st.listeners and not st.local_listeners:
                del self.store[key]
                self._listener_sync(key, None)
        while self.total_store_size > self.max_store_size:
            if not self.store_quota:
                log.warning("no space left: local data consumes all quota")
                break
            largest_key, largest = max(self.store_quota.items(),
                                       key=lambda kv: kv[1].size)
            if largest.size == 0:
                break
            oldest = largest.get_oldest()
            if oldest is None:
                break
            key, vid = oldest
            st = self.store.get(key)
            if st is None:
                break
            diff = st.remove(key, vid)
            self.total_store_size += diff.size_diff
            self.total_values += diff.values_diff
            if not diff.values_diff:
                break
        for k in [k for k, b in self.store_quota.items() if b.size == 0]:
            del self.store_quota[k]

    # ------------------------------------------------- storage calendar
    def _calendar_add(self, key: InfoHash, when: float) -> None:
        """Enqueue `key` for a storage sweep (expiry + republish check)
        at `when`.  Keys binned to the same STORAGE_CALENDAR_QUANTUM
        share ONE scheduler job — the replacement for the
        per-key ``_data_persistence``/``_expire_storage`` jobs whose
        heap entries scaled with the stored-key count.  Bins round UP
        so the sweep never fires before the key is due."""
        b = -int(-when // STORAGE_CALENDAR_QUANTUM)          # ceil
        s = self._storage_calendar.get(b)
        if s is None:
            self._storage_calendar[b] = s = set()
            self.scheduler.add(b * STORAGE_CALENDAR_QUANTUM,
                               lambda: self._calendar_fire(b))
            self._m_calendar_bins.set(len(self._storage_calendar))
        s.add(key)

    def _calendar_fire(self, b: int) -> None:
        """One calendar bin came due: run value expiry per key, then
        republish EVERY due key through one batched resolve.

        Loss profile under a raising callback (a local listener's
        ``get_cb`` runs inside the expiry): the per-key jobs this bin
        replaced lost only the raising key, so the untouched remainder
        of the bin is re-binned for the next tick instead of being
        dropped with the popped set."""
        keys = self._storage_calendar.pop(b, None)
        self._m_calendar_bins.set(len(self._storage_calendar))
        if not keys:
            return
        now = self.scheduler.time()
        due = []
        pending = sorted(keys, key=bytes, reverse=True)
        try:
            while pending:
                key = pending.pop()
                self._expire_storage(key)
                st = self.store.get(key)
                # republish only keys storage_store ARMED (the reference
                # never maintains listen-created storages); due when
                # `maintenance_time <= now`: `<` (not `<=`) so a
                # discrete-event driver landing exactly on
                # maintenance_time still republishes and reschedules
                if st is not None and self.maintain_storage \
                        and st.maintenance_armed \
                        and not now < st.maintenance_time:
                    due.append(key)
        except BaseException:
            for key in pending:
                self._calendar_add(key, now)
            for key in due:
                self._calendar_add(key, now)
            raise
        if due:
            self._storage_maintenance_batched(due)

    def _data_persistence(self, key: InfoHash) -> None:
        """Republish one key's stored values toward closer nodes before
        expiry (↔ Dht::dataPersistence, src/dht.cpp:1840-1852).  Single-
        key entry kept for direct callers; the calendar sweep
        (:meth:`_calendar_fire`) batches whole due sets into one device
        resolve instead of scheduling this per key."""
        st = self.store.get(key)
        now = self.scheduler.time()
        # run when due; `<` (not `<=`) so a discrete-event driver that lands
        # exactly on maintenance_time still republishes and reschedules
        if st is None or now < st.maintenance_time:
            return
        self._storage_maintenance_batched([key])

    def _republish_predicate(self, keys: List[InfoHash], af: int,
                             ks: Optional[List[int]] = None
                             ) -> List[bool]:
        """The "no longer among the k closest" test for MANY keys from
        ONE batched closest-k resolve (↔ the per-key
        ``find_closest_nodes`` + ``xor_cmp`` in Dht::maintainStorage,
        src/dht.cpp:1854-1900).  For each key the last addr-servable
        row stands in for ``find_closest_nodes(key, af)[-1]``, so the
        decision agrees EXACTLY with the scalar path (same addr filter,
        same `< 0` strictness on ties; pinned in
        tests/test_maintenance.py) — including tables smaller than k
        (the last VALID row, not the padded k-th) and empty tables
        (no nodes ⇒ no republish, family keeps responsibility).

        ``ks`` is the per-key replica set from :meth:`_replica_k` — the
        ONE resolve runs at ``max(ks)`` and each key's decision reads
        the last servable row WITHIN its own first ``ks[i]`` columns
        (the top-k prefix of a wider top-k is the narrower top-k, so a
        uniform ks == [8]*n is bit-identical to the unwidened path — hot
        keys widen to 16 without a second launch)."""
        table = self._table(af)
        out = [False] * len(keys)
        if table is None or len(table) == 0 or not keys:
            return out
        if ks is None:
            ks = [TARGET_NODES] * len(keys)
        rows, _dist = table.find_closest(list(keys), k=max(ks),
                                         now=self.scheduler.time())
        last_rows = np.full(len(keys), -1, dtype=np.int64)
        for qi in range(rows.shape[0]):
            for j in range(min(ks[qi], rows.shape[1]) - 1, -1, -1):
                r = int(rows[qi, j])
                if r >= 0 and table.addr_of(r) is not None:
                    last_rows[qi] = r
                    break
        kth_ids = table.ids_of_rows(last_rows)
        for qi, key in enumerate(keys):
            if last_rows[qi] >= 0:
                out[qi] = key.xor_cmp(kth_ids[qi], self.myid) < 0
        return out

    def _storage_maintenance_batched(self, keys: List[InfoHash]) -> int:
        """Republish every due key (↔ Dht::dataPersistence +
        maintainStorage, src/dht.cpp:1840-1900) with ONE closest-k
        device resolve per address family for the WHOLE due set —
        K keys cost one lane-padded launch, not K (the same batching
        move as the lookup path).
        Announce fan-out, responsibility bookkeeping and the
        not-responsible-anywhere clear are per key, exactly as the
        scalar :meth:`_maintain_storage` does them."""
        keys = [k for k in keys if k in self.store]
        if not keys:
            return 0
        now = self.scheduler.time()
        self._m_maint_due.inc(len(keys))
        announced = 0
        still = {bytes(k): {af: True for af in self.tables} for k in keys}
        reg = telemetry.get_registry()
        # adaptive replica widening: keys in the hot set resolve/
        # replicate at closest-16, the rest at closest-8 — ONE launch
        # per family either way (the predicate resolves at max(ks) and
        # reads each key's own k-prefix), riding the same calendar bins
        ks = [self._replica_k(k) for k in keys]
        widened = sum(1 for k_i in ks if k_i > TARGET_NODES)
        if widened:
            reg.counter("dht_cache_republish_widened_total").inc(widened)
        with reg.span("dht_maintenance_republish_seconds"):
            republish = {af: self._republish_predicate(keys, af, ks)
                         for af in self.tables}
        # re-schedule EVERY key before the announce fan-out: a raising
        # callback mid-announce must not silently end the whole due
        # set's maintenance (the per-key jobs lost only the raising
        # key).  maintenance_armed is NOT set here — storage_store owns
        # arming, so a direct _data_persistence call on a listen-created
        # storage republishes once without enrolling it forever (the
        # calendar fire keeps skipping unarmed keys)
        for key in keys:
            st = self.store.get(key)
            if st is not None:
                st.maintenance_time = now + MAX_STORAGE_MAINTENANCE_EXPIRE_TIME
                self._calendar_add(key, st.maintenance_time)
        for af in self.tables:
            for key, do in zip(keys, republish[af]):
                if not do:
                    continue
                st = self.store.get(key)
                if st is None:
                    continue
                for vs in st.values:
                    vt = self.types.get_type(vs.data.type)
                    if vs.created + vt.expiration > \
                            now + MAX_STORAGE_MAINTENANCE_EXPIRE_TIME:
                        self._announce(key, af, vs.data, None,
                                       vs.created, False)
                        announced += 1
                still[bytes(key)][af] = False
        for key in keys:
            st = self.store.get(key)
            if st is None:
                continue
            if self.tables and not any(still[bytes(key)].values()):
                diff = st.clear(key)
                self.total_store_size += diff.size_diff
                self.total_values += diff.values_diff
        self._m_maint_republished.inc(announced)
        tr = tracing.get_tracer()
        if tr.enabled:
            tr.event("maintenance_republish", due=len(keys),
                     announced=announced)
        return announced

    def _maintain_storage(self, key: InfoHash, st: Storage,
                          force: bool = False, done_cb=None) -> int:
        """(↔ Dht::maintainStorage, src/dht.cpp:1854-1900)"""
        now = self.scheduler.time()
        announced = 0
        still_responsible = {af: True for af in self.tables}
        for af in self.tables:
            nodes = self.find_closest_nodes(key, af)
            if not nodes:
                continue
            if force or key.xor_cmp(nodes[-1].id, self.myid) < 0:
                for vs in st.values:
                    vt = self.types.get_type(vs.data.type)
                    if force or vs.created + vt.expiration > \
                            now + MAX_STORAGE_MAINTENANCE_EXPIRE_TIME:
                        self._announce(key, af, vs.data, done_cb,
                                       vs.created, False)
                        announced += 1
                still_responsible[af] = False
        if self.tables and not any(still_responsible.values()):
            diff = st.clear(key)
            self.total_store_size += diff.size_diff
            self.total_values += diff.values_diff
        return announced

    # ========================================================== RPC handlers
    def _on_error(self, req: Request, e: DhtProtocolException) -> None:
        """(↔ Dht::onError, src/dht.cpp:2089-2111)"""
        node = req.node
        if e.code == DhtProtocolException.UNAUTHORIZED:
            log.warning("[node %s] token flush", node.id,
                        extra={"dht_hash": bytes(node.id)})
            node.auth_error()
            node.cancel_request(req)
            table = self._table(node.family)
            if table is not None:
                table.on_auth_error(node.id)
            for sr in self._searches_of(node.family).values():
                for sn in sr.nodes:
                    if sn.node is not node:
                        continue
                    sn.token = b""
                    sn.last_get_reply = _NEVER
                    self._search_send_get_values(sr)
                    self._edit_step(sr, self.scheduler.time())
                    break
        elif e.code == DhtProtocolException.NOT_FOUND:
            node.cancel_request(req)

    def _on_ping(self, _node: Node) -> RequestAnswer:
        return RequestAnswer()

    def _on_find_node(self, node: Node, target: InfoHash, want: int
                      ) -> RequestAnswer:
        """(↔ Dht::onFindNode, src/dht.cpp:2126-2138)"""
        answer = RequestAnswer()
        answer.ntoken = self._make_token(node.addr, False)
        if want < 0:
            want = WANT4 if node.family == _socket.AF_INET else WANT6
        if want & WANT4:
            answer.nodes4 = self.find_closest_nodes(target, _socket.AF_INET)
        if want & WANT6:
            answer.nodes6 = self.find_closest_nodes(target, _socket.AF_INET6)
        return answer

    def _on_get_values(self, node: Node, key: InfoHash, _want: int,
                       query: Query) -> RequestAnswer:
        """(↔ Dht::onGetValues, src/dht.cpp:2140-2161)"""
        if not key:
            raise DhtProtocolException(
                DhtProtocolException.NON_AUTHORITATIVE_INFORMATION,
                DhtProtocolException.GET_NO_INFOHASH)
        answer = RequestAnswer()
        answer.ntoken = self._make_token(node.addr, False)
        answer.nodes4 = self.find_closest_nodes(key, _socket.AF_INET)
        answer.nodes6 = self.find_closest_nodes(key, _socket.AF_INET6)
        st = self.store.get(key)
        if st is not None and not st.empty():
            answer.values = st.get(query.where.get_filter())
        return answer

    def _on_listen(self, node: Node, key: InfoHash, token: bytes,
                   socket_id: int, query: Query) -> RequestAnswer:
        """(↔ Dht::onListen, src/dht.cpp:2237-2254)"""
        if not key:
            raise DhtProtocolException(
                DhtProtocolException.NON_AUTHORITATIVE_INFORMATION,
                DhtProtocolException.LISTEN_NO_INFOHASH)
        if not self._token_match(token, node.addr):
            raise DhtProtocolException(DhtProtocolException.UNAUTHORIZED,
                                       DhtProtocolException.LISTEN_WRONG_TOKEN)
        self._storage_add_listener(key, node, socket_id, query)
        return RequestAnswer()

    def _on_announce(self, node: Node, key: InfoHash, token: bytes,
                     values: List[Value], created: Optional[float]
                     ) -> RequestAnswer:
        """(↔ Dht::onAnnounce, src/dht.cpp:2272-2339)"""
        if not key:
            raise DhtProtocolException(
                DhtProtocolException.NON_AUTHORITATIVE_INFORMATION,
                DhtProtocolException.PUT_NO_INFOHASH)
        if not self._token_match(token, node.addr):
            raise DhtProtocolException(DhtProtocolException.UNAUTHORIZED,
                                       DhtProtocolException.PUT_WRONG_TOKEN)
        # store only if we're plausibly among the SEARCH_NODES closest
        # (src/dht.cpp:2290-2298) — one batched device call.  Keys hot
        # in THIS node's observatory skip the too-far rejection: the
        # widened closest-16 announce fan-out reaches nodes past the
        # closest-8, and refusing their stores would defeat the replica
        # widening the hot set asked for.
        table = self._table(node.family)
        if table is not None and len(table) > 0 \
                and not self.hotcache.is_hot(key):
            rows, _ = table.find_closest([key], k=SEARCH_NODES,
                                         now=self.scheduler.time())
            rows = rows[0][rows[0] >= 0]
            if len(rows) >= TARGET_NODES:
                kth = table.id_of(int(rows[-1]))
                if key.xor_cmp(kth, self.myid) < 0:
                    log.debug("[store %s] announce too far from target", key,
                          extra={"dht_hash": bytes(key)})
                    return RequestAnswer()
        now = self.scheduler.time()
        created = min(created, now) if created is not None else now
        for v in values:
            if v.id == Value.INVALID_ID:
                raise DhtProtocolException(
                    DhtProtocolException.NON_AUTHORITATIVE_INFORMATION,
                    DhtProtocolException.PUT_INVALID_ID)
            lv = self.get_local_by_id(key, v.id)
            if lv is not None:
                if lv != v:
                    vt = self.types.get_type(lv.type)
                    if vt.edit_policy(key, lv, v, node.id, node.addr):
                        self.storage_store(key, v, created, node.addr)
            else:
                vt = self.types.get_type(v.type)
                if vt.store_policy(key, v, node.id, node.addr):
                    self.storage_store(key, v, created, node.addr)
        return RequestAnswer()

    def _on_refresh(self, node: Node, key: InfoHash, token: bytes,
                    vid: int) -> RequestAnswer:
        """(↔ Dht::onRefresh, src/dht.cpp:2341-2360)"""
        if not self._token_match(token, node.addr):
            raise DhtProtocolException(DhtProtocolException.UNAUTHORIZED,
                                       DhtProtocolException.PUT_WRONG_TOKEN)
        st = self.store.get(key)
        new_exp = (st.refresh(self.scheduler.time(), vid, key)
                   if st is not None else None)
        if new_exp is None:
            raise DhtProtocolException(DhtProtocolException.NOT_FOUND,
                                       DhtProtocolException.STORAGE_NOT_FOUND)
        # the sweep scheduled at the original expiration will now keep the
        # value; cover the extended lifetime with a new sweep
        self._calendar_add(key, new_exp)
        return RequestAnswer()

    # ============================================================ maintenance
    def _confirm_nodes(self) -> None:
        """(↔ Dht::confirmNodes, src/dht.cpp:1929-1965)"""
        now = self.scheduler.time()
        soon = False
        for af in self.tables:
            if not self.searches[af] and \
                    self.get_status(af) is NodeStatus.CONNECTED:
                self._search(self.myid, af)
            soon |= self._bucket_maintenance(af)
        if not soon:
            for af in self.tables:
                if self._table_grow_time[af] >= now - 150:
                    soon |= self._neighbourhood_maintenance(af)
        lo, hi = (5, 25) if soon else (60, 180)
        self._next_nodes_confirmation = self.scheduler.edit(
            self._next_nodes_confirmation, now + random.uniform(lo, hi))
        for af in self.tables:
            self._update_status(af)

    def _random_node_near(self, af: int, target: InfoHash) -> Optional[Node]:
        nodes = self.find_closest_nodes(target, af, TARGET_NODES)
        return random.choice(nodes) if nodes else None

    def _bucket_maintenance(self, af: int) -> bool:
        """Random find in stale buckets (↔ Dht::bucketMaintenance,
        src/dht.cpp:1780-1838) — occupancy, staleness AND the
        refresh targets come from ONE fused device pass
        (ops/radix.maintenance_sweep, threading the table's reusable
        PRNG key), and the per-target node picks come from ONE batched
        closest-node resolve instead of a single-target launch (and its
        full 128-lane padding tax) per stale bucket."""
        table = self.tables[af]
        now = self.scheduler.time()
        if len(table) == 0:
            return False
        reg = telemetry.get_registry()
        with reg.span("dht_maintenance_sweep_seconds"):
            stale, targets = table.maintenance_sweep(now)
        self._m_maint_sweeps.inc()
        # publish the stale-bucket fraction + occupancy per family:
        # the health evaluator's ``stale_buckets`` signal
        # reads these gauges instead of launching its own sweep — the
        # fused pass already computed occupancy AND staleness, so
        # health costs no kernel.  Occupancy rides along because the
        # fraction is only statistically meaningful on tables with
        # enough occupied buckets (a 3-node table's 1-2 buckets swing
        # the fraction 0→1 on one never-replied peer).
        # keyed by node AND family: co-resident nodes in one process
        # share the registry (documented semantics), and a
        # node-less key would let node A's sweep overwrite the signal
        # node B's health evaluator reads
        fam = "ipv4" if af == _socket.AF_INET else "ipv6"
        nid = str(self.myid)
        occupied = int(np.count_nonzero(table.bucket_occupancy()))
        reg.gauge("dht_maintenance_stale_fraction", family=fam,
                  node=nid).set(len(stale) / occupied if occupied else 0.0)
        reg.gauge("dht_maintenance_occupied_buckets", family=fam,
                  node=nid).set(occupied)
        if len(stale) == 0:
            return False
        raw = IK.ids_to_bytes(targets)
        tids = [InfoHash(raw[i].tobytes()) for i in range(targets.shape[0])]
        near = self.find_closest_nodes_batched(tids, af, TARGET_NODES)
        sent = False
        for tid, nodes in zip(tids, near):
            n = random.choice(nodes) if nodes else None
            if n is not None and not n.is_pending():
                def on_expired(req, over, _n=n):
                    if over:
                        self._next_nodes_confirmation = self.scheduler.edit(
                            self._next_nodes_confirmation,
                            self.scheduler.time() + MAX_RESPONSE_TIME)
                self.engine.send_find_node(n, tid, self._want(),
                                           None, on_expired)
                sent = True
                self._m_maint_refresh.inc()
        tr = tracing.get_tracer()
        if tr.enabled:
            tr.event("bucket_refresh", af=af, stale=int(len(stale)),
                     sent=sent)
        return sent

    def _neighbourhood_maintenance(self, af: int) -> bool:
        """Find near own id (↔ Dht::neighbourhoodMaintenance,
        src/dht.cpp:1742-1778)."""
        nid = InfoHash(bytes(self.myid)[:-1] + bytes([random.getrandbits(8)]))
        n = self._random_node_near(af, nid)
        if n is None:
            return False
        self.engine.send_find_node(n, nid, self._want(), None, None)
        return True

    def _expire_sweep(self) -> None:
        """(↔ Dht::expire, src/dht.cpp:1916-1927)"""
        now = self.scheduler.time()
        for af, table in self.tables.items():
            table.clear_bad()
        self._expire_store_all()
        self._expire_searches()
        self.scheduler.add(now + random.uniform(2 * 60, 6 * 60),
                           self._expire_sweep)

    def _expire_searches(self) -> None:
        """(↔ Dht::expireSearches, src/dht.cpp:195-210)"""
        t = self.scheduler.time() - SEARCH_EXPIRE_TIME
        for af, srs in self.searches.items():
            dead = [key for key, sr in srs.items()
                    if not sr.callbacks and not sr.announce
                    and not sr.listeners and sr.step_time < t]
            for key in dead:
                sr = srs.pop(key)
                sr.clear()
                self._search_keys[af].remove(bytes(key))

    def connectivity_changed(self, af: int = 0) -> None:
        """Reset liveness state after a network change
        (↔ Dht::connectivityChanged, src/dht.cpp:1351-1367)."""
        fams = [af] if af else list(self.tables)
        self._next_nodes_confirmation = self.scheduler.edit(
            self._next_nodes_confirmation, self.scheduler.time())
        for fam in fams:
            if fam not in self.tables:
                continue
            self.engine.connectivity_changed(fam)
            for sr in self.searches[fam].values():
                for sn in sr.nodes:
                    sn.cancel_listen()
            self.reported_addr = [
                (c, a) for c, a in self.reported_addr if a.family != fam]

    # ================================================================ node ops
    def insert_node(self, node_id: InfoHash, addr: SockAddr) -> None:
        """Seed a known peer without pinging (↔ Dht::insertNode,
        src/dht.cpp:2060-2067)."""
        if addr.family not in (_socket.AF_INET, _socket.AF_INET6):
            return
        self.scheduler.sync_time()
        now = self.scheduler.time()
        n = self.engine.cache.get_node(node_id, addr, now, confirm=False)
        self._on_new_node(n, 0)

    def ping_node(self, addr: SockAddr, done_cb=None) -> None:
        """(↔ Dht::pingNode, src/dht.cpp:2069-2087)"""
        self.scheduler.sync_time()
        af = addr.family
        if af in self._pending_pings:
            self._pending_pings[af] += 1
        node = self.engine.cache.get_node(InfoHash(), addr,
                                          self.scheduler.time(),
                                          confirm=False)

        def on_done(req, answer):
            if af in self._pending_pings:
                self._pending_pings[af] -= 1
            self._update_status(af)
            if done_cb:
                done_cb(True)

        def on_expired(req, over):
            if over:
                if af in self._pending_pings:
                    self._pending_pings[af] -= 1
                if done_cb:
                    done_cb(False)

        self.engine.send_ping(node, on_done, on_expired)

    # ================================================================== status
    def get_nodes_stats(self, af: int) -> NodeStats:
        """(↔ Dht::getNodesStats, src/dht.cpp:1424-1444)"""
        stats = NodeStats()
        table = self._table(af)
        if table is None:
            return stats
        now = self.scheduler.time()
        good = table.good_mask(now)
        reach = table.reachable_mask(now)
        stats.good_nodes = int(np.count_nonzero(good))
        stats.dubious_nodes = int(np.count_nonzero(reach & ~good))
        stats.cached_nodes = len(table._cached)
        incoming = good & (table._time_seen > table._time_reply)
        stats.incoming_nodes = int(np.count_nonzero(incoming))
        occ = table.bucket_occupancy()
        nz = np.nonzero(occ)[0]
        stats.table_depth = int(nz[-1] + 1) if len(nz) else 0
        stats.searches = len(self._searches_of(af))
        stats.node_cache_size = self.engine.cache.size(af)
        return stats

    def get_status(self, af: int = 0) -> NodeStatus:
        """(↔ Dht::getStatus, dht.h:209-218)"""
        if af == 0:
            return max((self.get_status(a) for a in self.tables),
                       key=lambda s: s.value, default=NodeStatus.DISCONNECTED)
        stats = self.get_nodes_stats(af)
        if stats.good_nodes:
            return NodeStatus.CONNECTED
        if self._pending_pings.get(af, 0) or stats.get_known_nodes():
            return NodeStatus.CONNECTING
        return NodeStatus.DISCONNECTED

    def _update_status(self, af: int, *, debounce: bool = False) -> None:
        """Re-evaluate the node status and fire status_cb on change.

        ``debounce=True`` (the per-packet on_new_node path) rates the
        O(table) ``get_nodes_stats`` sweep at once per second of node
        time, rescheduling itself for the window's end so a transition
        is delayed ≤ 1 s, never lost.  Un-debounced, the sweep ran once
        per confirmed node event and was the top profile entry of big
        virtual clusters (381K calls over an 84 s 1024-node run)."""
        now = self.scheduler.time()
        if debounce:
            last = self._status_checked.get(af, float("-inf"))
            if now - last < 1.0:
                if not self._status_recheck.get(af):
                    self._status_recheck[af] = self.scheduler.add(
                        last + 1.0, lambda: self._status_tick(af))
                return
            self._status_checked[af] = now
        st = self.get_status(af)
        if st is not self._last_status.get(af):
            self._last_status[af] = st
            if self.status_cb:
                self.status_cb(
                    self._last_status.get(_socket.AF_INET,
                                          NodeStatus.DISCONNECTED),
                    self._last_status.get(_socket.AF_INET6,
                                          NodeStatus.DISCONNECTED))

    def _status_tick(self, af: int) -> None:
        """The scheduled end-of-window re-evaluation: ALWAYS does the
        full check.  It must not re-enter the window logic — float
        rounding can make ``(last + 1.0) - last < 1.0``, and the
        re-entered window branch would then re-schedule the job at its
        own (already due) fire time: an infinite self-rescheduling loop
        at a frozen virtual clock (measured: 5M ticks in 0.5 virtual
        seconds before this fix)."""
        self._status_recheck.pop(af, None)
        self._status_checked[af] = self.scheduler.time()
        self._update_status(af)

    def network_size_estimate(self, af: int = _socket.AF_INET) -> int:
        table = self._table(af)
        return table.network_size_estimate() if table is not None else 0

    # ======================================================== persist / import
    def export_nodes(self) -> List[dict]:
        """Good nodes for bootstrap persistence (↔ Dht::exportNodes,
        src/dht.cpp:2029-2059)."""
        out = []
        now = self.scheduler.time()
        for table in self.tables.values():
            for node_id, addr in table.export_nodes(now):
                out.append({"id": bytes(node_id), "addr": addr.to_compact()
                            if hasattr(addr, "to_compact") else addr})
        return out

    def export_values(self) -> List[tuple]:
        """(↔ Dht::exportValues, src/dht.cpp:1967-1990)"""
        out = []
        for key, st in self.store.items():
            vals = [(int(vs.created + _wall_offset()), vs.data.get_packed())
                    for vs in st.values]
            out.append((bytes(key), vals))
        return out

    def import_values(self, exported: List[tuple]) -> None:
        """(↔ Dht::importValues, src/dht.cpp:1992-2026)"""
        now = self.scheduler.time()
        for entry in exported:
            # one malformed entry must not abort the rest of the import
            try:
                key_raw, vals = entry
                key = InfoHash(key_raw)
            except Exception:
                log.exception("skipping malformed import entry")
                continue
            for item in vals:
                try:
                    created_wall, packed = item
                    v = Value.from_packed(packed)
                except Exception:
                    log.exception("failed to import value for %s", key,
                                  extra={"dht_hash": bytes(key)})
                    continue
                created = min(now, created_wall - _wall_offset())
                self.storage_store(key, v, created)

    # =============================================================== log dumps
    def get_storage_log(self) -> str:
        """(↔ Dht::getStorageLog, src/dht.cpp:1596-1612)"""
        lines = []
        for key, st in self.store.items():
            listeners = sum(len(m) for m in st.listeners.values())
            lines.append(f"Storage {key} {listeners} list. "
                         f"{st.value_count()} values ({st.total_size} bytes)")
        lines.append(f"Total {self.total_values} values, "
                     f"{self.total_store_size // 1024} KB "
                     f"({self.max_store_size // 1024} KB max)")
        return "\n".join(lines)

    def get_routing_tables_log(self, af: int) -> str:
        table = self._table(af)
        if table is None:
            return ""
        occ = table.bucket_occupancy()
        lines = [f"Routing table (IPv{'4' if af == _socket.AF_INET else '6'}) "
                 f"{len(table)} nodes"]
        for b in np.nonzero(occ)[0]:
            lines.append(f"  bucket {int(b):3d}: {int(occ[b])} nodes")
        return "\n".join(lines)

    def get_searches_log(self, af: int = 0) -> str:
        lines = []
        for fam, srs in self.searches.items():
            if af and fam != af:
                continue
            for key, sr in srs.items():
                lines.append(
                    f"Search {key} IPv{'4' if fam == _socket.AF_INET else '6'}"
                    f" nodes={len(sr.nodes)} done={sr.done} "
                    f"synced={sr.is_synced(self.scheduler.time())} "
                    f"gets={len(sr.callbacks)} puts={len(sr.announce)} "
                    f"listeners={len(sr.listeners)}")
        return "\n".join(lines)

    # ================================================================== types
    def register_type(self, vt) -> None:
        self.types.register_type(vt)

    def get_type(self, type_id: int):
        return self.types.get_type(type_id)

    def set_storage_limit(self, limit: int) -> None:
        self.max_store_size = limit

    def get_node_id(self) -> InfoHash:
        return self.myid

    def shutdown(self, cb=None) -> None:
        """Flush permanent puts and stop (simplified: the reference also
        re-announces permanent values once, dhtrunner.cpp:217-248)."""
        for srs in self.searches.values():
            for sr in srs.values():
                sr.stop()
        if cb:
            cb()


def _wall_offset() -> float:
    """monotonic→wall clock offset for export/import timestamps."""
    import time
    return wall_now() - time.monotonic()
