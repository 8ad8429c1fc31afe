"""The node table: a growable slab of known peers with k-bucket admission
and device-snapshot queries — the port of the JAX package's
``core/table.py``.

Per-packet mutations are O(1) host-side numpy/dict updates; closest-node
queries over large tables or large waves go through an immutable device
:class:`Snapshot` (sorted id keys + permutation + lazily built expanded
table), the counterpart of ``RoutingTable::findClosestNodes``
(src/routing_table.cpp:109-150) and ``NodeCache::getCachedNodes``
(src/node_cache.cpp:41-74) batched over thousands of targets.

**Churn.**  Once a 'reachable' snapshot exists, mutations no longer drop
it: a :class:`ChurnView` over it absorbs each eviction or expiry as one
tombstone bit over the base's sorted positions and each insert or revival
as a row of a small delta slab, and :meth:`NodeTable.view` serves lookups
through ``ops/sorted_table.churn_lookup_topk`` — bit-identical to a full
re-sort.  When the tombstones or the delta pass their limits, the next
base is sorted in the background (a side CUDA stream and an event;
:meth:`NodeTable._start_compaction`) while the old view keeps serving,
and :meth:`NodeTable._maybe_swap` installs it and replays the mutations
that landed meanwhile.

The bucket-maintenance methods (``maintenance_sweep``,
``stale_buckets``, ``refresh_targets``, ``network_size_estimate``) run
``ops/radix.py`` on the table's device; the reusable maintenance key of
the JAX package is a ``torch.Generator`` seeded once per table.

**The sharded resolve.**  ``Snapshot.lookup(mesh=, layout=)`` and
``NodeTable.find_closest(mesh=, layout=)`` row-shard the snapshot over a
``parallel.Mesh``'s ``t`` axis (``parallel/sharded.py``
``sharded_window_launch``: per-shard window top-k with the
``lex_topk_select`` kernel on the card, one merge), uniformly or at the
traffic-weighted boundaries of a reshard layout (``reshard.py``).  The
placed shards are cached per (mesh, layout generation); a wave launched
before a layout swap keeps the operands and perm map it captured.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from .. import telemetry, tracing
from .._device import resolve_device
from ..infohash import InfoHash
from ..ops import ids as IK
from ..ops import radix
from ..ops.sorted_table import (_resolve_merge_pack, churn_lookup_finish,
                                churn_lookup_launch, expand_table,
                                lookup_topk, resolve_uncertified, sort_table,
                                tomb_tensor)

# liveness windows (reference include/opendht/node.h:148-158)
NODE_GOOD_TIME = 120 * 60.0       # replied within 2 h → good
NODE_EXPIRE_TIME = 10 * 60.0      # silent for 10 min → expirable
MAX_RESPONSE_TIME = 1.0           # per-attempt RPC timeout
MAX_AUTH_ERRORS = 3               # 3 strikes → expired (node.h:73-77)

TARGET_NODES = 8                  # k (routing_table.h:26)
SEARCH_NODES = 14                 # search candidate set (dht.h:308)

DELTA_CAP = 4096                  # churn side-slab capacity (inserts
                                  # absorbed without re-sorting)
TOMB_MIN = 1024                   # compact when tombstones exceed
TOMB_FRAC = 16                    # max(TOMB_MIN, n_base // TOMB_FRAC)

# compactions (every full re-sort that folds pending churn into a new
# base), per process, beside each NodeTable's ``compactions``
_M_COMPACTIONS = telemetry.get_registry().counter(
    "dht_table_compactions_total")

# Below these sizes closest-node queries run as an exact numpy scan on
# the host slab instead of the device lookup (a live node's table is
# tens-to-hundreds of rows, where a device round trip dwarfs the scan).
HOST_SCAN_MAX_ROWS = 4096
HOST_SCAN_MAX_QUERIES = 64


@dataclasses.dataclass
class NodeView:
    """Host-side view of one table row (≈ reference Node, node.h)."""

    row: int
    id: InfoHash
    addr: Any
    time_reply: float
    time_seen: float
    expired: bool

    def is_good(self, now: float) -> bool:
        return (not self.expired) and self.time_reply > 0 and \
            now - self.time_reply < NODE_GOOD_TIME


class PendingLookup:
    """Handle for a launched, not yet consumed batched resolve.

    The device work is enqueued when ``lookup_launch`` /
    ``find_closest_launch`` returns; the certificate check, the exact
    fallback, the device→host copy and the row mapping wait in
    :meth:`consume`.  ``ready()`` probes a CUDA event recorded after the
    launch (``event.query()``) without blocking.  ``consume()`` is
    idempotent, so ``lookup(...) = lookup_launch(...).consume()``."""

    __slots__ = ("_finalize", "_probe", "_done", "_result")

    def __init__(self, finalize, probe: Optional[torch.cuda.Event] = None):
        self._finalize = finalize         # () -> result tuple
        self._probe = probe               # CUDA event or None (=ready)
        self._done = False
        self._result = None

    @classmethod
    def resolved(cls, *result):
        """An already-materialized result (host-scan fast path)."""
        pl = cls(None)
        pl._done = True
        pl._result = result if len(result) != 1 else result[0]
        return pl

    def ready(self) -> bool:
        """Non-blocking: True when consume() will not wait on the device."""
        if self._done or self._probe is None:
            return True
        return bool(self._probe.query())

    def consume(self):
        """Wait for the device work, resolve uncertified rows, map, cache."""
        if not self._done:
            self._result = self._finalize()
            self._done = True
            self._finalize = None
            self._probe = None
        return self._result


class Snapshot:
    """Immutable device view: lexicographically sorted id keys + row map."""

    def __init__(self, sorted_ids, perm, n_valid: int, version: int,
                 mask_key):
        self.sorted_ids = sorted_ids      # int32 keys [cap, 5] on device
        self.perm = perm                  # int32 [cap] sorted→row (-1 pad)
        self.n_valid = int(n_valid)
        self.version = version
        self.mask_key = mask_key
        self._expanded = None             # lazy expand_table
        self._tp_state = None             # lazy (mesh, key, placed, perm)
        self._reshard_rows = None         # lazy ((gen, t), rows)

    @property
    def device(self) -> torch.device:
        return self.sorted_ids.device

    def lookup(self, queries, *, k: int = TARGET_NODES, window: int = 128,
               mesh=None, layout=None):
        """Batched exact k-closest.  queries: uint32 [Q,5] numpy or a key
        tensor on the snapshot's device.  Returns (rows [Q,k] int32, dist
        [Q,k,5] uint32) numpy, -1 / all-ones padded.

        Unsharded, runs the expanded row-gather route with the ``"auto"``
        select (the ``window_select`` kernel on the card); ``window`` is
        then ignored (the candidate window is the expansion's 192 rows).

        ``mesh`` (``config.resolve_mesh_t``): a (q=1, t) mesh row-shards
        the resolve — per-shard ``window``-wide top-k over each shard's
        contiguous slice of the sorted slab (the ``lex_topk_select``
        kernel on the card), one merge (parallel/sharded.py).
        ``layout`` (load-aware resharding): an installed
        :class:`~opendht_tpu_torch.reshard.ReshardLayout` moves the shard
        boundaries to traffic-weighted row splits of THIS snapshot.  The
        results are the same either way."""
        return self.lookup_launch(queries, k=k, window=window, mesh=mesh,
                                  layout=layout).consume()

    def lookup_launch(self, queries, *, k: int = TARGET_NODES,
                      window: int = 128, mesh=None,
                      layout=None) -> PendingLookup:
        """Async form of :meth:`lookup`: the lookup is enqueued before this
        returns; the certificate check and fallback wait in ``consume()``."""
        q = queries if isinstance(queries, torch.Tensor) \
            else IK.to_keys(queries, self.device)
        if mesh is not None and mesh.shape.get("t", 1) > 1:
            return self._lookup_sharded_launch(mesh, q, k, window, layout)
        if self._expanded is None:
            self._expanded = expand_table(self.sorted_ids)
        dist, idx, cert = lookup_topk(self.sorted_ids, self.n_valid, q, k=k,
                                      expanded=self._expanded,
                                      fallback=False)
        probe = None
        if q.is_cuda:
            probe = torch.cuda.Event()
            probe.record(torch.cuda.current_stream(q.device))
        sorted_ids, n_valid, perm = self.sorted_ids, self.n_valid, self.perm

        def finalize():
            d, i, _ = resolve_uncertified(sorted_ids, n_valid, q, dist, idx,
                                          cert, k)
            rows = torch.where(i >= 0, perm[i.clamp(min=0)], -1)
            return rows.cpu().numpy().astype(np.int32), IK.from_keys(d)

        return PendingLookup(finalize, probe=probe)

    def reshard_boundary_rows(self, layout, n_t: int):
        """Traffic-weighted interior row boundaries of THIS snapshot for an
        installed reshard layout — re-derived per snapshot (the layout
        carries bin loads, not rows, since raw row offsets go stale
        across rebuilds), cached by ``(layout.gen, t)``.

        Returns ``n_t - 1`` nondecreasing row indices into the valid
        prefix of the sorted order (parallel/partition.py
        ``solve_shard_boundaries``).  The per-bin row counts come from one
        ``searchsorted`` of the 255 bin edges over the sorted top limb, on
        the device; only the counts are read back."""
        key = (int(layout.gen), int(n_t))
        cached = self._reshard_rows
        if cached is not None and cached[0] == key:
            return cached[1]
        from ..parallel.partition import solve_shard_boundaries
        n = self.n_valid
        # bin edge b<<24 as a key (signed order = unsigned order)
        edges = torch.tensor((np.arange(1, 256, dtype=np.int64) << 24)
                             - (1 << 31), dtype=torch.int32,
                             device=self.device)
        counts = torch.searchsorted(self.sorted_ids[:n, 0].contiguous(),
                                    edges, side="left").cpu().numpy()
        bin_rows = np.diff(np.concatenate([[0], counts, [n]]))
        rows = solve_shard_boundaries(
            bin_rows, layout.bin_loads, n_t,
            load_weight=layout.load_weight)
        self._reshard_rows = (key, rows)
        return rows

    def _shard_state(self, mesh, layout=None):
        """Row-shard this snapshot's sorted slab over the mesh ``t`` axis
        ONCE and cache the placed operands; later waves reuse them.

        With a reshard ``layout`` the split is the traffic-weighted one:
        shard ``i`` owns rows ``[b_i, b_{i+1})`` of the sorted order,
        realized as equal-capacity slabs (rearranged rows + per-shard
        widths).  The cache key includes ``layout.gen``: a swap is one
        attribute write on the DHT loop, the NEXT wave rebuilds here (row
        movement, never a re-sort), and a wave already in flight keeps
        the operands and perm map its launch captured.

        Returns ``(placed, perm_map)``: ``perm_map`` is None for the
        uniform split (global sorted positions map through ``self.perm``)
        or the slab-position → slab-row map of the weighted one, on the
        snapshot's device."""
        st = self._tp_state
        key = (None if layout is None
               else (int(layout.gen), int(mesh.shape["t"])))
        if st is not None and st[0] is mesh and st[1] == key:
            return st[2], st[3]
        from ..parallel import partition
        n_t = int(mesh.shape["t"])
        n = self.n_valid
        dev = self.device
        if layout is not None:
            bounds, widths, cap = partition.weighted_bounds(
                self.reshard_boundary_rows(layout, n_t), n, n_t)
            ids_re = partition.weighted_slabs(self.sorted_ids, bounds,
                                              widths, cap, IK.FLIP)
            perm_map = partition.weighted_slabs(self.perm, bounds, widths,
                                                cap, -1)
            nv = widths.astype(np.int32)
            shard_n = cap
        else:
            ids_re = self.sorted_ids
            pad = (-ids_re.shape[0]) % n_t
            if pad:
                # pad rows land past the valid prefix (the last shard),
                # and every shard excludes rows beyond its local n_valid
                ids_re = torch.cat([ids_re, torch.full(
                    (pad, IK.N_LIMBS), IK.FLIP, dtype=torch.int32,
                    device=dev)])
            shard_n = ids_re.shape[0] // n_t
            nv = np.clip(n - np.arange(n_t) * shard_n, 0,
                         shard_n).astype(np.int32)
            perm_map = None
        # per-shard LOCAL sorted positions: the sharded lookup offsets
        # them by the shard base, giving global slab positions that the
        # perm map turns into slab rows
        perm_local = torch.arange(shard_n, dtype=torch.int32,
                                  device=dev).repeat(n_t)
        placed = partition.shard_put(
            mesh, {"sorted_ids": ids_re, "perm": perm_local,
                   "n_valid": torch.from_numpy(nv)},
            partition.TABLE_AXIS_RULES)
        self._tp_state = (mesh, key, placed, perm_map)
        return placed, perm_map

    def _lookup_sharded_launch(self, mesh, q, k: int, window: int,
                               layout=None) -> PendingLookup:
        from ..parallel.sharded import sharded_window_launch
        placed, perm_map = self._shard_state(mesh, layout)
        launch = sharded_window_launch(
            mesh, q, placed["sorted_ids"], placed["perm"],
            placed["n_valid"], k=k, window=window)
        # captured AT LAUNCH: a reshard swap between launch and consume
        # must not remap this wave's positions through the new layout
        perm = self.perm if perm_map is None else perm_map

        def finalize():
            dist, gpos = launch.finish()
            gpos = gpos.to(perm.device)
            rows = torch.where(gpos >= 0, perm[gpos.clamp(min=0).long()], -1)
            return rows.cpu().numpy().astype(np.int32), IK.from_keys(dist)

        return PendingLookup(finalize, probe=launch.event)


class ChurnView:
    """Append+tombstone view over an immutable base :class:`Snapshot`
    (reference mutation path src/routing_table.cpp:204-262).

    Mutations since the base was built are absorbed host-side in O(1):
    evictions set one bit in a packed tombstone mask over *sorted
    positions* (dead rows stay in the device array as mere sort keys);
    inserts land in a small delta slab.  :meth:`lookup` runs
    ``churn_lookup_topk`` — a tombstone-masked window top-k over the
    base, a window top-k over the delta (its own small sorted + expanded
    table, re-sorted lazily per mutation batch) and one merge — exactly
    as a full re-sort would answer.  The tombstone words re-upload whole
    when dirty (1.25 MB per 10M rows); the delta re-sorts on the device.

    The host copy of the base's ``perm`` (the sorted→row map the results
    go through; 40 MB at 10M rows) is taken here, when the view is built
    at a snapshot or a swap, never during a lookup.
    """

    def __init__(self, base: Snapshot, cap_rows: int,
                 delta_cap: int = DELTA_CAP):
        self.base = base
        n = base.sorted_ids.shape[0]
        perm = base.perm.cpu().numpy()
        self.n_base = int((perm >= 0).sum())
        self._perm = perm
        # slab row -> sorted position AT BASE-BUILD TIME.  Never re-read
        # after the row is freed and reused: inserts always go to the
        # delta, and note_evict checks delta membership first, so a stale
        # mapping only ever tombstones the id that occupied the position.
        self.inv_perm = np.full(cap_rows, -1, dtype=np.int64)
        pos = np.nonzero(perm >= 0)[0]
        self.inv_perm[perm[pos]] = pos
        self.tomb_np = np.zeros((n + 31) // 32, dtype=np.uint32)
        self.tomb_count = 0
        self.delta_ids_np = np.zeros((delta_cap, IK.N_LIMBS), dtype=np.uint32)
        self.delta_rows = np.full(delta_cap, -1, dtype=np.int64)
        self._delta_pos: dict[int, int] = {}
        self.n_delta = 0
        self._dev_tomb = None
        self._dev_delta = None    # (d_sorted, d_expanded, d_perm) on device
        self._dirty_tomb = True
        self._dirty_delta = True

    @property
    def pending(self) -> int:
        return self.tomb_count + self.n_delta

    def grow_delta(self) -> None:
        """Double the delta slab, so an overflowing delta keeps absorbing
        inserts while a background compaction builds the next base."""
        dcap = self.delta_ids_np.shape[0]
        self.delta_ids_np = np.concatenate(
            [self.delta_ids_np, np.zeros_like(self.delta_ids_np)])
        self.delta_rows = np.concatenate(
            [self.delta_rows, np.full(dcap, -1, dtype=np.int64)])
        self._dirty_delta = True

    def note_insert(self, row: int, limbs) -> bool:
        """Absorb a newly live slab row.  False = delta slab full (the
        caller must compact).  The row must not be live in the base:
        NodeTable routes here only rows that are new, revived after an
        expiry (whose base position the expiry tombstoned), or absent
        from the base mask at build time, so live ids stay unique across
        base and delta and the merge order stays exact."""
        if row in self._delta_pos:
            return True
        if self.n_delta >= self.delta_ids_np.shape[0]:
            return False
        s = self.n_delta
        self.delta_ids_np[s] = limbs
        self.delta_rows[s] = row
        self._delta_pos[row] = s
        self.n_delta = s + 1
        self._dirty_delta = True
        return True

    def note_evict(self, row: int) -> None:
        """Absorb a row leaving the live set (evicted or expired).  Delta
        membership is checked before the base mapping, so a reused slab
        row never tombstones another id's position."""
        s = self._delta_pos.pop(row, None)
        if s is not None:
            last = self.n_delta - 1
            if s != last:
                self.delta_ids_np[s] = self.delta_ids_np[last]
                lrow = int(self.delta_rows[last])
                self.delta_rows[s] = lrow
                self._delta_pos[lrow] = s
            self.delta_rows[last] = -1
            self.n_delta = last
            self._dirty_delta = True
            return
        if 0 <= row < len(self.inv_perm):
            p = int(self.inv_perm[row])
            if p >= 0 and not (int(self.tomb_np[p >> 5]) >> (p & 31)) & 1:
                self.tomb_np[p >> 5] |= np.uint32(1) << (p & 31)
                self.tomb_count += 1
                self._dirty_tomb = True

    def lookup(self, queries, *, k: int = TARGET_NODES, window: int = 128):
        """Batched exact k-closest over (live base ∪ delta) — the
        contract of :meth:`Snapshot.lookup` (``window`` ignored)."""
        return self.lookup_launch(queries, k=k, window=window).consume()

    def lookup_launch(self, queries, *, k: int = TARGET_NODES,
                      window: int = 128) -> PendingLookup:
        """Async form of :meth:`lookup`.  The tombstone / delta refresh
        and the churn lookup are enqueued here without a host sync; the
        one flag read, the repair of flagged rows and the row mapping
        wait in ``consume()``.  The finalize closure captures
        ``delta_rows``, the delta's sorted→slot map and ``_perm`` at
        launch: ``note_evict`` swap-removes delta slots in place and a
        delta re-sort replaces the map, so mapping through the live view
        at consume could diverge from what this launch saw.

        Telemetry: ``dht_churn_lookups_total{pack=}`` and the
        ``dht_churn_tombstones`` / ``dht_churn_delta_rows`` gauges at
        launch; ``dht_churn_lookup_seconds`` observes the launch's host
        time plus the wait in ``consume()``."""
        reg = telemetry.get_registry()
        reg.counter("dht_churn_lookups_total",
                    pack=_resolve_merge_pack("auto", k)).inc()
        reg.gauge("dht_churn_tombstones").set(self.tomb_count)
        reg.gauge("dht_churn_delta_rows").set(self.n_delta)
        base = self.base
        dev = base.device
        q = queries if isinstance(queries, torch.Tensor) \
            else IK.to_keys(queries, dev)
        if base._expanded is None:
            base._expanded = expand_table(base.sorted_ids)
        if self._dirty_tomb or self._dev_tomb is None:
            self._dev_tomb = tomb_tensor(self.tomb_np, dev)
            self._dirty_tomb = False
        if self._dirty_delta or self._dev_delta is None:
            dcap = self.delta_ids_np.shape[0]
            # slots are prefix-dense
            dvalid = torch.arange(dcap, device=dev) < self.n_delta
            ds, dp, _ = sort_table(IK.to_keys(self.delta_ids_np, dev), dvalid)
            self._dev_delta = (ds, expand_table(ds, stride=32), dp)
            self._dirty_delta = False
        ds, de, d_perm = self._dev_delta
        t0 = time.perf_counter()
        launch = churn_lookup_launch(base.sorted_ids, base._expanded,
                                     base.n_valid, self._dev_tomb, ds, de,
                                     self.n_delta, q, k=k)
        dispatch_s = time.perf_counter() - t0
        probe = None
        if q.is_cuda:
            probe = torch.cuda.Event()
            probe.record(torch.cuda.current_stream(q.device))
        n = base.sorted_ids.shape[0]
        base_perm = self._perm
        delta_rows = self.delta_rows.copy()
        hist = reg.histogram("dht_churn_lookup_seconds")

        def finalize():
            t1 = time.perf_counter()
            dist, enc, _ = churn_lookup_finish(launch)
            enc = enc.cpu().numpy()
            hist.observe(dispatch_s + (time.perf_counter() - t1))
            # enc in [n, n+D) is a delta sorted position → slot → slab row
            dp = d_perm.cpu().numpy()
            dslot = dp[np.clip(enc - n, 0, len(dp) - 1)]
            rows = np.where(
                enc < 0, -1,
                np.where(enc < n, base_perm[np.clip(enc, 0, n - 1)],
                         delta_rows[np.clip(dslot, 0, None)]))
            return rows.astype(np.int32), IK.from_keys(dist)

        return PendingLookup(finalize, probe=probe)


class NodeTable:
    """Growable peer slab with k-bucket admission (one per address family,
    like the reference's buckets4/buckets6, dht.h:370-381).

    ``device``: where snapshots and device lookups live; None means the
    CUDA card and raises when there is none.  ``delta_cap``: the churn
    view's delta slab capacity."""

    def __init__(self, self_id: InfoHash, *, k: int = TARGET_NODES,
                 capacity: int = 1024, delta_cap: int = DELTA_CAP,
                 device=None):
        self.device = resolve_device(device)
        self.self_id = self_id
        self.self_limbs = IK.ids_from_bytes(bytes(self_id)).reshape(-1)
        self.k = k
        self._cap = capacity
        self._delta_cap = delta_cap
        self._churn: Optional[ChurnView] = None
        self.compactions = 0              # full re-sorts folding churn
        #: whether the most recent find_closest ran the t-sharded resolve
        #: (host scans and churn views reset it)
        self.last_resolve_sharded = False
        self._ids = np.zeros((capacity, IK.N_LIMBS), dtype=np.uint32)
        self._valid = np.zeros(capacity, dtype=bool)
        self._expired = np.zeros(capacity, dtype=bool)
        self._time_reply = np.zeros(capacity, dtype=np.float64)
        self._time_seen = np.zeros(capacity, dtype=np.float64)
        self._auth_err = np.zeros(capacity, dtype=np.int8)
        self._bucket = np.zeros(capacity, dtype=np.int16)
        self._addrs: list = [None] * capacity
        self._row_of: dict[bytes, int] = {}
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        self._bucket_count = np.zeros(radix.ID_BITS, dtype=np.int32)
        # one cached replacement candidate per bucket (↔ Bucket::cached,
        # routing_table.h:31-45)
        self._cached: dict[int, tuple[bytes, Any]] = {}
        self._version = 0
        self._snap: Optional[Snapshot] = None
        self._maint_gen: Optional[torch.Generator] = None
        # in-flight background compaction: the next base being sorted on
        # the side stream + the mutation log to replay at swap
        self._pending_base: Optional[dict] = None
        self._side_stream = None

    # ------------------------------------------------------------------ size
    def __len__(self) -> int:
        return len(self._row_of)

    @property
    def capacity(self) -> int:
        return self._cap

    def _grow(self) -> None:
        old = self._cap
        new = old * 2
        for name in ("_ids", "_valid", "_expired", "_time_reply", "_time_seen",
                     "_auth_err", "_bucket"):
            arr = getattr(self, name)
            grown = np.zeros((new,) + arr.shape[1:], dtype=arr.dtype)
            grown[:old] = arr
            setattr(self, name, grown)
        self._addrs.extend([None] * old)
        self._free.extend(range(new - 1, old - 1, -1))
        self._cap = new

    # ------------------------------------------------------------ liveness
    def good_mask(self, now: float) -> np.ndarray:
        return (
            self._valid
            & ~self._expired
            & (self._time_reply > 0)
            & (now - self._time_reply < NODE_GOOD_TIME)
        )

    def reachable_mask(self, now: float) -> np.ndarray:
        """Valid, non-expired nodes (good or dubious)."""
        return self._valid & ~self._expired

    def is_good(self, row: int, now: float) -> bool:
        return bool(self.good_mask(now)[row])

    # ------------------------------------------------------------- mutation
    def _touch(self, count_compaction: bool = True) -> None:
        """A change the churn view cannot absorb: drop the snapshot, the
        churn view and any pending compaction (the next view rebuilds).
        A view carrying pending churn counts as a compaction, since the
        rebuild folds that churn into the next base; the replay-overflow
        path of :meth:`_maybe_swap` has booked its compaction already and
        passes ``count_compaction=False``."""
        if count_compaction and self._churn is not None \
                and self._churn.pending:
            self.compactions += 1
            _M_COMPACTIONS.inc()
        self._version += 1
        self._snap = None
        self._churn = None
        self._pending_base = None        # built from a stale state

    # -------------------------------------------- non-blocking compaction
    def _start_compaction(self) -> None:
        """Sort the next base (the current host state) without blocking:
        on the card the sort runs on a side stream and records an event,
        while the old snapshot and churn view keep serving every lookup
        exactly; :meth:`_maybe_swap` installs the result once the event
        has fired.  Mutations that land meanwhile are logged and replayed
        into the new view.  ``n_valid`` comes from the host mask, so the
        swap needs no device read; on the CPU the sort is done at once."""
        if self._pending_base is not None or self._snap is None:
            return
        m = self.reachable_mask(time.monotonic())
        dev = self.device
        ids = IK.to_keys(self._ids, dev)
        valid = torch.from_numpy(m).to(dev)
        event = None
        if dev.type == "cuda":
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(dev)
            side = self._side_stream
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                sorted_ids, perm, _ = sort_table(ids, valid)
                event = torch.cuda.Event()
                event.record(side)
            # the inputs were made on the current stream: keep their
            # memory until the side stream is done with them
            ids.record_stream(side)
            valid.record_stream(side)
        else:
            sorted_ids, perm, _ = sort_table(ids, valid)
        self._pending_base = {"sorted": sorted_ids, "perm": perm,
                              "n_valid": int(m.sum()), "event": event,
                              "mutlog": []}

    def _maybe_swap(self, force: bool = False) -> bool:
        """Install a finished background compaction; with ``force`` wait
        for it.  Replays the post-dispatch mutation log into the new
        churn view so the swap is exact."""
        pb = self._pending_base
        if pb is None:
            return False
        event = pb["event"]
        if event is not None:
            if not force and not event.query():
                return False
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            # made on the side stream, read from now on on this one
            pb["sorted"].record_stream(cur)
            pb["perm"].record_stream(cur)
        snap = Snapshot(pb["sorted"], pb["perm"], pb["n_valid"],
                        self._version, ("reachable", 0))
        self._snap = snap
        self._churn = ChurnView(snap, self._cap, self._delta_cap)
        self._pending_base = None
        self.compactions += 1
        _M_COMPACTIONS.inc()
        tr = tracing.get_tracer()
        if tr.enabled:
            tr.event("table_churn_swap", replayed=len(pb["mutlog"]),
                     compactions=self.compactions)
        for op, row in pb["mutlog"]:
            if op == "i":
                if not self._churn.note_insert(row, self._ids[row]):
                    # replay overflow (a log larger than a fresh slab):
                    # full rebuild; this swap is counted already
                    self._touch(count_compaction=False)
                    return True
            else:
                self._churn.note_evict(row)
        return True

    def _tomb_limit(self) -> int:
        ch = self._churn
        n = ch.n_base if ch is not None else 0
        return max(TOMB_MIN, n // TOMB_FRAC)

    def _delta_growth_limit(self) -> int:
        """Overflow headroom: the delta may double up to 8× its
        configured capacity while a background compaction is pending."""
        return 8 * self._delta_cap

    def _absorb_insert(self, row: int) -> None:
        """A slab row became live.  Absorbed into the churn delta when a
        'reachable' base view is active (``_version`` untouched); else
        full invalidation.  A full delta doubles (bounded) and starts a
        background compaction, with the old view serving meanwhile."""
        ch = self._churn
        if ch is not None and self._snap is not None:
            if self._pending_base is not None:
                self._pending_base["mutlog"].append(("i", row))
            if ch.note_insert(row, self._ids[row]):
                return
            if ch.delta_ids_np.shape[0] < self._delta_growth_limit():
                ch.grow_delta()
                self._start_compaction()
                if ch.note_insert(row, self._ids[row]):
                    return
        self._touch()                   # growth exhausted / no churn view

    def _absorb_evict(self, row: int) -> None:
        """A slab row left the live set (evicted or expired)."""
        ch = self._churn
        if ch is not None and self._snap is not None:
            if self._pending_base is not None:
                self._pending_base["mutlog"].append(("e", row))
            ch.note_evict(row)
            if ch.tomb_count > self._tomb_limit():
                self._start_compaction()    # due; built in the background
            return
        self._touch()

    def insert(self, node_id: InfoHash, addr: Any, now: Optional[float] = None,
               *, confirm: int = 0) -> Optional[int]:
        """Learn about a peer (↔ RoutingTable::onNewNode,
        src/routing_table.cpp:204-262).

        confirm: 0 = hearsay, 1 = sent us a query, 2 = replied to us.
        Returns the row, or None if the bucket is full of live nodes (the
        peer is kept as the bucket's cached candidate instead).
        """
        if now is None:
            now = time.monotonic()
        key = bytes(node_id)
        if key == bytes(self.self_id):
            return None
        row = self._row_of.get(key)
        if row is not None:
            self._time_seen[row] = now
            if confirm >= 2:
                if self._expired[row]:
                    # revival: dead in every view (its base copy, if any,
                    # was tombstoned at expiry): re-enters as a delta row
                    self._expired[row] = False
                    self._absorb_insert(row)
                elif self._time_reply[row] == 0:
                    # first reply: only a 'good'-mask snapshot goes stale
                    if self._snap is not None \
                            and self._snap.mask_key[0] == "good":
                        self._touch()
                self._time_reply[row] = now
                self._auth_err[row] = 0
            if addr is not None:
                self._addrs[row] = addr
            return row

        b = min(InfoHash.common_bits(self.self_id, node_id), radix.MAX_BUCKET)
        if self._bucket_count[b] >= self.k:
            # replace an expired node in this bucket if any
            rows = np.nonzero(self._valid & (self._bucket == b) & self._expired)[0]
            if len(rows) == 0:
                self._cached[b] = (key, addr)
                return None
            self._evict_row(int(rows[0]))

        if not self._free:
            self._grow()
        row = self._free.pop()
        self._ids[row] = IK.ids_from_bytes(key)
        self._valid[row] = True
        self._expired[row] = False
        self._auth_err[row] = 0
        self._time_seen[row] = now
        self._time_reply[row] = now if confirm >= 2 else 0.0
        self._bucket[row] = b
        self._addrs[row] = addr
        self._row_of[key] = row
        self._bucket_count[b] += 1
        self._absorb_insert(row)
        return row

    def _evict_row(self, row: int) -> None:
        kb = IK.ids_to_bytes(self._ids[row:row + 1]).tobytes()
        self._row_of.pop(kb, None)
        self._bucket_count[self._bucket[row]] -= 1
        self._valid[row] = False
        self._addrs[row] = None
        self._free.append(row)
        self._absorb_evict(row)

    def remove(self, node_id: InfoHash) -> None:
        row = self._row_of.get(bytes(node_id))
        if row is not None:
            self._evict_row(row)
            # promote the bucket's cached candidate, if one is waiting
            b = min(InfoHash.common_bits(self.self_id, node_id), radix.MAX_BUCKET)
            cand = self._cached.pop(b, None)
            if cand is not None:
                self.insert(InfoHash(cand[0]), cand[1])

    def on_reply(self, node_id: InfoHash, now: Optional[float] = None) -> None:
        """Peer answered a request (↔ Node::received)."""
        self.insert(node_id, None, now, confirm=2)

    def on_expired(self, node_id: InfoHash) -> None:
        """Request to the peer timed out 3× (↔ Node::setExpired)."""
        row = self._row_of.get(bytes(node_id))
        if row is not None and not self._expired[row]:
            self._expired[row] = True
            self._absorb_evict(row)

    def on_auth_error(self, node_id: InfoHash) -> None:
        """Crypto failure from this peer; 3 strikes expire it (node.h:73-77)."""
        row = self._row_of.get(bytes(node_id))
        if row is not None:
            self._auth_err[row] += 1
            if self._auth_err[row] >= MAX_AUTH_ERRORS \
                    and not self._expired[row]:
                self._expired[row] = True
                self._absorb_evict(row)

    def clear_bad(self) -> None:
        """Drop expired nodes (↔ NodeCache::clearBadNodes on connectivity
        change, src/node_cache.cpp:76-85)."""
        for row in np.nonzero(self._valid & self._expired)[0]:
            self._evict_row(int(row))

    def bulk_load(self, ids_u32: np.ndarray, now: float = 0.0,
                  *, replied: bool = True, addrs=None,
                  buckets=None) -> None:
        """Fill the slab from an [N,5] uint32 id matrix (simulation-scale
        path: buckets computed on the table's device).  ``addrs``: one
        address per row, or one shared by all.  ``buckets``: optional
        precomputed ``common_bits(self, id)`` per row.

        Ids already in the table and batch-internal duplicates are not
        added again (live ids stay unique across base and delta); a known
        id is refreshed as ``insert`` would (with ``replied=True`` an
        expired one revives), exactly as in the JAX package.  New rows
        go into the churn delta when they fit, else the view rebuilds."""
        ids_u32 = np.asarray(ids_u32, dtype=np.uint32)
        raw = IK.ids_to_bytes(ids_u32)
        per_row_addrs = isinstance(addrs, (list, tuple, np.ndarray))
        seen: set = set()
        keep: list = []
        for i in range(ids_u32.shape[0]):
            kb = raw[i].tobytes()
            if kb in seen:
                continue
            row = self._row_of.get(kb)
            if row is not None:
                self._time_seen[row] = now
                if addrs is not None:
                    self._addrs[row] = addrs[i] if per_row_addrs else addrs
                if replied:
                    if self._expired[row]:
                        self._expired[row] = False      # revival
                        self._absorb_insert(row)
                    elif self._time_reply[row] == 0 \
                            and self._snap is not None \
                            and self._snap.mask_key[0] == "good":
                        self._touch()
                    self._time_reply[row] = now
                    self._auth_err[row] = 0
                continue
            seen.add(kb)
            keep.append(i)
        if len(keep) != ids_u32.shape[0]:
            if per_row_addrs:
                addrs = [addrs[i] for i in keep]
            if buckets is not None:
                buckets = np.asarray(buckets)[keep]
            ids_u32 = ids_u32[keep]
            raw = raw[keep]
        n = ids_u32.shape[0]
        if n == 0:
            return
        while self._cap < len(self) + n:
            self._grow()
        rows = np.array([self._free.pop() for _ in range(n)], dtype=np.int64)
        self._ids[rows] = ids_u32
        self._valid[rows] = True
        self._expired[rows] = False
        self._auth_err[rows] = 0
        self._time_seen[rows] = now
        self._time_reply[rows] = now if replied else 0.0
        if buckets is not None:
            b = np.minimum(np.asarray(buckets), radix.MAX_BUCKET)
        else:
            b = radix.bucket_of(IK.to_keys(self.self_limbs, self.device),
                                IK.to_keys(ids_u32, self.device)).cpu().numpy()
        self._bucket[rows] = b.astype(np.int16)
        np.add.at(self._bucket_count, b, 1)
        for i, row in enumerate(rows):
            self._row_of[raw[i].tobytes()] = int(row)
            if addrs is not None:
                self._addrs[int(row)] = addrs[i] if per_row_addrs else addrs
        if self._churn is not None and self._snap is not None \
                and self._churn.n_delta + n <= self.delta_capacity:
            # through _absorb_insert, not note_insert: a pending
            # background compaction must see these rows in its log, or
            # they would vanish from the serving view at the swap
            for row in rows:
                self._absorb_insert(int(row))
        else:
            self._touch()

    # --------------------------------------------------------------- reads
    def get_view(self, row: int) -> NodeView:
        return NodeView(
            row=row,
            id=InfoHash(IK.ids_to_bytes(self._ids[row]).tobytes()),
            addr=self._addrs[row],
            time_reply=float(self._time_reply[row]),
            time_seen=float(self._time_seen[row]),
            expired=bool(self._expired[row]),
        )

    def row_of(self, node_id: InfoHash) -> Optional[int]:
        return self._row_of.get(bytes(node_id))

    def addr_of(self, row: int):
        return self._addrs[row]

    def id_of(self, row: int) -> InfoHash:
        return InfoHash(IK.ids_to_bytes(self._ids[row]).tobytes())

    def ids_of_rows(self, rows: np.ndarray) -> list:
        """Vectorized :meth:`id_of` over an int array (-1 → None)."""
        rows = np.asarray(rows).reshape(-1)
        raw = IK.ids_to_bytes(self._ids[np.clip(rows, 0, None)])
        return [InfoHash(raw[i].tobytes()) if r >= 0 else None
                for i, r in enumerate(rows)]

    @property
    def delta_capacity(self) -> int:
        return self._delta_cap

    @property
    def churn_pending(self) -> int:
        """Mutations absorbed by the churn view since the last base
        build (tombstones + delta inserts).  0 ⇒ the base snapshot is
        complete."""
        return self._churn.pending if self._churn is not None else 0

    def _mask(self, now: float, mask: str) -> np.ndarray:
        if mask == "good":
            return self.good_mask(now)
        if mask == "valid":
            return self._valid
        return self.reachable_mask(now)

    def snapshot(self, now: Optional[float] = None, *,
                 mask: str = "reachable") -> Snapshot:
        """Full device snapshot for batched queries.  mask: 'reachable'
        (valid & not expired), 'good', or 'valid'.  Cached until the
        table mutates ('good' additionally keyed by a 10 s time bucket).
        Pending churn forces a rebuild here (a compaction, waiting for a
        background one first); lookups that can use the incremental view
        go through :meth:`view`."""
        if now is None:
            now = time.monotonic()
        if mask == "reachable":
            self._maybe_swap(force=True)
        tkey = int(now // 10) if mask == "good" else 0
        mk = (mask, tkey)
        if self._snap is not None and self._snap.version == self._version \
                and self._snap.mask_key == mk and self.churn_pending == 0:
            return self._snap
        m = self._mask(now, mask)
        # a compaction only when this rebuild folds pending churn into
        # the base — first builds and other masks are not compactions
        if self.churn_pending > 0:
            self.compactions += 1
            _M_COMPACTIONS.inc()
        sorted_ids, perm, _ = sort_table(IK.to_keys(self._ids, self.device),
                                         torch.from_numpy(m).to(self.device))
        self._snap = Snapshot(sorted_ids, perm, int(m.sum()), self._version,
                              mk)
        # churn absorption tracks the 'reachable' mask only (the one every
        # routing lookup uses); 'good' / 'valid' rebuild on mutation
        self._churn = ChurnView(self._snap, self._cap, self._delta_cap) \
            if mask == "reachable" else None
        return self._snap

    def view(self, now: Optional[float] = None, *, mask: str = "reachable"):
        """Lookup view: the churn view while tombstones or delta rows are
        pending, else the plain snapshot.  Both expose ``lookup`` /
        ``lookup_launch`` with identical, exact results; the churn view
        skips the re-sort and re-expansion a mutation would otherwise
        cost.  Installs a finished background compaction first."""
        if mask == "reachable":
            self._maybe_swap()
        ch = self._churn
        if ch is not None and self._snap is not None and ch.pending \
                and self._snap.mask_key == (mask, 0):
            return ch
        return self.snapshot(now, mask=mask)

    def find_closest(self, targets, *, k: int = TARGET_NODES,
                     now: Optional[float] = None, mask: str = "reachable",
                     window: int = 128, mesh=None, layout=None):
        """k closest known peers for each target id
        (↔ RoutingTable::findClosestNodes, src/routing_table.cpp:109-150,
        batched over Q targets).

        targets: [Q,5] uint32, [Q,20] uint8, bytes, or list of InfoHash.
        Returns (rows [Q,k] int32, dist [Q,k,5] uint32) numpy, -1 padded.
        Small tables × small batches take an exact host scan; larger ones
        the device snapshot lookup.  Both are exact and give identical
        results.  A ``mesh`` (``config.resolve_mesh_t``) row-shards the
        snapshot resolve over its ``t`` axis (:meth:`Snapshot.lookup`),
        at a reshard ``layout``'s boundaries when one is given; the churn
        view and the host scan ignore both (identical results either
        way)."""
        return self.find_closest_launch(targets, k=k, now=now, mask=mask,
                                        window=window, mesh=mesh,
                                        layout=layout).consume()

    def find_closest_launch(self, targets, *, k: int = TARGET_NODES,
                            now: Optional[float] = None,
                            mask: str = "reachable",
                            window: int = 128, mesh=None,
                            layout=None) -> PendingLookup:
        """Async form of :meth:`find_closest`; the host-scan path returns
        an already-resolved handle.  ``last_resolve_sharded`` records
        whether THIS resolve ran sharded (read by
        ``Dht.find_closest_nodes_launch`` right after the call, on the
        same thread)."""
        q = _as_limbs(targets).reshape(-1, IK.N_LIMBS)
        self.last_resolve_sharded = False
        if len(self) <= HOST_SCAN_MAX_ROWS \
                and q.shape[0] <= HOST_SCAN_MAX_QUERIES:
            return PendingLookup.resolved(
                *self._find_closest_host(q, k, now, mask))
        view = self.view(now, mask=mask)
        if mesh is not None and mesh.shape.get("t", 1) > 1 \
                and isinstance(view, Snapshot):
            self.last_resolve_sharded = True
            return view.lookup_launch(q, k=k, window=window, mesh=mesh,
                                      layout=layout)
        return view.lookup_launch(q, k=k, window=window)

    def _find_closest_host(self, q: np.ndarray, k: int,
                           now: Optional[float], mask: str):
        """Exact numpy top-k over the live slab rows (host fast path)."""
        if now is None:
            now = time.monotonic()
        rows = np.nonzero(self._mask(now, mask))[0]
        Qn = q.shape[0]
        out_rows = np.full((Qn, k), -1, dtype=np.int32)
        out_dist = np.full((Qn, k, IK.N_LIMBS), 0xFFFFFFFF, dtype=np.uint32)
        if len(rows):
            d = self._ids[rows][None, :, :] ^ q[:, None, :]    # [Q, n, 5]
            for i in range(Qn):
                # np.lexsort's LAST key is primary (limb 0)
                order = np.lexsort(
                    (d[i, :, 4], d[i, :, 3], d[i, :, 2],
                     d[i, :, 1], d[i, :, 0]))[:k]
                out_rows[i, :len(order)] = rows[order]
                out_dist[i, :len(order)] = d[i, order]
        return out_rows, out_dist

    # --------------------------------------------------------- maintenance
    def bucket_occupancy(self) -> np.ndarray:
        return self._bucket_count.copy()

    def _slab(self):
        """(self id, ids, valid, reply times) of the slab on the device."""
        dev = self.device
        return (IK.to_keys(self.self_limbs, dev), IK.to_keys(self._ids, dev),
                torch.from_numpy(self._valid).to(dev),
                torch.from_numpy(self._time_reply).to(dev))

    def stale_buckets(self, now: float,
                      age: float = NODE_EXPIRE_TIME) -> np.ndarray:
        """Occupied buckets with no reply within ``age`` seconds, buckets
        whose peers never replied included (stale from birth,
        src/routing_table.cpp:210-211).  The per-bucket last reply comes
        from ``radix.bucket_last_seen`` (float32) and is compared on the
        host, as in the JAX package."""
        last = radix.bucket_last_seen(*self._slab()).cpu().numpy()
        occupied = self._bucket_count > 0
        return np.nonzero(occupied & (last < now - age))[0]

    def _next_maint_generator(self) -> torch.Generator:
        """The table's reusable maintenance generator, seeded once."""
        if self._maint_gen is None:
            self._maint_gen = torch.Generator(device=self.device)
            self._maint_gen.manual_seed(
                int.from_bytes(os.urandom(8), "big"))
        return self._maint_gen

    def maintenance_sweep(self, now: float, age: float = NODE_EXPIRE_TIME,
                          generator: Optional[torch.Generator] = None):
        """One device pass over the slab: occupancy, per-bucket staleness
        (never-replied ⇒ stale from birth) and a refresh target in every
        stale bucket (↔ Dht::bucketMaintenance, src/dht.cpp:1780-1838 +
        RoutingTable::randomId).  Returns ``(stale, targets)``: stale
        bucket indices [B] int64 and their refresh ids [B, 5] uint32."""
        _counts, _last, stale, targets = radix.maintenance_sweep(
            *self._slab(), now, age,
            generator if generator is not None
            else self._next_maint_generator(), device=self.device)
        stale = np.nonzero(stale.cpu().numpy())[0]
        return stale, IK.from_keys(targets)[stale]

    def refresh_targets(self, buckets,
                        generator: Optional[torch.Generator] = None
                        ) -> np.ndarray:
        """A random lookup target inside each given bucket
        (↔ RoutingTable::randomId, src/routing_table.cpp:67-85) → uint32
        [B, 5]; the table's generator unless one is given."""
        out = radix.random_id_in_bucket(
            IK.to_keys(self.self_limbs, self.device),
            torch.as_tensor(np.asarray(buckets)).to(self.device),
            generator if generator is not None
            else self._next_maint_generator())
        return IK.from_keys(out)

    def network_size_estimate(self) -> int:
        me, ids, valid, _ = self._slab()
        return int(radix.estimate_network_size(me, ids, valid, k=self.k))

    def export_nodes(self, now: Optional[float] = None) -> list:
        """Good nodes for persistence/bootstrap (↔ Dht::exportNodes,
        src/dht.cpp:2029-2059)."""
        if now is None:
            now = time.monotonic()
        rows = np.nonzero(self.good_mask(now))[0]
        return [(self.id_of(int(r)), self._addrs[int(r)]) for r in rows]


def _as_limbs(targets) -> np.ndarray:
    if isinstance(targets, (bytes, bytearray)):
        return IK.ids_from_bytes(targets)
    if isinstance(targets, (list, tuple)):
        return IK.ids_from_hashes(targets)
    arr = np.asarray(targets)
    if arr.dtype == np.uint8:
        return IK.ids_from_bytes(arr)
    return arr.astype(np.uint32)
