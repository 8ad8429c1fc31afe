"""The node table: a growable slab of known peers with k-bucket admission
and device-snapshot queries — the port of the JAX package's
``core/table.py`` for the batched closest-node resolve.

Per-packet mutations are O(1) host-side numpy/dict updates; closest-node
queries over large tables or large waves go through an immutable device
:class:`Snapshot` (sorted id keys + permutation + lazily built expanded
table), the counterpart of ``RoutingTable::findClosestNodes``
(src/routing_table.cpp:109-150) and ``NodeCache::getCachedNodes``
(src/node_cache.cpp:41-74) batched over thousands of targets.

The bucket-maintenance methods (``maintenance_sweep``,
``stale_buckets``, ``refresh_targets``, ``network_size_estimate``) run
``ops/radix.py`` on the table's device; the reusable maintenance key of
the JAX package is a ``torch.Generator`` seeded once per table.

Not ported yet: the churn view and background compaction.  Here
:meth:`NodeTable.view` always returns a snapshot of the current state,
so every mutation costs a rebuild at the next device lookup; the results
are the same exact ones the churn view gives.  The mesh/layout (sharded)
resolve and the table's telemetry counters are left out too.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..infohash import InfoHash
from ..ops import ids as IK
from ..ops import radix
from ..ops.sorted_table import (expand_table, lookup_topk,
                                resolve_uncertified, sort_table)

# liveness windows (reference include/opendht/node.h:148-158)
NODE_GOOD_TIME = 120 * 60.0       # replied within 2 h → good
NODE_EXPIRE_TIME = 10 * 60.0      # silent for 10 min → expirable
MAX_AUTH_ERRORS = 3               # 3 strikes → expired (node.h:73-77)

TARGET_NODES = 8                  # k (routing_table.h:26)

# Below these sizes closest-node queries run as an exact numpy scan on
# the host slab instead of the device lookup (a live node's table is
# tens-to-hundreds of rows, where a device round trip dwarfs the scan).
HOST_SCAN_MAX_ROWS = 4096
HOST_SCAN_MAX_QUERIES = 64


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

    @property
    def device(self) -> torch.device:
        return self.sorted_ids.device

    def lookup(self, queries, *, k: int = TARGET_NODES, window: int = 128):
        """Batched exact k-closest.  queries: uint32 [Q,5] numpy or a key
        tensor on the snapshot's device.  Returns (rows [Q,k] int32, dist
        [Q,k,5] uint32) numpy, -1 / all-ones padded.

        Runs the expanded row-gather route with the ``"auto"`` select
        (the ``window_select`` kernel on the card); ``window`` is
        accepted for API symmetry and ignored (the candidate window is
        the expansion's 192 rows)."""
        return self.lookup_launch(queries, k=k, window=window).consume()

    def lookup_launch(self, queries, *, k: int = TARGET_NODES,
                      window: int = 128) -> PendingLookup:
        """Async form of :meth:`lookup`: the lookup is enqueued before this
        returns; the certificate check and fallback wait in ``consume()``."""
        q = queries if isinstance(queries, torch.Tensor) \
            else IK.to_keys(queries, self.device)
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


class NodeTable:
    """Growable peer slab with k-bucket admission (one per address family,
    like the reference's buckets4/buckets6, dht.h:370-381).

    ``device``: where snapshots and device lookups live; None means the
    CUDA card and raises when there is none."""

    def __init__(self, self_id: InfoHash, *, k: int = TARGET_NODES,
                 capacity: int = 1024, device=None):
        self.device = resolve_device(device)
        self.self_id = self_id
        self.self_limbs = IK.ids_from_bytes(bytes(self_id)).reshape(-1)
        self.k = k
        self._cap = capacity
        self.compactions = 0              # no churn view yet: stays 0
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

    # ------------------------------------------------------------- mutation
    def _touch(self) -> None:
        """The table changed: the next device lookup rebuilds the snapshot."""
        self._version += 1
        self._snap = None

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
                    self._expired[row] = False          # revival
                    self._touch()
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
        self._touch()
        return row

    def _evict_row(self, row: int) -> None:
        kb = IK.ids_to_bytes(self._ids[row:row + 1]).tobytes()
        self._row_of.pop(kb, None)
        self._bucket_count[self._bucket[row]] -= 1
        self._valid[row] = False
        self._addrs[row] = None
        self._free.append(row)
        self._touch()

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
            self._touch()

    def on_auth_error(self, node_id: InfoHash) -> None:
        """Crypto failure from this peer; 3 strikes expire it (node.h:73-77)."""
        row = self._row_of.get(bytes(node_id))
        if row is not None:
            self._auth_err[row] += 1
            if self._auth_err[row] >= MAX_AUTH_ERRORS \
                    and not self._expired[row]:
                self._expired[row] = True
                self._touch()

    def bulk_load(self, ids_u32: np.ndarray, now: float = 0.0,
                  *, replied: bool = True, addrs=None,
                  buckets=None) -> None:
        """Fill the slab from an [N,5] uint32 id matrix (simulation-scale
        path: buckets computed on the table's device).  ``addrs``: one
        address per row, or one shared by all.  ``buckets``: optional
        precomputed ``common_bits(self, id)`` per row.

        Ids already in the table and batch-internal duplicates are not
        added again; a known id is refreshed as ``insert`` would (with
        ``replied=True`` an expired one revives), exactly as in the JAX
        package."""
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
                        self._touch()
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
        self._touch()

    # --------------------------------------------------------------- reads
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

    def _mask(self, now: float, mask: str) -> np.ndarray:
        if mask == "good":
            return self.good_mask(now)
        if mask == "valid":
            return self._valid
        return self.reachable_mask(now)

    def snapshot(self, now: Optional[float] = None, *,
                 mask: str = "reachable") -> Snapshot:
        """Device snapshot for batched queries.  mask: 'reachable' (valid
        & not expired), 'good', or 'valid'.  Cached until the table
        mutates ('good' additionally keyed by a 10 s time bucket)."""
        if now is None:
            now = time.monotonic()
        tkey = int(now // 10) if mask == "good" else 0
        mk = (mask, tkey)
        if self._snap is not None and self._snap.version == self._version \
                and self._snap.mask_key == mk:
            return self._snap
        m = self._mask(now, mask)
        sorted_ids, perm, n_valid = sort_table(
            IK.to_keys(self._ids, self.device),
            torch.from_numpy(m).to(self.device))
        self._snap = Snapshot(sorted_ids, perm, int(n_valid), self._version,
                              mk)
        return self._snap

    def view(self, now: Optional[float] = None, *, mask: str = "reachable"):
        """Lookup view: the snapshot of the current state (no churn view
        in this port yet)."""
        return self.snapshot(now, mask=mask)

    def find_closest(self, targets, *, k: int = TARGET_NODES,
                     now: Optional[float] = None, mask: str = "reachable",
                     window: int = 128):
        """k closest known peers for each target id
        (↔ RoutingTable::findClosestNodes, src/routing_table.cpp:109-150,
        batched over Q targets).

        targets: [Q,5] uint32, [Q,20] uint8, bytes, or list of InfoHash.
        Returns (rows [Q,k] int32, dist [Q,k,5] uint32) numpy, -1 padded.
        Small tables × small batches take an exact host scan; larger ones
        the device snapshot lookup.  Both are exact and give identical
        results."""
        return self.find_closest_launch(targets, k=k, now=now, mask=mask,
                                        window=window).consume()

    def find_closest_launch(self, targets, *, k: int = TARGET_NODES,
                            now: Optional[float] = None,
                            mask: str = "reachable",
                            window: int = 128) -> PendingLookup:
        """Async form of :meth:`find_closest`; the host-scan path returns
        an already-resolved handle."""
        q = _as_limbs(targets).reshape(-1, IK.N_LIMBS)
        if len(self) <= HOST_SCAN_MAX_ROWS \
                and q.shape[0] <= HOST_SCAN_MAX_QUERIES:
            return PendingLookup.resolved(
                *self._find_closest_host(q, k, now, mask))
        return self.view(now, mask=mask).lookup_launch(q, k=k, window=window)

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


def _as_limbs(targets) -> np.ndarray:
    if isinstance(targets, (bytes, bytearray)):
        return IK.ids_from_bytes(targets)
    if isinstance(targets, (list, tuple)):
        return IK.ids_from_hashes(targets)
    arr = np.asarray(targets)
    if arr.dtype == np.uint8:
        return IK.ids_from_bytes(arr)
    return arr.astype(np.uint32)
