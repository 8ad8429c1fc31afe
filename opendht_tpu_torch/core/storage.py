"""Per-key value storage with quota accounting (reference src/storage.h).

A copy of the JAX package's ``core/storage.py`` with its behaviour unchanged.

- :class:`StorageBucket` — per-IP usage tracker; the eviction policy
  drops the oldest-expiring value of the largest consumer
  (storage.h:33-56, used by Dht.expireStore dht.cpp:1299-1348).
- :class:`ValueStorage` — one stored value + created/expiration times.
- :class:`Storage` — the per-InfoHash store: refresh-or-insert with size
  diffs (storage.h:181-220), expiry partition returning the expired
  values for listener notification (storage.h:248-286), and both local
  and remote listener maps.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..infohash import InfoHash
from .listener import Listener, LocalListener
from .value import Filter, Filters, Value

#: remote listeners expire with node liveness (node.h:151: 10 min)
NODE_EXPIRE_TIME = 10 * 60.0

MAX_VALUES = 1024                    # storage.h:77


class StorageBucket:
    """Usage ledger for one IP (or range): total bytes + an
    expiration-ordered index of (key, value id) for eviction."""

    __slots__ = ("_entries", "_total")

    def __init__(self):
        # sorted-by-expiration list of (expiration, key, vid, size)
        self._entries: List[Tuple[float, InfoHash, int, int]] = []
        self._total = 0

    def insert(self, key: InfoHash, value: Value, expiration: float) -> None:
        sz = value.size()
        self._total += sz
        bisect.insort(self._entries, (expiration, key, value.id, sz),
                      key=lambda e: e[0])

    def erase(self, key: InfoHash, value: Value, expiration: float) -> None:
        # entries are expiration-sorted: scan only the equal-expiration run
        entries = self._entries
        i = bisect.bisect_left(entries, expiration, key=lambda e: e[0])
        while i < len(entries) and entries[i][0] == expiration:
            _, k, vid, sz = entries[i]
            if k == key and vid == value.id:
                del entries[i]
                self._total -= sz
                return
            i += 1

    @property
    def size(self) -> int:
        return self._total

    def get_oldest(self) -> Optional[Tuple[InfoHash, int]]:
        """(key, value id) of the earliest-expiring entry (storage.h:52)."""
        if not self._entries:
            return None
        _, k, vid, _ = self._entries[0]
        return k, vid


@dataclass
class ValueStorage:
    """(storage.h:58-68)"""
    data: Value
    created: float
    expiration: float
    store_bucket: Optional[StorageBucket] = None


@dataclass
class StoreDiff:
    """Net effect of a storage op (storage.h:80-90)."""
    size_diff: int = 0
    values_diff: int = 0
    listeners_diff: int = 0


class Storage:
    """All state stored under one InfoHash."""

    def __init__(self, now: float = 0.0):
        self.maintenance_time = now          # next republish sweep
        # armed by Dht.storage_store on a maintain_storage node (the
        # reference schedules dataPersistence only there, dht.cpp:
        # 1193-1228); listen-created storages are NEVER maintenance-
        # swept — the calendar checks this flag
        self.maintenance_armed = False
        self.values: List[ValueStorage] = []
        self.total_size = 0
        # remote listeners: node -> {socket id -> Listener}
        self.listeners: Dict[object, Dict[int, Listener]] = {}
        self.local_listeners: Dict[int, LocalListener] = {}
        self.listener_token = 1

    # -- reads -------------------------------------------------------------
    def empty(self) -> bool:
        return not self.values

    def value_count(self) -> int:
        return len(self.values)

    def get_by_id(self, vid: int) -> Optional[Value]:
        for vs in self.values:
            if vs.data.id == vid:
                return vs.data
        return None

    def get(self, f: Optional[Filter] = None) -> List[Value]:
        return Filters.apply(f, (vs.data for vs in self.values))

    # -- writes ------------------------------------------------------------
    def store(self, key: InfoHash, value: Value, created: float,
              expiration: float, bucket: Optional[StorageBucket] = None
              ) -> Tuple[Optional[ValueStorage], StoreDiff]:
        """Refresh-or-insert (storage.h:181-220).  Returns (slot, diff);
        slot is None when nothing changed (same object refreshed, or the
        MAX_VALUES cap was hit)."""
        for vs in self.values:
            if vs.data is value or vs.data.id == value.id:
                vs.created = created
                if vs.data is value:
                    # same object re-stored: expiration must track the new
                    # created, or later refresh() calls (which derive the
                    # ttl from expiration-created) extend by a shrunken ttl
                    if vs.store_bucket:
                        vs.store_bucket.erase(key, vs.data, vs.expiration)
                        vs.store_bucket.insert(key, vs.data, expiration)
                    vs.expiration = expiration
                    return None, StoreDiff()
                size_diff = value.size() - vs.data.size()
                if vs.store_bucket:
                    vs.store_bucket.erase(key, vs.data, vs.expiration)
                vs.expiration = expiration
                vs.store_bucket = bucket
                if bucket:
                    bucket.insert(key, value, expiration)
                vs.data = value
                self.total_size += size_diff
                return vs, StoreDiff(size_diff, 0, 0)
        if len(self.values) >= MAX_VALUES:
            return None, StoreDiff()
        sz = value.size()
        vs = ValueStorage(value, created, expiration, bucket)
        self.values.append(vs)
        self.total_size += sz
        if bucket:
            bucket.insert(key, value, expiration)
        return vs, StoreDiff(sz, 1, 0)

    def refresh(self, now: float, vid: int, key: InfoHash
                ) -> Optional[float]:
        """Restart a value's lifetime (storage.h:159-166).  The reference
        recomputes expiry from ``created`` at sweep time; we cache the
        absolute expiration, so the refresh must extend it (and re-index
        the per-IP quota bucket, which is expiration-sorted).

        Returns the new absolute expiration (the caller must schedule an
        expiry sweep at that time), or None if the value is unknown."""
        for vs in self.values:
            if vs.data.id == vid:
                ttl = vs.expiration - vs.created
                if vs.store_bucket is not None:
                    vs.store_bucket.erase(key, vs.data, vs.expiration)
                vs.created = now
                vs.expiration = now + ttl
                if vs.store_bucket is not None:
                    vs.store_bucket.insert(key, vs.data, vs.expiration)
                return vs.expiration
        return None

    def remove(self, key: InfoHash, vid: int) -> StoreDiff:
        """(storage.h:222-238)"""
        for i, vs in enumerate(self.values):
            if vs.data.id == vid:
                if vs.store_bucket:
                    vs.store_bucket.erase(key, vs.data, vs.expiration)
                sz = vs.data.size()
                del self.values[i]
                self.total_size -= sz
                return StoreDiff(-sz, -1, 0)
        return StoreDiff()

    def clear(self, key: "InfoHash | None" = None) -> StoreDiff:
        """(storage.h:240-247).  Pass the storage key so quota-tracked
        values are also unlinked from their per-IP StorageBucket; without
        it the buckets would keep phantom entries and break eviction."""
        if key is not None:
            for vs in self.values:
                if vs.store_bucket:
                    vs.store_bucket.erase(key, vs.data, vs.expiration)
        d = StoreDiff(-self.total_size, -len(self.values), 0)
        self.values.clear()
        self.total_size = 0
        return d

    def expire(self, key: InfoHash, now: float) -> Tuple[int, List[Value]]:
        """Drop expired values and stale remote listeners; returns
        (size_diff, expired values) so the caller can notify listeners
        (storage.h:248-286)."""
        for node in list(self.listeners):
            node_listeners = self.listeners[node]
            for sid in list(node_listeners):
                if node_listeners[sid].time + NODE_EXPIRE_TIME < now:
                    del node_listeners[sid]
            if not node_listeners:
                del self.listeners[node]

        keep, expired = [], []
        size_diff = 0
        for vs in self.values:
            if vs.expiration > now:
                keep.append(vs)
            else:
                size_diff -= vs.data.size()
                if vs.store_bucket:
                    vs.store_bucket.erase(key, vs.data, vs.expiration)
                expired.append(vs.data)
        self.values = keep
        self.total_size += size_diff
        return size_diff, expired
