"""Node interning cache (reference include/opendht/node_cache.h,
src/node_cache.cpp).

A copy of the JAX package's ``net/node_cache.py`` with its behaviour unchanged.

One weakly-referenced :class:`Node` object per (id, family), shared by
every subsystem so liveness updates are seen everywhere.
``get_cached_nodes`` is the scalar XOR-closest scan: walk a
lexicographically-sorted id index outward from ``lower_bound(id)``
choosing the XOR-closer side each step (node_cache.cpp:41-74) — the
same unimodal-window property the batched device kernel exploits
(opendht_tpu/ops/sorted_table.py)."""

from __future__ import annotations

import bisect
import socket as _socket
import weakref
from typing import Dict, List, Optional

from ..infohash import InfoHash
from ..sockaddr import SockAddr
from .node import Node


class _FamilyCache:
    """Sorted weak map InfoHash → Node for one address family."""

    def __init__(self):
        self._map: Dict[bytes, weakref.ref] = {}
        self._keys: List[bytes] = []        # sorted id bytes

    def _drop(self, key: bytes) -> None:
        self._map.pop(key, None)
        i = bisect.bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            del self._keys[i]

    def lookup(self, node_id: InfoHash) -> Optional[Node]:
        key = bytes(node_id)
        ref = self._map.get(key)
        if ref is None:
            return None
        node = ref()
        if node is None:
            self._drop(key)
        return node

    def get_node(self, node_id: InfoHash, addr: SockAddr, now: float,
                 confirm: bool, client: bool) -> Node:
        """(node_cache.cpp:100-112): intern; refresh address if confirmed
        or the cached entry is stale."""
        key = bytes(node_id)
        ref = self._map.get(key)
        node = ref() if ref is not None else None
        if node is None:
            node = Node(node_id, addr, client)
            self._map[key] = weakref.ref(node)
            i = bisect.bisect_left(self._keys, key)
            if i >= len(self._keys) or self._keys[i] != key:
                self._keys.insert(i, key)
        elif confirm or node.is_old(now):
            node.update(addr)
        return node

    def closest(self, target: InfoHash, count: int) -> List[Node]:
        """Outward walk from lower_bound, XOR-closer side first
        (node_cache.cpp:41-74)."""
        keys = self._keys
        tkey = bytes(target)
        n = len(keys)
        lo = bisect.bisect_left(keys, tkey) - 1     # just below
        hi = lo + 1                                  # at/above
        out: List[Node] = []
        while len(out) < count and (lo >= 0 or hi < n):
            if lo < 0:
                key = keys[hi]; hi += 1
            elif hi >= n:
                key = keys[lo]; lo -= 1
            elif target.xor_cmp(InfoHash(keys[lo]), InfoHash(keys[hi])) < 0:
                key = keys[lo]; lo -= 1
            else:
                key = keys[hi]; hi += 1
            ref = self._map.get(key)
            node = ref() if ref is not None else None
            if node is not None and not node.expired and not node.is_client:
                out.append(node)
        return out

    def clear_bad(self) -> None:
        for key in list(self._map):
            ref = self._map[key]
            node = ref()
            if node is None:
                self._drop(key)
            else:
                node.reset()

    def set_expired(self) -> None:
        for ref in list(self._map.values()):
            node = ref()
            if node is not None:
                node.set_expired()
        self._map.clear()
        self._keys.clear()

    def __len__(self):
        return len(self._map)


class NodeCache:
    def __init__(self):
        self._cache4 = _FamilyCache()
        self._cache6 = _FamilyCache()

    def _cache(self, family: int) -> _FamilyCache:
        return self._cache6 if family == _socket.AF_INET6 else self._cache4

    def get_node(self, node_id: InfoHash, addr: SockAddr, now: float,
                 confirm: bool, client: bool = False) -> Node:
        """Intern (node_cache.cpp:34-39); anonymous ids get throwaway
        nodes."""
        if not node_id:
            return Node(node_id, addr, client)
        return self._cache(addr.family).get_node(node_id, addr, now, confirm, client)

    def lookup(self, node_id: InfoHash, family: int) -> Optional[Node]:
        return self._cache(family).lookup(node_id)

    def get_cached_nodes(self, target: InfoHash, family: int,
                         count: int) -> List[Node]:
        return self._cache(family).closest(target, count)

    def clear_bad_nodes(self, family: int = 0) -> None:
        """On connectivity change: un-expire everything (node_cache.cpp:76-85)."""
        if family == 0:
            self._cache4.clear_bad()
            self._cache6.clear_bad()
        else:
            self._cache(family).clear_bad()

    def set_expired(self) -> None:
        self._cache4.set_expired()
        self._cache6.set_expired()

    def size(self, family: int) -> int:
        return len(self._cache(family))
