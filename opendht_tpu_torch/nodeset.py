"""NodeSet / NodeEntry: sorted collection of discovered nodes
(↔ reference python/opendht.pyx:158-310 — the binding types the cluster
tools iterate while scanning/censusing the network).

A copy of the JAX package's ``nodeset.py`` with its behaviour unchanged."""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

from .infohash import InfoHash


class NodeEntry:
    """(id, node) pair (opendht.pyx:158-167).  ``node`` is anything with
    an address — a net.node.Node, a SockAddr, or None."""

    __slots__ = ("id", "node")

    def __init__(self, node_id: InfoHash, node=None):
        self.id = InfoHash(node_id)
        self.node = node

    def get_id(self) -> InfoHash:
        return self.id

    def get_node(self):
        return self.node

    def __repr__(self):
        return f"NodeEntry({self.id}, {self.node})"


class NodeSet:
    """Sorted id → node map (opendht.pyx:273-310): insert/extend,
    first/last, iteration in id order."""

    def __init__(self, entries: Optional[Iterable] = None):
        self._nodes: dict = {}
        if entries:
            self.extend(entries)

    def size(self) -> int:
        return len(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    def insert(self, entry) -> bool:
        """Insert a NodeEntry, (id, node) tuple, or bare id; returns
        True when the id was new (map-insert semantics)."""
        if isinstance(entry, NodeEntry):
            nid, node = entry.id, entry.node
        elif isinstance(entry, tuple):
            nid, node = InfoHash(entry[0]), entry[1]
        else:
            nid, node = InfoHash(entry), None
        key = bytes(nid)
        if key in self._nodes:          # std::map::insert keeps the first
            return False
        self._nodes[key] = NodeEntry(nid, node)
        return True

    def extend(self, entries: Iterable) -> None:
        for e in entries:
            self.insert(e)

    def first(self) -> InfoHash:
        if not self._nodes:
            raise IndexError("empty NodeSet")
        return self._nodes[min(self._nodes)].id

    def last(self) -> InfoHash:
        if not self._nodes:
            raise IndexError("empty NodeSet")
        return self._nodes[max(self._nodes)].id

    def _sorted(self) -> list:
        return [self._nodes[k] for k in sorted(self._nodes)]

    def __iter__(self) -> Iterator[NodeEntry]:
        return iter(self._sorted())

    def __contains__(self, node_id) -> bool:
        return bytes(InfoHash(node_id)) in self._nodes

    def __str__(self) -> str:
        out = []
        for e in self._sorted():
            addr = getattr(e.node, "addr", e.node)
            out.append("%s %s" % (e.id, addr if addr is not None else ""))
        return "\n".join(out)
