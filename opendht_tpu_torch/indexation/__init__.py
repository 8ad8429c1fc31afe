"""Distributed indexation over the DHT (reference: include/opendht/indexation)."""

from .pht import Cache, IndexEntry, Pht, Prefix  # noqa: F401
