"""L4 — the node runtime: the full DHT node core (``Dht``), its live
search machinery, the ingest wave builder, the secure layer
(``SecureDht``) and the threaded runner (``DhtRunner``).

The port of the JAX package's ``runtime`` package.  Per-packet protocol state — the
msgpack RPC engine, request retries, per-search token/listen/announce
bookkeeping — stays host-side; every closest-node query goes through
the port's :class:`~opendht_tpu_torch.core.table.NodeTable` (an exact
host scan for small tables, the device snapshot or churn view on the
card for large ones), so a node serving thousands of concurrent lookups
resolves them in a handful of batched device calls instead of
per-search scalar scans (reference: ``RoutingTable::findClosestNodes``
src/routing_table.cpp:109-150, ``NodeCache::getCachedNodes``
src/node_cache.cpp:41-74)."""

from .config import Config, NodeStatus, NodeStats, DEFAULT_STORAGE_LIMIT  # noqa: F401
from .dht import BatchedResolve, Dht  # noqa: F401
from .wave_builder import WaveBuilder  # noqa: F401
from .secure_dht import SecureDht  # noqa: F401
from .runner import DhtRunner, RunnerConfig  # noqa: F401
