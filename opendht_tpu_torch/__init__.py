"""opendht_tpu_torch — the PyTorch/CUDA port of opendht_tpu.

It carries the batched closest-node resolve (``NodeTable.bulk_load``
→ ``find_closest``) on an NVIDIA Hopper card: the sorted-window lookup
in plain torch around two hand-written CUDA select kernels
(``ops/window_select.py``, ``ops/lex_select.py``); the live table under
churn (``core/table.py`` ``ChurnView``: tombstones, a delta slab and
background compaction, looked up through
``ops/sorted_table.py`` ``churn_lookup_topk``); the iterative lookup
engine (``core/search.py`` ``simulate_lookups``); the k-bucket
maintenance sweep (``ops/radix.py``, ``NodeTable.maintenance_sweep``);
the serving node (``runtime/dht.py`` ``Dht`` with its msgpack net
engine, live searches and ingest wave builder), which answers
get/find/put/listen through those tables; and the runner layer above it
(``runtime/runner.py`` ``DhtRunner``: the receive, DHT and bootstrap
threads over the native C++ datagram engine, with ``SecureDht``, the
crypto layer, and the health and history observatories).  The node's
planes are on by default, as in the JAX node: the keyspace observatory
(``keyspace.py``, a count-min sketch on the card), the hot-value cache
(``hotcache.py``), the batched listener table (``listeners.py``) and
the chaos plane's fault injection seam (``chaos.py``, armed on demand).

The package imports torch and numpy only — never JAX, never
``opendht_tpu``, never the ``msgpack`` wheel (host-only modules it
needs are copied here, and it carries its own msgpack codec).  Only
``crypto`` imports ``cryptography`` and ``argon2``, and the rest reaches
it lazily, so a node without an identity runs without them.  Entry
points take ``device=None``, which means the CUDA card and raises when
there is none.
"""

from ._device import resolve_device
from .infohash import InfoHash
from .core.table import NodeTable, Snapshot, PendingLookup
from .core.search import simulate_lookups
from .runtime import Config, Dht, DhtRunner, RunnerConfig, SecureDht

__all__ = ["resolve_device", "InfoHash", "NodeTable", "Snapshot",
           "PendingLookup", "simulate_lookups", "Config", "Dht",
           "DhtRunner", "RunnerConfig", "SecureDht"]
