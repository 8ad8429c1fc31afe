"""opendht_tpu_torch — the PyTorch/CUDA port of opendht_tpu.

A Kademlia DHT with a ``get/put/listen/query`` value store, signed and
encrypted values, a REST proxy, a prefix-hash-tree index, CLI tools and
a cluster harness, whose closest-node resolve runs as batched tensor
ops on an NVIDIA Hopper card.  Every module of the JAX package has its
counterpart here, under the same name.

**The public surface** is the JAX package's, which is the reference's
Python binding (``python/opendht.pyx``): ``import opendht_tpu_torch as
o`` gives ``o.DhtRunner``, ``o.InfoHash``, ``o.Value``, ``o.Where``,
``o.NodeSet``, ``o.Pht`` and the rest of ``__all__``, each from the
port's own module.  The identity and certificate types
(``o.Identity``, ``o.Certificate``, ``o.generate_identity`` …) resolve
lazily from :mod:`.crypto`, the one module that needs the
``cryptography`` and ``argon2`` wheels: without them only touching
those names fails (AttributeError, chained from the missing wheel), and
a runner without an identity works.  ``o.ops`` exports the id
functions on int32 key tensors (``ops/ids.py``).

The layers, from the runner down to the card:

- ``runtime``    ``DhtRunner`` (receive, DHT and bootstrap threads over
                 the native C++ datagram engine, ``native/``),
                 ``SecureDht`` and the node core ``Dht`` with its
                 msgpack net engine (``net``), live searches and ingest
                 wave builder; the keyspace sketch, hot-value cache,
                 listener table, chaos seam and resharder planes
- ``core``       the node table (``NodeTable``: a sorted snapshot, and
                 under churn a ``ChurnView`` of tombstones, a delta slab
                 and background compaction), the iterative lookup engine
                 (``simulate_lookups``), storage and values
- ``ops``        id math and the sorted-window lookup in torch around the
                 two hand-written CUDA select kernels
                 (``ops/window_select.py``, ``ops/lex_select.py``)
- ``parallel``   the sharded tables over a mesh of cards
- ``proxy``, ``indexation``, ``tools``, ``testing``: the REST proxy,
                 the PHT, the CLI tools and the cluster harness and smokes

The package imports torch and numpy only — never JAX, never
``opendht_tpu``, never the ``msgpack`` wheel (host-only modules it
needs are copied here, and it carries its own msgpack codec).  Entry
points take ``device=None``, which means the CUDA card and raises when
there is none.
"""

import concurrent.futures as _futures

from . import telemetry  # noqa: F401
from ._device import resolve_device
from .infohash import InfoHash, PkId, random_infohash
from .core.value import Value, ValueType, Query, Select, Where, Filters
from .core.table import NodeTable, Snapshot, PendingLookup
from .core.search import simulate_lookups
from .runtime import Config, Dht, DhtRunner, RunnerConfig, SecureDht
from .runtime.config import NodeStats, NodeStatus, SecureDhtConfig
from .sockaddr import SockAddr
from .net.node import Node
from .nodeset import NodeEntry, NodeSet
from .indexation.pht import IndexEntry as IndexValue, Pht

#: binding-compat aliases (↔ python/opendht.pyx names)
DhtConfig = Config
#: ``DhtRunner.listen`` returns this token handle (a Future resolving to
#: the runner-level token — pass it back to ``cancel_listen``)
ListenToken = _futures.Future

# The identity and certificate types resolve lazily (PEP 562): .crypto
# imports the ``cryptography`` and ``argon2`` wheels, which a host that
# runs only identity-less runners may lack.
_LAZY_EXPORTS = {name: ".crypto" for name in (
    "Certificate", "Identity", "PrivateKey", "PublicKey", "RevocationList",
    "TrustList", "VerifyResult", "generate_identity", "generate_ec_identity",
)}


def __getattr__(name):
    mod = _LAZY_EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    try:
        value = getattr(importlib.import_module(mod, __name__), name)
    except ModuleNotFoundError as e:
        # AttributeError (chained from the real cause), so that hasattr()
        # and dir()-driven introspection degrade softly on a host without
        # the wheel, while `from opendht_tpu_torch import Identity` still
        # raises ImportError
        raise AttributeError(
            f"opendht_tpu_torch.{name} requires the optional '{e.name}' "
            f"package (runners without an identity, the kernels and the "
            f"lookup engine work without it)") from e
    globals()[name] = value              # cache: __getattr__ runs once
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY_EXPORTS))


# the JAX package's names (the binding's), then the port's own
__all__ = [
    "InfoHash", "PkId", "random_infohash",
    "Value", "ValueType", "Query", "Select", "Where", "Filters",
    "Config", "NodeStats", "NodeStatus", "SecureDhtConfig",
    "SockAddr", "Node", "NodeEntry", "NodeSet", "IndexValue", "Pht",
    "DhtConfig", "ListenToken", "DhtRunner", "RunnerConfig",
] + sorted(_LAZY_EXPORTS) + [
    "resolve_device", "NodeTable", "Snapshot", "PendingLookup",
    "simulate_lookups", "Dht", "SecureDht",
]
