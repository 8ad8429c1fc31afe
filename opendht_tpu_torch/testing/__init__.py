"""Multi-node test/bench harness (↔ reference python/tools/dht/*).

The port's copies of the JAX package's ``testing`` modules, each on the
CUDA card unless asked for the CPU (``device="cpu"``, or ``--cpu`` on
its command line):

- :class:`VirtualNet` — deterministic in-process virtual UDP network
  over the port's ``Dht`` cores with a virtual clock (replaces the
  reference's netns + netem tier, virtual_network_builder.py); its
  ``device=`` places every node's tables.
- :class:`DhtNetwork` — N real ``DhtRunner`` nodes on localhost UDP
  (the reference's in-namespace node cluster, dht/network.py:283-436).
- Scenario suites (↔ dht/tests.py): :class:`PerformanceTest` (gets
  latency histograms, node-kill delete test), :class:`PersistenceTest`
  (value survival under churn), :class:`LatencyStats`; their
  command-line entry points ``python -m
  opendht_tpu_torch.testing.benchmark`` (↔ benchmark.py) and
  ``.pingpong``.
- The monitor: ``health_monitor`` (the cluster aggregator and the
  batched replica-coverage probe ``tools/dhtmon.py`` runs) and
  ``telemetry_smoke`` (its ``parse_exposition``).
- The assemblers: ``trace_assembler`` (one operation's span tree),
  ``timeline_assembler`` (the cluster's metrics history) and
  ``wiremap_assembler`` (the cluster's per-peer link graph).
- The cluster tools (↔ the reference's python/tools): ``dhtcluster``
  (``NodeCluster``, its REPL), ``subproc_cluster`` (a whole cluster in a
  child process, driven over msgpack frames on its stdin / stdout),
  ``netns_net`` (clusters in Linux network namespaces), ``scanner``
  (the keyspace crawl), ``http_server`` (the HTTP control front) and
  ``network_monitor`` (the put→listen probe).
- The end-to-end smokes, one real-UDP (or virtual-net) cluster each,
  every one a CLI (``python -m opendht_tpu_torch.testing.<name> [--cpu]``,
  exit 0 and an OK line): ``telemetry_smoke``, ``ledger_smoke`` (the
  kernel cost ledger's export), ``health_smoke``, ``history_smoke``,
  ``waterfall_smoke``, ``peer_smoke``, ``keyspace_smoke``,
  ``cache_smoke``, ``listener_smoke``, ``ingest_smoke``,
  ``pipeline_smoke``, ``pipeline_util_smoke``, ``reshard_smoke`` and
  ``chaos_smoke`` (with the device swarm's storm).

Each submodule resolves as an attribute on first use.
"""

from .virtual_net import VirtualNet

# The real-UDP backends ride DhtRunner; resolve them lazily (PEP 562, as
# the JAX package does) so a plain `import opendht_tpu_torch.testing`
# stays as light as the virtual-clock tier it carries.
_LAZY_EXPORTS = {
    "DhtNetwork": ".network",
    "PerformanceTest": ".scenarios",
    "PersistenceTest": ".scenarios",
    "LatencyStats": ".scenarios",
}


def __getattr__(name):
    import importlib
    import importlib.util
    mod = _LAZY_EXPORTS.get(name)
    if mod is None:
        if name.startswith("_") or importlib.util.find_spec(
                f"{__name__}.{name}") is None:
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}")
        return importlib.import_module(f".{name}", __name__)
    value = getattr(importlib.import_module(mod, __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY_EXPORTS))


__all__ = ["VirtualNet", "DhtNetwork", "PerformanceTest",
           "PersistenceTest", "LatencyStats"]
