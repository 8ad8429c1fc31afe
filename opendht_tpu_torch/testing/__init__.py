"""Multi-node test/bench harness (↔ reference python/tools/dht/*).

The port's copies of the JAX package's ``testing`` modules:

- :class:`VirtualNet` — deterministic in-process virtual UDP network
  over the port's ``Dht`` cores with a virtual clock (replaces the
  reference's netns + netem tier, virtual_network_builder.py); its
  ``device=`` places every node's tables.
- ``trace_assembler`` — cross-node span assembly and the tracing smoke.

The JAX package's real-UDP cluster (``DhtNetwork``), its scenario suites
(``PerformanceTest``, ``PersistenceTest``, ``LatencyStats``) and its
other harness modules are not ported yet (ROADMAP A.6): asking for one
of those names raises AttributeError saying so.
"""

from .virtual_net import VirtualNet

#: the JAX package's lazy exports that the port does not carry yet
_NOT_PORTED = {
    "DhtNetwork": ".network",
    "PerformanceTest": ".scenarios",
    "PersistenceTest": ".scenarios",
    "LatencyStats": ".scenarios",
}


def __getattr__(name):
    mod = _NOT_PORTED.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    raise AttributeError(
        f"opendht_tpu_torch.testing.{name} (testing/{mod[1:]}.py) is not "
        f"ported yet (ROADMAP A.6); VirtualNet and trace_assembler are")


__all__ = ["VirtualNet"]
