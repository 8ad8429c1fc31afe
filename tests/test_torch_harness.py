"""The port's scenario harness (``testing/network.py`` ``DhtNetwork``,
``testing/scenarios.py``, ``testing/benchmark.py``, ``testing/pingpong.py``)
against the JAX package's, on the CPU, tolerance 0.

- The four cases of tests/test_harness.py on the port's ``VirtualNet``
  (``device="cpu"``), each beside the same scenario in the JAX package
  under the same seed (the same ``random`` state and ``os.urandom``
  stream, so the same node ids): the same gets counted, the same
  holders of a put, the same holders killed and the same verdicts.
  tests/test_harness.py marks its persistence case slow; the port's runs
  here, and the JAX package's persistence scenario is held to the
  port's through ``benchmark -t persistence`` below.
- ``python -m opendht_tpu_torch.testing.benchmark -t gets|delete|
  persistence --cpu`` prints the JAX CLI's JSON under the same seed,
  once times (virtual latencies) are masked; ``--real`` runs a
  ``DhtNetwork``.
- tests/test_chaos.py's ``DhtNetwork`` case on the port, and a
  ``DhtNetwork`` whose later nodes (``launch_node``, ``replace_cluster``)
  run on the device it was given.
- ``pingpong --cpu``; and without a card and without ``--cpu``,
  ``benchmark``, ``pingpong``, ``DhtNetwork`` and every smoke
  (``telemetry_smoke`` and the thirteen of tests/test_torch_smokes_*.py)
  raise before any node is built or socket bound.
- Every ``testing`` module of the JAX package resolves on the port's
  ``testing`` package.

A JAX node polls each wave's result and, while it is not ready, re-arms
the poll 2 ms of virtual time later, so on a loaded host the virtual
clock can run ahead of JAX's asynchronous CPU dispatch; the JAX nets
here take a wave's result as ready at its first poll, as on an unloaded
host (the manner of tests/test_torch_pht.py).  The real-UDP cases give
every wait its own limit of at least 60 s.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import random

import pytest
import torch

from opendht_tpu_torch.core.value import Value
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.runtime.config import Config
from opendht_tpu_torch.testing import (DhtNetwork, LatencyStats,
                                       PerformanceTest, PersistenceTest)
from opendht_tpu_torch.testing.scenarios import build_net

CPU = "cpu"
WAIT = 60.0


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads while this file's nodes run: their ops are
    tiny, and beside other busy test processes all-core OpenMP pools
    spin against each other and slow every process on the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _seeded(monkeypatch, seed: int) -> None:
    """The same ``random`` state and one ``os.urandom`` stream (which
    ``secrets``, and so ``InfoHash.get_random``, draws through
    ``random._urandom``) before each net of a twin pair."""
    random.seed(seed)
    rng = random.Random(seed ^ 0x5EED)

    def urandom(n):
        return bytes(rng.getrandbits(8) for _ in range(n))
    monkeypatch.setattr(os, "urandom", urandom)
    monkeypatch.setattr(random, "_urandom", urandom)


@pytest.fixture
def jax_sync_dispatch(monkeypatch):
    """A JAX wave's result counts as ready at its first poll (its consume
    then waits for the computation), as on an unloaded host."""
    from opendht_tpu.core.table import PendingLookup as JPending
    monkeypatch.setattr(JPending, "ready", lambda self: True)


def _jax():
    """The JAX package's scenario names."""
    from opendht_tpu.core.value import Value as JValue
    from opendht_tpu.infohash import InfoHash as JHash
    from opendht_tpu.runtime.config import Config as JConfig
    from opendht_tpu.testing import PerformanceTest as JPerf
    from opendht_tpu.testing.scenarios import build_net as jbuild
    return JValue, JHash, JConfig, JPerf, jbuild


# ------------------------------------------ tests/test_harness.py's cases
def test_gets_times_with_replacement(monkeypatch, jax_sync_dispatch):
    _seeded(monkeypatch, 5)
    net = build_net(12, seed=5, device=CPU)
    s = PerformanceTest(net, seed=5).gets_times(
        rounds=2, gets_per_round=6, replace=2, config=Config()).summary()
    assert s["count"] == 12
    assert 0 < s["mean"] < 5.0          # virtual seconds
    assert s["min"] > 0
    _, _, JConfig, JPerf, jbuild = _jax()
    _seeded(monkeypatch, 5)
    js = JPerf(jbuild(12, seed=5), seed=5).gets_times(
        rounds=2, gets_per_round=6, replace=2, config=JConfig()).summary()
    assert js["count"] == s["count"]
    assert len(net.nodes) == 12


def _holders(pkg, monkeypatch):
    """tests/test_harness.py's replication scenario in ``pkg``: the
    holders of one put and the ranking of every node by distance."""
    if pkg == "port":
        _seeded(monkeypatch, 2)
        net, H, V = build_net(16, seed=2, device=CPU), InfoHash, Value
    else:
        JValue, JHash, _, _, jbuild = _jax()
        _seeded(monkeypatch, 2)
        net, H, V = jbuild(16, seed=2), JHash, JValue
    key = H.get("replication-check")
    nodes = list(net.nodes.values())
    done = []
    nodes[-1].put(key, V(b"x"), lambda ok, ns: done.append(ok))
    assert net.run(max_time=30.0, until=lambda: bool(done))
    holders = {bytes(d.myid) for d in net.storers_of(key)}
    ranked = sorted(nodes, key=lambda d: bytes(
        a ^ b for a, b in zip(bytes(d.myid), bytes(key))))
    return holders, [bytes(d.myid) for d in ranked]


def test_replication_is_k_closest(monkeypatch, jax_sync_dispatch):
    """A put lands on the 8 XOR-closest nodes (+ the putter's local
    store), the same nodes in both packages."""
    holders, ranked = _holders("port", monkeypatch)
    closest8 = set(ranked[:8])
    # announce targets the 8 closest *synced* nodes; sync order can swap
    # a couple of boundary ranks, so require strong overlap, not equality
    assert len(closest8 & holders) >= 6
    assert len(holders) <= 10           # ~8 + putter (+ sync-drift slack)
    jholders, jranked = _holders("jax", monkeypatch)
    assert ranked == jranked
    assert holders == jholders


def test_delete_reports_holders(monkeypatch, jax_sync_dispatch):
    _seeded(monkeypatch, 3)
    survived, holders = PerformanceTest(
        build_net(10, seed=3, device=CPU), seed=3).delete_test()
    assert holders >= 8                 # value was replicated before kill
    assert isinstance(survived, bool)
    _, _, _, JPerf, jbuild = _jax()
    _seeded(monkeypatch, 3)
    assert JPerf(jbuild(10, seed=3), seed=3).delete_test() == \
        (survived, holders)


def test_persistence_under_churn():
    conf = Config(maintain_storage=True)
    net = build_net(14, seed=4, config=conf, device=CPU)
    ok = PersistenceTest(net, seed=4).churn_survival(
        kills=3, between=700.0, config=conf)
    assert ok


def test_latency_stats_equal_the_jax_summary():
    from opendht_tpu.testing import LatencyStats as JStats
    samples = [0.5, 0.25, 3.0, 0.125, 1.0]
    a, b = LatencyStats(), JStats()
    for x in samples:
        a.add(x)
        b.add(x)
    assert a.summary() == b.summary()
    assert LatencyStats().summary() == JStats().summary()


# ---------------------------------------------------- the benchmark CLI
def _bench(main, argv) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, json.loads(out.getvalue())


TIMES = ("sum", "mean", "std", "min", "max")


@pytest.mark.parametrize("argv", [
    ["-t", "gets", "-n", "16", "-r", "2", "-g", "8"],
    ["-t", "delete", "-n", "12"],
    ["-t", "persistence", "-n", "12", "--replace", "2"],
], ids=["gets", "delete", "persistence"])
def test_benchmark_prints_the_jax_json(argv, monkeypatch,
                                       jax_sync_dispatch):
    from opendht_tpu.testing import benchmark as jbench
    from opendht_tpu_torch.testing import benchmark as pbench
    _seeded(monkeypatch, 3)
    jrc, jout = _bench(jbench.main, argv)
    _seeded(monkeypatch, 3)
    rc, out = _bench(pbench.main, argv + ["--cpu"])
    assert (rc, set(out)) == (jrc, set(jout)) == (0, set(jout))
    masked = {k: ("time" if k in TIMES else v) for k, v in out.items()}
    assert masked == {k: ("time" if k in TIMES else v)
                      for k, v in jout.items()}
    if argv[1] == "gets":
        assert out["count"] == 16 and out["min"] > 0
    elif argv[1] == "delete":
        assert out["holders_killed"] >= 8
    else:
        assert out["survived"] is True


def test_benchmark_real_runs_a_dhtnetwork_on_the_cpu():
    from opendht_tpu_torch.testing import benchmark as pbench
    rc, out = _bench(pbench.main, ["-t", "gets", "--real", "-n", "4",
                                   "-r", "1", "-g", "3", "--cpu"])
    assert rc == 0
    assert (out["test"], out["backend"], out["nodes"], out["count"]) == \
        ("gets", "real", 4, 3)
    assert 0 < out["min"] <= out["max"] < WAIT


# ----------------------------------------------------------- DhtNetwork
def test_dhtnetwork_arm_covers_late_launched_nodes():
    """tests/test_chaos.py's case: a node launched AFTER DhtNetwork.arm
    (churn replacement) is hooked too."""
    from opendht_tpu_torch.chaos import FaultPlan, Partition, Phase
    net = DhtNetwork(2, device=CPU)
    try:
        plan = FaultPlan([Phase(
            "cut", partition=Partition(block=[("a", "b")]))])
        net.arm(plan, groups={0: "a"}, default_group="b")
        for r in net.nodes:
            assert r._dht._dht.engine.fault_hook is not None
        late = net.launch_node()
        eng = late._dht._dht.engine
        assert eng.fault_hook is not None, \
            "late-launched node escaped the armed plan"
        key = ("127.0.0.1", late.get_bound_port())
        assert net.injector.plan.membership[key] == "b"
        net.disarm()
        assert all(r._dht._dht.engine.fault_hook is None
                   for r in net.nodes)
    finally:
        net.shutdown()


def test_dhtnetwork_serves_and_its_later_nodes_keep_its_device():
    with DhtNetwork(4, config=Config(max_req_per_sec=100_000), seed=1,
                    device=CPU) as net:
        assert net.wait_connected(2 * WAIT)
        # warm-up on a key of its own, unchecked
        net.put(InfoHash.get("harness-warm"), Value(b"w"), timeout=WAIT)
        key = InfoHash.get("harness-network")
        assert net.put(key, Value(b"net value", value_id=7), timeout=WAIT)
        assert [v.data for v in net.get(key, timeout=WAIT)] == [b"net value"]
        net.shutdown_node()
        net.replace_cluster(1)
        net.launch_node()
        assert len(net) == 4
        assert all(r._dht._dht.device == torch.device(CPU)
                   for r in net.nodes)
        assert net.wait_connected(2 * WAIT)
        assert [v.data for v in net.get(key, timeout=WAIT)] == [b"net value"]
    assert len(net) == 0


# ------------------------------------------------------------- pingpong
def test_pingpong_on_the_cpu():
    from opendht_tpu_torch.testing import pingpong
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert pingpong.main(["-n", "3", "--cpu"]) == 0
    doc = json.loads(out.getvalue())
    assert (doc["test"], doc["rounds"]) == ("pingpong", 3)
    assert doc["count"] == 3 and 0 < doc["max"] < 10.0


# --------------------------------------------------- the card by default
SMOKES = ("telemetry_smoke", "ledger_smoke", "health_smoke",
          "history_smoke", "waterfall_smoke", "peer_smoke",
          "keyspace_smoke", "cache_smoke", "listener_smoke",
          "ingest_smoke", "pipeline_smoke", "pipeline_util_smoke",
          "reshard_smoke", "chaos_smoke")


def _smoke_main(name: str):
    import importlib
    mod = importlib.import_module("opendht_tpu_torch.testing." + name)
    return lambda: mod.main([])


def _harness_entry_points():
    from opendht_tpu_torch.testing import benchmark, pingpong
    return {
        "benchmark": lambda: benchmark.main(["-t", "delete", "-n", "4"]),
        "benchmark --real": lambda: benchmark.main(["--real", "-n", "2"]),
        "pingpong": lambda: pingpong.main(["-n", "1"]),
        "DhtNetwork": lambda: DhtNetwork(1),
        "build_net": lambda: build_net(2),
        **{name: _smoke_main(name) for name in SMOKES},
    }


@pytest.mark.parametrize("name", sorted(_harness_entry_points()))
def test_without_a_card_the_harness_raises(name, monkeypatch):
    import socket
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bound = []
    orig_bind = socket.socket.bind
    monkeypatch.setattr(socket.socket, "bind",
                        lambda self, *a: bound.append(a) or
                        orig_bind(self, *a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _harness_entry_points()[name]()
    assert bound == []


def test_the_testing_package_names_what_is_not_ported():
    """Nothing is left unported: every module of the JAX package's
    ``testing`` resolves as an attribute of the port's."""
    import pkgutil
    import opendht_tpu.testing as J
    import opendht_tpu_torch.testing as T
    assert T.DhtNetwork is DhtNetwork and T.LatencyStats is LatencyStats
    assert set(T.__all__) == {"VirtualNet", "DhtNetwork", "PerformanceTest",
                              "PersistenceTest", "LatencyStats"}
    names = {m.name for m in pkgutil.iter_modules(J.__path__)}
    assert set(SMOKES) <= names and len(names) == 29
    for name in sorted(names):
        mod = getattr(T, name)
        assert mod.__name__ == "opendht_tpu_torch.testing." + name
    assert not hasattr(T, "_NOT_PORTED")
    from opendht_tpu_torch.testing import subproc_cluster
    assert T.subproc_cluster is subproc_cluster
    assert T.peer_smoke.main is not None
    with pytest.raises(AttributeError, match="no attribute"):
        T.no_such_module
