"""The port's chaos plane (``opendht_tpu_torch/chaos.py``, host-only)
against the JAX package's.

- The plan grammar (phase windows, link rules, partitions, storms and
  poison) answers the same.
- One ``FaultPlan`` gives the same fates on both injectors for the same
  seeded packet stream — drops, duplicates, delays and their per-rule
  counts — and the same ``dht_chaos_injected_total`` series on each
  package's registry.
- ``arm_dht`` keeps its guard (``Config.chaos_enabled``, False by
  default in both) and, armed with ``force=True`` on twin nodes at the
  defaults (``tests/test_torch_hotcache.TwinNode``), gives the same
  datagrams at the same virtual times: loss, duplication and delay on
  the live engine's send path; disarmed, the path is the unarmed one.
"""

from __future__ import annotations

import numpy as np
import pytest

from opendht_tpu import chaos as JC
from opendht_tpu_torch import chaos as PC

from test_torch_hotcache import (JAX, PORT, TwinNode, fresh_registries,
                                 zipf_stream)

CHAOS = {JAX: JC, PORT: PC}


def plan(C, seed: int = 1337):
    """A plan of every phase kind over groups a / b / c."""
    return C.FaultPlan([
        C.Phase("lossy", 0.0, 2.0, rules=[
            C.LinkRule(name="ab", src="a", dst="b", loss=0.3, dup=0.2,
                       reorder=0.2, reorder_delay=0.05, delay=0.01,
                       jitter=0.02),
            C.LinkRule(name="any-dup", dup=0.1, symmetric=True)]),
        C.Phase("cut", 1.0, 1.5, partition=C.Partition(block=[("c", "a")])),
        C.Phase("storm", 2.5, None, storm=C.Storm(0.1, 0.2),
                poison=C.Poison("b", 4, 2),
                rules=[C.LinkRule(name="slow", src="b", delay=0.2)]),
    ], membership={("127.0.0.%d" % i, 4000 + i): "abc"[i % 3]
                   for i in range(9)}, seed=seed)


def test_plan_grammar_answers_the_same():
    j, p = plan(JC), plan(PC)
    for rel in (0.0, 0.5, 1.2, 2.2, 2.5, 9.0):
        assert [x.name for x in p.phases_at(rel)] == \
            [x.name for x in j.phases_at(rel)]
        assert repr(p.storm_at(rel)) == repr(j.storm_at(rel)).replace(
            "opendht_tpu.", "opendht_tpu_torch.")
        assert (p.poison_at(rel) is None) == (j.poison_at(rel) is None)
        assert [n for n, _ in p.partitions_at(rel)] == \
            [n for n, _ in j.partitions_at(rel)]
    assert p.end_time() == j.end_time() is None
    for s, d in (("a", "b"), ("b", "a"), ("c", "a"), ("x", "y")):
        assert PC.LinkRule(src="a", dst="b", symmetric=True).matches(s, d) \
            == JC.LinkRule(src="a", dst="b", symmetric=True).matches(s, d)
        assert PC.Partition(block=[("a", "b")]).blocks(s, d) == \
            JC.Partition(block=[("a", "b")]).blocks(s, d)


@pytest.mark.parametrize("seed", [1337, 7])
def test_same_plan_same_fates(monkeypatch, seed):
    regs = fresh_registries(monkeypatch)
    inj = {pkg: C.FaultInjector(plan(C, seed)) for pkg, C in CHAOS.items()}
    rng = np.random.default_rng(seed)
    fates = {JAX: [], PORT: []}
    for pkg in (JAX, PORT):
        assert inj[pkg].fate(("127.0.0.0", 4000), ("x", 1), 0.0) == \
            CHAOS[pkg].Fate()              # unarmed: pass
        inj[pkg].arm(10.0)
    for i in range(2000):
        a, b = (int(x) for x in rng.integers(0, 9, size=2))
        src, dst = ("127.0.0.%d" % a, 4000 + a), ("127.0.0.%d" % b, 4000 + b)
        now = 10.0 + i * 0.002
        for pkg in (JAX, PORT):
            f = inj[pkg].fate(src, dst, now)
            fates[pkg].append((f.drop, f.dup, f.delay, f.rule, f.touched))
    assert fates[PORT] == fates[JAX]
    assert inj[PORT].counts == inj[JAX].counts
    assert inj[PORT].dropped_by_rule() == inj[JAX].dropped_by_rule()
    assert set(inj[JAX].counts) == {"ab", "any-dup", "partition:cut",
                                    "slow"}
    series = {pkg: {k: m.value for k, m in regs[pkg].series(
        "dht_chaos_injected_total").items()} for pkg in (JAX, PORT)}
    assert series[PORT] == series[JAX] and series[JAX]
    for pkg in (JAX, PORT):
        inj[pkg].disarm()
        assert not inj[pkg].armed


def test_arm_dht_is_guarded_by_chaos_enabled(monkeypatch):
    for pkg in (JAX, PORT):
        node = TwinNode(pkg, monkeypatch, None, "chaos-guard")
        assert node.dht.config.chaos_enabled is False
        inj = CHAOS[pkg].FaultInjector(plan(CHAOS[pkg]))
        with pytest.raises(RuntimeError, match="chaos_enabled"):
            CHAOS[pkg].arm_dht(node.dht, inj)
        allowed = TwinNode(pkg, monkeypatch, None, "chaos-guard",
                           chaos_enabled=True)
        CHAOS[pkg].arm_dht(allowed.dht, inj, src_key=("127.0.0.1", 4001))
        assert allowed.dht.engine.fault_hook is not None
        CHAOS[pkg].disarm_dht(allowed.dht)
        assert allowed.dht.engine.fault_hook is None


def run_armed(node: TwinNode, pkg: str, keys, ranks) -> dict:
    """Gets over a node whose engine carries a lossy, duplicating,
    delaying plan for its first 3 virtual s, then disarmed."""
    C = CHAOS[pkg]
    membership = {("127.0.0.2", 4567): "peers"}
    inj = C.FaultInjector(C.FaultPlan([C.Phase("net", 0.0, 3.0, rules=[
        C.LinkRule(name="out", src="me", dst="peers", loss=0.2, dup=0.2,
                   delay=0.01, jitter=0.05, reorder=0.1)])],
        membership=membership, seed=99))
    C.arm_dht(node.dht, inj, src_key=("me-host", 1), force=True)
    inj.plan.membership[("me-host", 1)] = "me"
    inj.arm(node.clock["t"])
    results = []
    t = 0.0
    for i, r in enumerate(ranks):
        node.dht.get(node.key(keys[r]), lambda v: True,
                     lambda ok, ns, i=i: results.append((i, ok,
                                                         node.clock["t"])))
        t += 0.02
        node.advance(t)
    C.disarm_dht(node.dht)
    node.advance(t + 6.0, step=0.01)
    return {"sent": node.sent, "results": results, "counts": inj.counts}


def test_armed_twin_nodes_send_the_same_datagrams(monkeypatch):
    fresh_registries(monkeypatch)
    keys, ranks = zipf_stream(30, 20, 80, 1.1)
    sweeps = []
    want = run_armed(TwinNode(JAX, monkeypatch, sweeps, "chaos-twin"),
                     JAX, keys, ranks)
    got = run_armed(TwinNode(PORT, monkeypatch, sweeps, "chaos-twin"),
                    PORT, keys, ranks)
    assert not sweeps
    assert want["counts"]["out"]["dropped"] > 0
    assert want["counts"]["out"]["dup"] > 0
    assert got["counts"] == want["counts"]
    assert got["results"] == want["results"]
    assert got["sent"] == want["sent"]
