"""End-to-end adversarial chaos smoke.

Three tiers in one smoke, closing the produce→judge loop the
observability stack was built for:

1. **Real-UDP partition + heal**: a scripted FaultPlan isolates the
   proxied node of a 4-node cluster (symmetric partition at the
   engine fault hooks — the same seam the virtual net uses).  Its gets
   fail, the availability SLO burns, ``GET /healthz`` degrades, a
   black-box bundle auto-captures on the unhealthy transition, and
   ``dhtmon --since`` flags the burn window.  Healing (plan disarmed,
   node re-bootstrapped) rolls the verdict back: /healthz 200,
   ``dhtmon --since`` clean.
2. **Virtual-net storm with the chaos-off pin**: the same seeded
   scenario run unarmed and with an armed-but-EMPTY FaultPlan delivers
   identical results with zero drops (chaos-off == baseline); then a
   real storm (per-link loss + dup + reorder rules, an asymmetric
   partition phase, join/leave storm steps) runs through its phases
   with per-rule drop accounting and the cluster still serves every
   key after the plan ends.
3. **Device swarm storm**: a 4096-node SwarmSim steps a scripted
   join/leave storm plus partition-and-heal on device; the
   lookup-success and replica-coverage invariants degrade during the
   cut and are restored after healing, deterministic under the seed.

Run directly::

    python -m opendht_tpu_torch.testing.chaos_smoke [--cpu]

Its nodes run on the CUDA card unless ``--cpu`` is given; without a card
(and without ``--cpu``) it raises before any socket is bound.

The port's copy of the JAX package's ``testing/chaos_smoke.py``,
behaviour unchanged but for the nodes' device and two waits (ROADMAP
C.3).  The virtual-net tier's chaos-off pin waits for the pinned put to
complete before its get: the JAX copy's get races the put, so whether
it finds the value depends on the run's random node ids, and the pin's
two runs of one seeded scenario can disagree.  And the real-UDP tier's
healthy baseline is :func:`healthy_baseline`: the JAX copy reads the
verdict once, four ticks after its traffic, and on a loaded host a
slow window latches the degrade-only ``stage_budget`` signal, which
only fresh stage samples clear — and a quiet cluster makes none.
"""

from __future__ import annotations

import sys
import time

from .. import chaos
from ..core.value import Value
from ..health import HEALTHY
from .._device import resolve_device
from ..infohash import InfoHash
from ..runtime.config import Config, NodeStatus
from ..tools import dhtmon

N_NODES = 4
TICK = 0.25
OP_TIMEOUT = 30.0


def _wait(pred, timeout=30.0, step=0.05) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(step)
    return pred()


def healthy_baseline(runner) -> dict:
    """``runner``'s health report once its verdict is healthy, with a
    burst of 8 gets of 8 distinct keys each tick until then (at most
    ``OP_TIMEOUT``): a burst's 8 searches land in one stage window,
    enough fresh samples (``waterfall._BUDGET_MIN_EVENTS``) to clear a
    latched ``stage_budget`` level from the process-wide profiler, whose
    window every co-resident node's tick consumes.  A healthy node gets
    nothing.  Returns the last report read."""
    keys = [InfoHash.get("chaos-smoke-baseline-%d" % i) for i in range(8)]
    t0 = time.monotonic()
    while True:
        health = runner.get_health()
        if health["verdict"] == HEALTHY \
                or time.monotonic() - t0 > OP_TIMEOUT:
            return health
        done = []
        for key in keys:
            runner.get(key, lambda vals: True,
                       lambda ok, ns: done.append(ok))
        _wait(lambda: len(done) == len(keys), timeout=OP_TIMEOUT)
        time.sleep(TICK)


# ------------------------------------------------------- 1: real-UDP tier
def real_udp_partition_heal(device=None) -> None:
    from ..proxy import DhtProxyServer
    from .network import DhtNetwork

    cfg = Config()
    cfg.health.period = TICK
    cfg.history.period = TICK
    # short burn windows so recovery rolls the latched SLO clean within
    # smoke time (the defaults keep a burn in the 600 s slow window for
    # ten minutes — correct in production, hostile to a CI smoke)
    cfg.health.fast_window = 3.0
    cfg.health.slow_window = 10.0
    net = DhtNetwork(N_NODES, config=cfg, device=device)
    runners = net.nodes
    proxy = None
    try:
        proxy = DhtProxyServer(runners[0], 0)
        assert net.wait_connected(), "cluster failed to connect"
        ep = "127.0.0.1:%d" % proxy.port

        keys = [InfoHash.get("chaos-smoke-%d" % i) for i in range(6)]
        for i, key in enumerate(keys):
            assert runners[1 + i % (N_NODES - 1)].put_sync(
                key, Value(b"cv-%d" % i), timeout=OP_TIMEOUT)
        assert runners[0].get_sync(keys[0], timeout=OP_TIMEOUT)
        time.sleep(4 * TICK)          # frames + healthy baseline
        health = healthy_baseline(runners[0])
        assert health["verdict"] == HEALTHY, health
        pre_bundles = len(runners[0].get_bundles())

        # --- scripted partition: node 0 isolated via the harness's
        # public arm() (one injector, per-engine fault hooks; the cut
        # is enforced at each sender — netem egress semantics)
        plan = chaos.FaultPlan([chaos.Phase(
            "island", start=0.0, duration=None,
            partition=chaos.Partition(block=[("island", "mainland")],
                                      symmetric=True))])
        inj = net.arm(plan, groups={0: "island"},
                      default_group="mainland")

        fails = []
        for i in range(8):
            runners[0].get(InfoHash.get("chaos-miss-%d" % i),
                           lambda vals: True,
                           lambda ok, ns: fails.append(ok))
        assert _wait(lambda: len(fails) == 8, timeout=60.0), \
            "partitioned gets never completed (%d/8)" % len(fails)
        assert not any(fails), "gets succeeded across the partition"
        assert inj.dropped_by_rule().get("partition:island", 0) > 0

        assert _wait(lambda: runners[0].get_health()["verdict"]
                     == "unhealthy", timeout=30.0), \
            "verdict never burned: %r" % (runners[0].get_health(),)
        # /healthz degrades over the proxy
        import urllib.error
        import urllib.request
        try:
            with urllib.request.urlopen("http://%s/healthz" % ep,
                                        timeout=10) as resp:
                code = resp.status
        except urllib.error.HTTPError as e:
            code = e.code
        assert code == 503, "healthz should be 503 mid-partition"
        # black-box bundle auto-captured on the unhealthy transition
        assert _wait(lambda: len(runners[0].get_bundles()) > pre_bundles,
                     timeout=15.0), "no auto bundle after the burn"
        bundle = runners[0].get_bundles()[-1]
        assert bundle["transition"]["to"] == "unhealthy"
        # dhtmon --since flags the burn window
        rc = dhtmon.main(["--nodes", ep, "--min-success", "0.99",
                          "--since", "60"])
        assert rc != 0, "dhtmon --since missed the burn"

        # --- heal: plan disarmed through the harness, node
        # re-bootstrapped
        net.disarm()
        runners[0].bootstrap("127.0.0.1", runners[1].get_bound_port())
        assert _wait(lambda: runners[0].get_status()
                     is NodeStatus.CONNECTED, timeout=30.0), \
            "node never reconnected after heal"
        # healthy traffic again: the healed node serves stored values
        for key in keys:
            assert runners[0].get_sync(key, timeout=OP_TIMEOUT), \
                "healed node cannot read stored values"
        assert _wait(lambda: runners[0].get_health()["verdict"]
                     != "unhealthy", timeout=30.0), \
            "verdict never recovered: %r" % (runners[0].get_health(),)
        time.sleep(8 * TICK)          # roll the burn out of short window
        rc = dhtmon.main(["--nodes", ep, "--min-success", "0.99",
                          "--since", "1.0"])
        assert rc == 0, "dhtmon --since still alerting after recovery"
        print("chaos_smoke[udp]: OK — partition burned the SLO "
              "(healthz 503, bundle captured, dhtmon --since 1), heal "
              "recovered (healthz 200, dhtmon --since 0)")
    finally:
        if proxy is not None:
            proxy.stop()
        net.shutdown()


# ---------------------------------------------------- 2: virtual-net tier
def virtual_net_storm(device=None) -> None:
    from .virtual_net import VirtualNet

    def scenario(plan):
        net = VirtualNet(seed=31, plan=plan, device=device)
        seed = net.add_node()
        for _ in range(11):
            net.add_node()
        net.bootstrap_all(seed)
        assert net.run(60, net.all_connected)
        nodes = list(net.nodes.values())
        key = InfoHash.get("chaos-smoke-pin")
        stored = {}
        nodes[2].put(key, Value(b"pin"),
                     lambda ok, ns: stored.update(ok=ok))
        assert net.run(60, lambda: "ok" in stored) and stored["ok"]
        got, done = [], {}
        nodes[7].get(key, lambda vals: got.extend(vals) or True,
                     lambda ok, ns: done.update(ok=ok))
        assert net.run(60, lambda: "ok" in done)
        return [v.data for v in got], net.dropped, dict(net.dropped_by_rule)

    base = scenario(None)
    armed = scenario(chaos.FaultPlan([]))
    assert base == armed and base[1] == 0, (base, armed)

    # the storm: per-link loss + dup + reorder, a timed asymmetric
    # partition phase, and join/leave storm steps
    net = VirtualNet(seed=32, device=device)
    seed_node = net.add_node()
    for _ in range(23):
        net.add_node()
    net.bootstrap_all(seed_node)
    assert net.run(120, net.all_connected)
    nodes = list(net.nodes.values())
    keys = [InfoHash.get("storm-key-%d" % i) for i in range(4)]
    for i, k in enumerate(keys):
        done = {}
        nodes[2 + i].put(k, Value(b"storm-%d" % i),
                         lambda ok, ns, d=done: d.update(ok=ok))
        assert net.run(60, lambda d=done: "ok" in d) and done["ok"]

    half = [d for d in nodes[:12]]
    plan = chaos.FaultPlan([
        chaos.Phase("weather", start=0.0, duration=30.0, rules=[
            chaos.LinkRule(name="loss", loss=0.25),
            chaos.LinkRule(name="dup", dup=0.1),
            chaos.LinkRule(name="reorder", reorder=0.2,
                           reorder_delay=0.2)]),
        chaos.Phase("cut", start=5.0, duration=15.0,
                    partition=chaos.Partition(block=[("west", "east")])),
    ], seed=5)
    net.arm(plan)
    for d in nodes:
        net.set_group(d, "west" if d in half else "east")
    storm = chaos.Storm(leave_rate=0.15, join_rate=0.1)
    for _ in range(3):
        net.step_storm(storm, seed_node)
        net.settle(10.0)
    net.settle(15.0)              # plan phases over: healed
    for rule in ("loss", "partition:cut"):
        assert net.dropped_by_rule.get(rule, 0) > 0, \
            "%s never accounted: %r" % (rule, net.dropped_by_rule)
    assert net.injector.counts.get("dup", {}).get("dup", 0) > 0
    assert net.injector.counts.get("reorder", {}).get("reordered", 0) > 0
    # storm survival: every stored key still resolvable post-heal
    for i, k in enumerate(keys):
        got, done = [], {}
        survivor = [d for d in net.nodes.values()][5]
        survivor.get(k, lambda vals, g=got: g.extend(vals) or True,
                     lambda ok, ns, d=done: d.update(ok=ok))
        assert net.run(120, lambda d=done: "ok" in d), \
            "post-heal get %d never completed" % i
        assert any(v.data == b"storm-%d" % i for v in got), \
            "key %d lost in the storm" % i
    print("chaos_smoke[vnet]: OK — chaos-off == baseline pinned, storm "
          "dropped %r, all %d keys survived"
          % (net.dropped_by_rule, len(keys)))


# -------------------------------------------------------- 3: device swarm
def swarm_storm(n_nodes: int = 4096, device=None) -> None:
    from ..ops.swarm import SwarmSim

    plan = chaos.FaultPlan([
        chaos.Phase("storm", start=1.0, duration=3.0,
                    storm=chaos.Storm(leave_rate=0.1, join_rate=0.1)),
        chaos.Phase("refill", start=4.0, duration=3.0,
                    storm=chaos.Storm(join_rate=0.5)),
        chaos.Phase("split", start=8.0, duration=6.0,
                    partition=chaos.Partition(block=[("g0", "g1")],
                                              symmetric=True)),
    ], seed=3)
    sim = SwarmSim(plan, n_nodes=n_nodes, n_keys=48, n_groups=2,
                   seed=5, sweep_sample=32, repub_every=2, device=device)
    hist = sim.run(22)
    assert hist[0]["verdict"] == HEALTHY
    assert any(m["verdict"] != HEALTHY for m in hist[9:13]), \
        "partition never degraded the swarm invariants"
    last = hist[-1]
    assert last["verdict"] == HEALTHY, last
    assert last["lookup_success"] >= 0.95
    assert last["replica_coverage"] >= 0.95
    print("chaos_smoke[swarm]: OK — %d-node swarm degraded to %s mid-"
          "partition, healed to success=%.2f coverage=%.2f"
          % (n_nodes, min(m["verdict"] for m in hist[9:13]),
             last["lookup_success"], last["replica_coverage"]))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    resolve_device(device)        # no card and no --cpu: raise here
    real_udp_partition_heal(device)
    virtual_net_storm(device)
    swarm_storm(device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
