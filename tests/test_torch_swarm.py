"""The port's swarm stepper (``opendht_tpu_torch.ops.swarm``) against the
JAX package's (``opendht_tpu.ops.swarm``), twinning tests/test_swarm.py.

The port draws its bits from seeded ``torch.Generator``s, which cannot
reproduce ``jax.random``; so the JAX sims are carried into the port
(``convert.swarm_from_jax``) and both step on the JAX sim's own bits.
Tolerance: 0 — every state array, metric and probe value equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opendht_tpu import chaos as JC
from opendht_tpu.ops import radix as JR
from opendht_tpu.ops import swarm as JS
from opendht_tpu_torch import chaos, convert, telemetry, tracing
from opendht_tpu_torch.health import DEGRADED, HEALTHY, UNHEALTHY
from opendht_tpu_torch.ops import ids as TK
from opendht_tpu_torch.ops import radix as TR
from opendht_tpu_torch.ops import swarm


def full_plan(mod=chaos, seed=3):
    """Every phase kind: storm, recovery, asymmetric partition, poison."""
    return mod.FaultPlan([
        mod.Phase("storm", start=1.0, duration=3.0,
                  storm=mod.Storm(leave_rate=0.2, join_rate=0.1)),
        mod.Phase("lossy", start=1.0, duration=6.0,
                  rules=[mod.LinkRule(name="wan", loss=0.2)]),
        mod.Phase("split", start=5.0, duration=4.0,
                  partition=mod.Partition(block=[("g0", "g1")])),
        mod.Phase("poison", start=9.0, duration=3.0,
                  poison=mod.Poison(victim="g1", per_bucket=8)),
        mod.Phase("recover", start=12.0, duration=3.0,
                  storm=mod.Storm(join_rate=0.5)),
    ], seed=seed)


def _same_state(port_state, jax_state, where=""):
    got = swarm.state_to_numpy(port_state)
    for k in swarm.STATE_KEYS:
        want = np.asarray(jax_state[k])
        assert got[k].dtype == want.dtype, (where, k)
        np.testing.assert_array_equal(got[k], want, err_msg=f"{where} {k}")


def _jax_bits(jsim):
    """The bits the JAX sim's next tick draws (its own key split)."""
    _, k1, k2 = jax.random.split(jsim._key, 3)
    S = jsim._group_host.shape[0]
    K = np.asarray(jsim.state["keys"]).shape[0]
    return (np.asarray(jax.random.bits(k1, (S, 3), jnp.uint32)),
            np.asarray(jax.random.bits(k2, (K,), jnp.uint32)))


# ------------------------------------------------------------ JAX twins
@pytest.mark.parametrize("n_nodes,n_keys,sweep", [(64, 8, 8), (256, 16, 16),
                                                  (1024, 32, 32)])
def test_step_bit_identical_to_jax_through_every_phase(n_nodes, n_keys,
                                                       sweep):
    """16 ticks of storm, loss, partition, poison and recovery, republish
    every other tick: the port step equals the JAX step on every state
    array, metric and probe."""
    kw = dict(n_nodes=n_nodes, n_keys=n_keys, n_groups=2, seed=5,
              sweep_sample=sweep, repub_every=2)
    jsim = JS.SwarmSim(full_plan(JC), device=True, **kw)
    psim = convert.swarm_from_jax(jsim, device="cpu")
    _same_state(psim.state, jsim.state, "init")
    phases = set()
    for t in range(16):
        bits = _jax_bits(jsim)
        mj = jsim.tick()
        mp = psim.advance(*bits)
        assert mp == {k: int(v) for k, v in mj.items()}, (t, mp, mj)
        _same_state(psim.state, jsim.state, f"tick {t}")
        assert psim.probe() == jsim.probe(), t
        phases.add(psim._phase_names)
    assert {"storm", "split", "poison", "recover"} <= {
        n for names in phases for n in names}


def test_swarm_step_function_equals_jax_on_predrawn_bits():
    """The step function itself, on a JAX state and numpy bits, with the
    poison admission and the republish branch both taken."""
    S, K, M = 512, 16, 16
    host = JS.init_swarm(21, S, K)
    rng = np.random.default_rng(4)
    rand_node = rng.integers(0, 2 ** 32, size=(S, 3), dtype=np.uint32)
    rand_key = rng.integers(0, 2 ** 32, size=(K,), dtype=np.uint32)
    reach = np.array([[True, False], [True, True]])
    mask = np.arange(S) >= S // 2
    args = (np.float32(3.0), np.float32(0.15), np.float32(0.1),
            np.float32(0.2), np.float32(1.0), np.float32(5.0), reach, True,
            mask, np.int32(4), True, np.arange(40, 40 + M, dtype=np.int32),
            rand_node, rand_key)
    js, jm = JS.swarm_step({k: jnp.asarray(v) for k, v in host.items()},
                           *args)
    ps, pm = swarm.swarm_step(swarm.state_to_device(host, "cpu"), *args)
    _same_state(ps, js)
    assert swarm.read_metrics(pm) == {k: int(v) for k, v in jm.items()}
    hs, hm = swarm.swarm_step_host(host, *args)
    _same_state(ps, hs)
    assert swarm.read_metrics(pm) == hm


def test_step_bit_identical_to_host_oracle():
    """Device stepper == numpy oracle on every state array, metric and
    probe, through 16 ticks spanning every phase kind, each drawing its
    own bits from one seed."""
    kw = dict(n_nodes=48, n_keys=8, n_groups=2, seed=5, sweep_sample=8)
    dev = swarm.SwarmSim(full_plan(), device="cpu", **kw)
    host = swarm.SwarmSim(full_plan(), device="cpu", oracle=True, **kw)
    for t in range(16):
        md, mh = dev.tick(), host.tick()
        assert md == mh, (t, md, mh)
        _same_state(dev.state, host.state, f"tick {t}")
        assert dev.probe() == host.probe(), t


def test_carried_oracle_sim_ticks_as_the_jax_oracle():
    kw = dict(n_nodes=96, n_keys=8, n_groups=2, seed=8, sweep_sample=8,
              repub_every=2)
    jsim = JS.SwarmSim(full_plan(JC), device=False, **kw)
    jsim.run(4)
    psim = convert.swarm_from_jax(jsim, device="cpu")
    assert psim.oracle and psim.tick_no == 4 and psim.t == jsim.t
    assert psim._phase_names == jsim._phase_names
    for t in range(8):
        bits = _jax_bits(jsim)
        assert psim.advance(*bits) == jsim.tick(), t
        _same_state(psim.state, jsim.state, f"tick {t}")
        assert psim.probe() == jsim.probe(), t


def test_deterministic_under_seed():
    kw = dict(n_nodes=64, n_keys=8, n_groups=2, sweep_sample=8,
              device="cpu")
    a = swarm.SwarmSim(full_plan(), seed=11, **kw)
    b = swarm.SwarmSim(full_plan(), seed=11, **kw)
    c = swarm.SwarmSim(full_plan(), seed=12, **kw)
    ma, mb, mc = a.run(10), b.run(10), c.run(10)
    assert ma == mb
    assert ma != mc
    sa, sb = swarm.state_to_numpy(a.state), swarm.state_to_numpy(b.state)
    for k in swarm.STATE_KEYS:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


# ----------------------------------------------------------- the pieces
def test_occupancy_limbs_roundtrip_and_match_jax():
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 16, size=(17, swarm.ID_BITS)).astype(np.int32)
    packed = swarm._pack_occ(np, counts)
    assert packed.shape == (17, swarm.OCC_LIMBS)
    np.testing.assert_array_equal(packed, JS._pack_occ(np, counts))
    np.testing.assert_array_equal(swarm._unpack_occ(np, packed), counts)
    tpacked = swarm._pack_occ(torch, torch.from_numpy(counts))
    assert tpacked.dtype == torch.int32
    np.testing.assert_array_equal(tpacked.numpy().view(np.uint32), packed)
    np.testing.assert_array_equal(
        swarm._unpack_occ(torch, tpacked).numpy(), counts)
    # nibbles of 8..15 in the top limb set the int32 sign bit
    assert (tpacked < 0).any()


def test_uint32_arithmetic_in_int64_equals_numpy():
    """_unif and _avail on the widened torch values give numpy's uint32
    results at the edges (torch has no uint32 >> or <)."""
    r = np.array([0, 1, 255, 256, 2 ** 24 - 1, 2 ** 31 - 1, 2 ** 31,
                  2 ** 32 - 256, 2 ** 32 - 1], np.uint32)
    got = swarm._unif(torch, swarm._bits(r, "cpu")).numpy()
    want = JS._unif(np, r)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    rc = np.array([0, 1, 2, 15, 16, 17, 1023, 50_000, 2 ** 31 - 1], np.int32)
    np.testing.assert_array_equal(
        swarm._avail(torch, torch.from_numpy(rc)).numpy(),
        JS._avail(np, rc))


def _tie_heavy_ids(rng, S, K):
    ids = rng.integers(0, 2 ** 32, size=(S, 5), dtype=np.uint32)
    ids[1::7] = ids[0]                      # duplicate ids: index ties
    ids[2::11, :2] = ids[3, :2]             # shared top 64 bits
    keys = rng.integers(0, 2 ** 32, size=(K, 5), dtype=np.uint32)
    keys[0] = ids[0]                        # a zero distance
    keys[1] = ids[5] ^ np.uint32(0xFFFFFFFF)  # an all-ones distance
    return ids, keys


@pytest.mark.parametrize("per_key", [False, True])
def test_closest_r_equals_the_jax_lexsort(per_key):
    rng = np.random.default_rng(7 + per_key)
    S, K, R = 300, 9, 8
    ids, keys = _tie_heavy_ids(rng, S, K)
    valid = (rng.random((K, S)) > 0.3) if per_key else rng.random(S) > 0.2
    if per_key:
        valid[2] = False                    # a key with no valid row
        valid[3, :5] = True
        valid[3, 5:] = False                # fewer valid rows than R
    want = JS._closest_r(np, keys, ids, valid, R)
    got = swarm._closest_r(torch, TK.to_keys(keys, "cpu"),
                           TK.to_keys(ids, "cpu"), torch.from_numpy(valid),
                           R)
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    host = swarm._closest_r(np, keys, ids, valid, R)
    np.testing.assert_array_equal(host[0], want[0])


def test_closest_r_matches_shipping_xor_topk_distances():
    from opendht_tpu_torch.ops.xor_topk import xor_topk
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 2 ** 32, size=(256, 5), dtype=np.uint32)
    queries = rng.integers(0, 2 ** 32, size=(7, 5), dtype=np.uint32)
    valid = np.ones((256,), bool)
    valid[::5] = False
    sel, sel_valid = swarm._closest_r(
        torch, TK.to_keys(queries, "cpu"), TK.to_keys(ids, "cpu"),
        torch.from_numpy(valid), 8)
    assert bool(sel_valid.all())
    _d, idx = xor_topk(TK.to_keys(queries, "cpu"), TK.to_keys(ids, "cpu"),
                       k=8, valid=torch.from_numpy(valid))
    ours = queries[:, None, :] ^ ids[sel.numpy()]
    theirs = queries[:, None, :] ^ ids[idx.numpy()]
    np.testing.assert_array_equal(np.sort(ours, axis=1),
                                  np.sort(theirs, axis=1))


def test_batched_sweep_equals_single_sweeps_and_the_jax_vmap():
    """maintenance_sweep_batched row m == maintenance_sweep(self_ids[m])
    (counts and staleness), and == the JAX step's vmapped sweep; reply
    times straddle the threshold, some rows never replied."""
    rng = np.random.default_rng(31)
    N, M = 700, 6
    ids = rng.integers(0, 2 ** 32, size=(N, 5), dtype=np.uint32)
    ids[::9, :2] = ids[0, :2]               # deep shared prefixes
    self_rows = np.array([0, 3, 9, 100, 699, 18])
    valid = rng.random((M, N)) > 0.2
    valid[np.arange(M), self_rows] = False
    now, age = np.float32(700.0), np.float32(600.0)
    thr = now - age
    last = rng.choice(np.array([0.0, thr - 1, thr, thr + 0.5, 650.0],
                               np.float32), size=N).astype(np.float32)
    keys = TK.to_keys(ids, "cpu")
    counts, stale = TR.maintenance_sweep_batched(
        keys[self_rows], keys, torch.from_numpy(valid),
        torch.from_numpy(last), now, age)
    assert counts.dtype == torch.int32 and counts.shape == (M, 160)
    assert bool(stale.any()) and not bool(stale.all())
    for m, i in enumerate(self_rows):
        c, _l, s, _t = TR.maintenance_sweep(ids[i], ids, valid[m], last,
                                            now, age, device="cpu")
        assert torch.equal(counts[m], c), m
        assert torch.equal(stale[m], s), m
    sweep = jax.vmap(JR.maintenance_sweep,
                     in_axes=(0, None, 0, None, None, None, None))
    jc, _jl, js, _jt = sweep(jnp.asarray(ids[self_rows]), jnp.asarray(ids),
                             jnp.asarray(valid), jnp.asarray(last), now,
                             age, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(stale.numpy(), np.asarray(js))


def test_sweep_rows_must_be_distinct():
    host = swarm.init_swarm(3, 32, 4)
    state = swarm.state_to_device(host, "cpu")
    bits = np.zeros((32, 3), np.uint32), np.zeros((4,), np.uint32)
    with pytest.raises(AssertionError):
        swarm.swarm_step(state, 1.0, 0.0, 0.0, 0.0, 1.0, 5.0,
                         np.ones((2, 2), bool), False, np.zeros(32, bool),
                         0, False, np.array([1, 2, 1]), *bits)


def test_params_at_equals_jax():
    jplan, plan = full_plan(JC), full_plan()
    group = np.array([0, 0, 1, 1, 1], np.int32)
    for rel in np.arange(0.0, 17.0, 0.5):
        want = JS.params_at(jplan, float(rel), 2, group)
        got = swarm.params_at(plan, float(rel), 2, group)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
    p_split = swarm.params_at(plan, 6.0, 2, group)
    assert not p_split["reach"][0, 1] and p_split["reach"][1, 0]


def test_probes_equal_jax_on_a_stormed_state():
    kw = dict(n_nodes=300, n_keys=24, n_groups=2, seed=6, sweep_sample=16,
              repub_every=3)
    jsim = JS.SwarmSim(full_plan(JC), device=True, **kw)
    jsim.run(7, probe_every=0)
    state = {k: np.asarray(v) for k, v in jsim.state.items()}
    tstate = swarm.state_to_device(state, "cpu")
    reach = np.array([[True, False], [True, True]])
    P = 24
    src = np.nonzero(state["alive"])[0][:P].astype(np.int32)
    rep = state["replicas"][:P]
    want = np.asarray(JS.lookup_success_probe(
        jsim.state, jnp.asarray(reach), jnp.asarray(state["keys"][:P]),
        jnp.asarray(src), jnp.asarray(rep)))
    got = swarm.lookup_success_probe(tstate, reach, tstate["keys"][:P],
                                     src, tstate["replicas"][:P])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        swarm.lookup_success_probe_host(state, reach, state["keys"][:P], src,
                                        rep), want)
    cov = swarm.replica_coverage(tstate)
    np.testing.assert_array_equal(cov, JS.replica_coverage(state))
    np.testing.assert_array_equal(swarm.replica_coverage(state), cov)
    assert cov.dtype == np.float64 and cov.min() < 1.0


def test_init_swarm_is_converged_and_seeded():
    a = swarm.init_swarm(4, 200, 12)
    b = swarm.init_swarm(4, 200, 12)
    for k in swarm.STATE_KEYS:
        np.testing.assert_array_equal(a[k], b[k])
    sel, ok = swarm._closest_r(np, a["keys"], a["ids"], a["alive"], 8)
    np.testing.assert_array_equal(a["replicas"], np.where(ok, sel, -1))
    assert a["ids"].dtype == np.uint32 and a["occ"].dtype == np.uint32
    np.testing.assert_array_equal(
        swarm._unpack_occ(np, a["occ"]),
        JS._unpack_occ(np, JS._pack_occ(np, JS._avail(
            np, np.full(200, 199, np.int32)))))
    assert not np.array_equal(swarm.init_swarm(5, 200, 12)["ids"], a["ids"])


# ------------------------------------------------------- fault dynamics
def test_poison_admission_bounded_and_decays():
    plan = chaos.FaultPlan([
        chaos.Phase("poison", start=0.0, duration=4.0,
                    poison=chaos.Poison(victim="g1", per_bucket=8)),
    ])
    sim = swarm.SwarmSim(plan, n_nodes=64, n_keys=8, n_groups=2, seed=9,
                         sweep_sample=8, device="cpu")
    sim.tick()
    st = swarm.state_to_numpy(sim.state)
    occ = swarm._unpack_occ(np, st["occ"])
    poi = swarm._unpack_occ(np, st["poison"])
    group = st["group"]
    assert poi[group == 1].sum() > 0, "poison never admitted"
    assert int((occ + poi).max()) <= swarm.K_BUCKET
    assert poi[group == 0].sum() == 0
    full = occ == swarm.K_BUCKET
    assert not (poi[full] > 0).any()
    sim.run(8)
    poi = swarm._unpack_occ(np, swarm.state_to_numpy(sim.state)["poison"])
    assert poi.sum() == 0, "attacker occupancy survived the heal"


def test_storm_partition_heal_invariants_restore():
    plan = chaos.FaultPlan([
        chaos.Phase("storm", start=1.0, duration=3.0,
                    storm=chaos.Storm(leave_rate=0.10, join_rate=0.10)),
        chaos.Phase("refill", start=4.0, duration=3.0,
                    storm=chaos.Storm(join_rate=0.5)),
        chaos.Phase("split", start=8.0, duration=6.0,
                    partition=chaos.Partition(block=[("g0", "g1")],
                                              symmetric=True)),
    ], seed=3)
    sim = swarm.SwarmSim(plan, n_nodes=1024, n_keys=48, n_groups=2,
                         seed=5, sweep_sample=32, repub_every=2,
                         device="cpu")
    hist = sim.run(22)
    assert hist[0]["verdict"] == HEALTHY
    during = hist[9:13]
    assert any(m["verdict"] in (DEGRADED, UNHEALTHY) for m in during)
    assert min(m["replica_coverage"] for m in during) < 0.75
    healed = hist[-1]
    assert healed["verdict"] == HEALTHY, healed
    assert healed["lookup_success"] >= 0.95
    assert healed["replica_coverage"] >= 0.95
    assert sum(m["n_leave"] for m in hist) > 0
    assert sum(m["n_join"] for m in hist) > 0


def test_swarm_verdict_and_phase_flight_events():
    tr = tracing.get_tracer()
    plan = chaos.FaultPlan([
        chaos.Phase("split", start=2.0, duration=4.0,
                    partition=chaos.Partition(block=[("g0", "g1")],
                                              symmetric=True)),
    ])
    sim = swarm.SwarmSim(plan, n_nodes=256, n_keys=16, n_groups=2, seed=4,
                         sweep_sample=16, repub_every=2, device="cpu")
    sim.run(10)
    phases = tr.events(name="chaos_phase")
    verdicts = tr.events(name="swarm_verdict")
    assert any("split" in e["attrs"].get("active", "") for e in phases)
    assert any(e["attrs"].get("to") in (DEGRADED, UNHEALTHY)
               for e in verdicts), verdicts
    snap = telemetry.get_registry().snapshot()["gauges"]
    assert "dht_swarm_lookup_success" in snap
    assert "dht_swarm_replica_coverage" in snap


def test_occupancy_gauge_rides_registry_and_history_frames():
    from opendht_tpu_torch.history import HistoryConfig, MetricsHistory
    reg = telemetry.get_registry()
    reg.gauge("dht_swarm_occupancy").set(-12345.0)
    reg.gauge("dht_swarm_replica_coverage").set(-12345.0)
    clock = [0.0]
    rec = MetricsHistory(HistoryConfig(period=1.0, capacity=8),
                         registry=reg, clock=lambda: clock[0])
    rec.tick()
    sim = swarm.SwarmSim(chaos.FaultPlan([]), n_nodes=128, n_keys=8,
                         seed=6, sweep_sample=16, device="cpu")
    m = sim.tick()
    assert m["occ_sum"] > 0
    assert reg.snapshot()["gauges"].get("dht_swarm_occupancy") == m["occ_sum"]
    clock[0] = 1.0
    f = rec.tick()
    assert f["gauges"]["dht_swarm_occupancy"] == m["occ_sum"]
    sim.run(2)
    clock[0] = 2.0
    assert "dht_swarm_replica_coverage" in rec.tick()["gauges"]
