"""The port's load-aware resharding (``opendht_tpu_torch/reshard.py``, the
boundary solvers of ``parallel/partition.py`` and the snapshot's layout
resolve) against the JAX package's.

Each test twins one of tests/test_reshard.py, bit for bit: the solvers
against the JAX solvers and their scalar per-row oracle (a seeded
property sweep, as the JAX test runs it); the weighted shard state
driving the table-parallel engine; a snapshot answering identically
unsharded, uniform-sharded and at a reshard layout, with a wave launched
before a swap pinned to the operands it captured; the ``Resharder``
state machine's swap / cooldown / burst / recover-band / frame-evidence
/ disabled / error sequences, tick for tick against the JAX class; the
keyspace observatory's shard-edge arities; the node's shard info and
wiring.  Last, twin default nodes (``Config()``: the resharder on) and
twin ``resolve_mesh_t=4`` nodes serve a Zipf stream long enough to arm
the resharder and swap: the same datagrams at the same virtual times,
the same ``reshard`` snapshots after every tick, the same op results.
"""

from __future__ import annotations

import socket

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opendht_tpu import reshard as JR
from opendht_tpu.core.search import simulate_lookups as j_simulate
from opendht_tpu.core.table import Snapshot as JSnapshot
from opendht_tpu.ops.sorted_table import sort_table as j_sort
from opendht_tpu.parallel import partition as JPart
from opendht_tpu.parallel.sharded import make_mesh as j_make_mesh
from opendht_tpu_torch import reshard as TR
from opendht_tpu_torch.core.table import Snapshot
from opendht_tpu_torch.keyspace import (KeyspaceConfig, KeyspaceObservatory,
                                        bin_edges_from_ids,
                                        bin_edges_uniform, fold_bins,
                                        _imbalance)
from opendht_tpu_torch.ops import ids as TK
from opendht_tpu_torch.ops.sorted_table import sort_table
from opendht_tpu_torch.parallel import partition as Part
from opendht_tpu_torch.parallel import make_mesh, tp_simulate_lookups

from test_torch_hotcache import (JAX, PORT, TwinNode, client_requests,
                                 zipf_stream)

AF = socket.AF_INET


# ------------------------------------------------------------------ solver

def _oracle_rows(bin_rows, bin_loads, t, load_weight):
    """Scalar oracle: every bin expanded into per-row weights (uniform
    within the bin), cumsum, and the smallest row count whose weight
    reaches i/t of the total."""
    bin_rows = np.asarray(bin_rows, np.int64)
    w = Part._blend_bin_weights(bin_rows, bin_loads, load_weight)
    row_w = []
    for b, r in enumerate(bin_rows):
        if r > 0:
            row_w.extend([w[b] / float(r)] * int(r))
    cum = np.cumsum(np.asarray(row_w, np.float64))
    W = float(cum[-1]) if cum.size else 0.0
    n = int(bin_rows.sum())
    out = []
    for i in range(1, int(t)):
        if W <= 0.0:
            out.append(0)
            continue
        T = W * i / float(t)
        r = 0
        while r < n and cum[r] < T - 1e-9:
            r += 1
        out.append(r + 1 if r < n else n)
    return np.maximum.accumulate(np.asarray(out, np.int64))


def _both_solvers(bin_rows, loads, t, **kw):
    got = Part.solve_shard_boundaries(bin_rows, loads, t, **kw)
    want = JPart.solve_shard_boundaries(bin_rows, loads, t, **kw)
    np.testing.assert_array_equal(got, want)
    return got


def test_solver_matches_scalar_oracle_property():
    rng = np.random.default_rng(29)
    for trial in range(60):
        bins = int(rng.integers(4, 24))
        bin_rows = rng.integers(0, 9, size=bins).astype(np.int64)
        loads = rng.integers(0, 101, size=bins).astype(np.int64)
        loads[bin_rows == 0] = 0
        t = int(rng.choice([2, 3, 4, 8]))
        lam = float(rng.choice([0.0, 0.3, 0.9, 1.0]))
        got = _both_solvers(bin_rows, loads, t, load_weight=lam)
        want = _oracle_rows(bin_rows, loads, t, lam)
        n = int(bin_rows.sum())
        assert got.shape == (t - 1,), trial
        assert np.all(np.diff(got) >= 0), (trial, got)
        assert got.min() >= 0 and got.max() <= n, (trial, got, n)
        assert np.all(np.abs(got - want) <= 1), (trial, got, want)
        np.testing.assert_array_equal(
            Part._blend_bin_weights(bin_rows, loads, lam),
            JPart._blend_bin_weights(bin_rows, loads, lam))


def test_solver_cold_table_is_exact_uniform():
    bin_rows = np.full(256, 64, np.int64)
    n = int(bin_rows.sum())
    for t in (2, 3, 4, 8):
        want = np.asarray([-(-n * i // t) for i in range(1, t)], np.int64)
        cold = _both_solvers(bin_rows, np.zeros(256, np.int64), t)
        assert np.array_equal(cold, want), t
        lam0 = _both_solvers(bin_rows, np.arange(256, dtype=np.int64), t,
                             load_weight=0.0)
        assert np.array_equal(lam0, want), t
    ragged = np.zeros(8, np.int64)
    ragged[:3] = [3, 3, 1]
    assert np.array_equal(_both_solvers(ragged, np.zeros(8, np.int64), 4),
                          [2, 4, 6])


def test_solver_single_hot_bin_quarters_it():
    bin_rows = np.full(256, 64, np.int64)
    loads = np.zeros(256, np.int64)
    loads[10] = 5000
    got = _both_solvers(bin_rows, loads, 4, load_weight=1.0)
    lo = 10 * 64
    assert np.array_equal(got, [lo + 16, lo + 32, lo + 48])


def test_solver_degenerate_histograms():
    bin_rows = np.zeros(16, np.int64)
    bin_rows[[0, 15]] = [8, 8]
    loads = np.zeros(16, np.int64)
    loads[7] = 1000
    got = _both_solvers(bin_rows, loads, 4, load_weight=0.9)
    assert np.all(np.diff(got) >= 0) and got.min() >= 0 and got.max() <= 16
    bin_rows = np.zeros(256, np.int64)
    bin_rows[[3, 200]] = [2, 2]
    got = _both_solvers(bin_rows, np.zeros(256, np.int64), 8,
                        load_weight=1.0)
    assert got.shape == (7,) and np.all(np.diff(got) >= 0)
    assert got.max() <= 4
    bin_rows = np.full(64, 16, np.int64)
    loads = np.zeros(64, np.int64)
    loads[:8] = 100
    assert _both_solvers(bin_rows, loads, 4, load_weight=1.0).max() <= 128
    assert np.array_equal(_both_solvers(np.zeros(16, np.int64),
                                        np.zeros(16, np.int64), 4),
                          [0, 0, 0])


def test_solve_shard_edges_cold_and_hot():
    def both(loads, t, **kw):
        got = Part.solve_shard_edges(loads, t, **kw)
        np.testing.assert_array_equal(
            got, JPart.solve_shard_edges(loads, t, **kw))
        return got
    for t in (2, 4, 8):
        assert np.allclose(both(np.zeros(256, np.int64), t),
                           bin_edges_uniform(t)), t
    loads = np.zeros(256, np.int64)
    loads[10] = 4000
    assert np.allclose(both(loads, 4, load_weight=1.0),
                       [10.25, 10.5, 10.75])
    loads = np.zeros(256, np.int64)
    loads[:64] = 100
    edges = both(loads, 4, load_weight=0.9)
    post = _imbalance(fold_bins(loads, list(edges)))
    assert post is not None and post < 1.3
    assert _imbalance(fold_bins(loads, bin_edges_uniform(4))) > 2.0
    rows = np.arange(256, dtype=np.int64) % 7
    both(loads, 4, load_weight=0.5, bin_rows=rows)


# ------------------------------------------------ weighted state identity

def _hot_boundaries(js, n, t):
    top = js[:, 0].astype(np.int64)
    edges_v = np.arange(1, 256, dtype=np.int64) << 24
    counts = np.searchsorted(top[:n], edges_v, side="left")
    bin_rows = np.diff(np.concatenate([[0], counts, [n]]))
    loads = np.zeros(256, np.int64)
    loads[:32] = 1000
    return _both_solvers(bin_rows, loads, t, load_weight=0.9)


@pytest.mark.parametrize("t", [2, 4])
def test_weighted_shard_state_bit_identical(t):
    """A traffic-weighted shard state (unequal ownership, equal-capacity
    slabs) drives the table-parallel engine to the JAX engine's results,
    every limb and hop; the slabs, per-shard LUTs and block LUT are the
    JAX state's."""
    from opendht_tpu.parallel.sharded import tp_simulate_lookups as j_tp
    rng = np.random.default_rng(17)
    ids = rng.integers(0, 2 ** 32, size=(2048, 5), dtype=np.uint32)
    js, _, jn = j_sort(jnp.asarray(ids))
    js, n = np.asarray(js), int(jn)
    targets = rng.integers(0, 2 ** 32, size=(16, 5), dtype=np.uint32)
    bnd = _hot_boundaries(js, n, t)
    uniform = np.asarray([-(-n * i // t) for i in range(1, t)], np.int64)
    assert not np.array_equal(bnd, uniform)

    jmesh = j_make_mesh(t, q=1, t=t)
    jstate = JPart.shard_table_state(jmesh, js, n, boundaries=bnd)
    want = j_tp(jmesh, targets=targets, seed=9, state=jstate)
    mesh = make_mesh(t, q=1, t=t, devices="cpu")
    state = Part.shard_table_state(mesh, js, n, boundaries=bnd)
    assert state.boundaries == jstate.boundaries
    assert state.shard_n == jstate.shard_n
    for name in ("sorted_ids", "local_lut", "block_lut", "shard_rows"):
        got = state.arrays[name].gather()
        got = TK.from_keys(got) if name == "sorted_ids" else got.numpy()
        np.testing.assert_array_equal(got, np.asarray(jstate.arrays[name]),
                                      err_msg=name)
    out = tp_simulate_lookups(mesh, targets=targets, seed=9, state=state)
    for key in ("nodes", "hops", "converged", "dist"):
        got = TK.from_keys(out[key]) if key == "dist" else out[key].numpy()
        np.testing.assert_array_equal(got, np.asarray(want[key]),
                                      err_msg=key)
    ref = j_simulate(jnp.asarray(js), n, jnp.asarray(targets), seed=9)
    np.testing.assert_array_equal(out["nodes"].numpy(),
                                  np.asarray(ref["nodes"]))


def _snapshots(rng, n=1500):
    ids = rng.integers(0, 2 ** 32, size=(n, 5), dtype=np.uint32)
    js, jp, jn = j_sort(jnp.asarray(ids))
    ts, tp, tn = sort_table(TK.to_keys(ids, "cpu"))
    return (JSnapshot(js, np.asarray(jp), jn, 1, ("k", 0)),
            Snapshot(ts, tp, int(tn), 1, ("k", 0)))


def _layouts(mod, gen, t, edges=(8.0,), hot=slice(0, 32), load=1000):
    loads = np.zeros(256, np.int64)
    loads[hot] = load
    return mod.ReshardLayout(gen=gen, t=t, edges=tuple(edges),
                             bin_loads=loads, load_weight=0.9)


def test_snapshot_layout_serving_identity_and_inflight_pinning():
    """A snapshot answers identically unsharded, uniform-sharded and at a
    reshard layout — the JAX snapshot's answer — and a wave launched
    before a swap consumes to the same answer, pinned to the operands and
    perm map it captured."""
    rng = np.random.default_rng(23)
    jsnap, snap = _snapshots(rng)
    q = rng.integers(0, 2 ** 32, size=(8, 5), dtype=np.uint32)
    ref_rows, ref_dist = snap.lookup(q)
    j_rows, j_dist = jsnap.lookup(q)
    np.testing.assert_array_equal(ref_rows, j_rows)
    np.testing.assert_array_equal(ref_dist, j_dist)
    jmesh = j_make_mesh(2, q=1, t=2)
    mesh = make_mesh(2, q=1, t=2, devices="cpu")
    lay, jlay = _layouts(TR, 1, 2), _layouts(JR, 1, 2)

    rows = np.asarray(snap.reshard_boundary_rows(lay, 2))
    np.testing.assert_array_equal(
        rows, np.asarray(jsnap.reshard_boundary_rows(jlay, 2)))
    assert rows.shape == (1,) and int(rows[0]) != -(-snap.n_valid // 2)

    u_rows, u_dist = snap.lookup(q, mesh=mesh)
    np.testing.assert_array_equal(u_rows, ref_rows)
    np.testing.assert_array_equal(u_dist, ref_dist)

    pl_old = snap.lookup_launch(q, mesh=mesh)
    placed_old = snap._tp_state[2]
    pl_new = snap.lookup_launch(q, mesh=mesh, layout=lay)
    assert snap._tp_state[2] is not placed_old       # the swap rebuilt
    for pl in (pl_old, pl_new):
        got_rows, got_dist = pl.consume()
        np.testing.assert_array_equal(got_rows, ref_rows)
        np.testing.assert_array_equal(got_dist, ref_dist)
    # the weighted slabs are the JAX snapshot's
    jsnap._shard_state(jmesh, jlay)
    jplaced, jperm = jsnap._tp_state[2], jsnap._tp_state[3]
    placed, perm = snap._tp_state[2], snap._tp_state[3]
    np.testing.assert_array_equal(TK.from_keys(placed["sorted_ids"].gather()),
                                  np.asarray(jplaced["sorted_ids"]))
    np.testing.assert_array_equal(placed["n_valid"].gather().numpy(),
                                  np.asarray(jplaced["n_valid"]))
    np.testing.assert_array_equal(perm.numpy(), jperm)

    w_rows, w_dist = snap.lookup(q, mesh=mesh, layout=lay)
    np.testing.assert_array_equal(w_rows, ref_rows)
    np.testing.assert_array_equal(w_dist, ref_dist)
    lay2 = _layouts(TR, 2, 2, (216.0,), slice(200, 232), 500)
    w2_rows, w2_dist = snap.lookup(q, mesh=mesh, layout=lay2)
    np.testing.assert_array_equal(w2_rows, ref_rows)
    np.testing.assert_array_equal(w2_dist, ref_dist)
    jw_rows, jw_dist = jsnap.lookup(q, mesh=jmesh,
                                    layout=_layouts(JR, 2, 2, (216.0,),
                                                    slice(200, 232), 500))
    np.testing.assert_array_equal(w2_rows, jw_rows)
    np.testing.assert_array_equal(w2_dist, jw_dist)


# ------------------------------------------------------- resharder machine

class _KS:
    """Scripted observatory stand-in."""

    def __init__(self, virtual_shards=4):
        self.imb = None
        self.loads = np.zeros(256, np.int64)
        self.loads[:64] = 100

        class _Cfg:
            pass

        self.cfg = _Cfg()
        self.cfg.virtual_shards = virtual_shards

    def imbalance(self):
        return self.imb

    def hist_window(self):
        return self.loads.copy()


class _Frames:
    enabled = True

    def __init__(self, frames):
        self._frames = frames

    def frames(self, a, b):
        return self._frames


class _Twin:
    """One scripted observatory, clock and history driving a JAX and a
    port ``Resharder`` in step; every tick's result and every snapshot
    must agree."""

    def __init__(self, on_swap=None, **cfg_kw):
        cfg = dict(period=0.0, rebalance_threshold=2.0, sustain=4.0,
                   min_interval=10.0, recover_ratio=0.8)
        cfg.update(cfg_kw)
        self.ks = _KS()
        self.clk = [0.0]
        self.rs = [mod.Resharder(mod.ReshardConfig(**cfg), keyspace=self.ks,
                                 shard_t=lambda: 0, on_swap=on_swap,
                                 clock=lambda: self.clk[0])
                   for mod in (JR, TR)]

    def tick(self, now=None, imb="keep"):
        if now is not None:
            self.clk[0] = now
        if imb != "keep":
            self.ks.imb = imb
        want, got = (r.tick() for r in self.rs)
        assert got == want
        assert self.rs[1].snapshot() == self.rs[0].snapshot()
        return got

    def set_history(self, frames):
        for r in self.rs:
            r.set_history(_Frames(frames))

    @property
    def port(self):
        return self.rs[1]


def test_resharder_full_sequence_swap_and_cooldown():
    tw = _Twin()
    assert tw.tick()["reason"] == "below-threshold"
    assert tw.tick(1.0, 3.0)["reason"] == "hysteresis"
    assert tw.tick(3.0)["reason"] == "hysteresis"
    res = tw.tick(5.5)
    assert res["action"] == "swap" and res["gen"] == 1
    assert res["mode"] == "virtual" and res["t"] == 4
    assert res["imbalance_after"] < 1.3
    lay, jlay = tw.port.layout, tw.rs[0].layout
    assert lay.edges == jlay.edges and lay.gen == jlay.gen == 1
    np.testing.assert_array_equal(lay.bin_loads, jlay.bin_loads)
    assert tw.tick(6.0)["reason"] == "hysteresis"
    assert tw.tick(10.5)["reason"] == "cooldown"
    assert tw.tick(16.0)["gen"] == 2
    snap = tw.port.snapshot()
    assert snap["swaps"] == 2 and snap["ticks"] == 7
    assert snap["skips"] == {"below-threshold": 1, "hysteresis": 3,
                             "cooldown": 1}


def test_resharder_transient_burst_causes_zero_swaps():
    tw = _Twin()
    for now in (0.0, 1.0, 2.0):
        assert tw.tick(now, 5.0)["reason"] == "hysteresis"
    for now in (3.0, 4.0):
        assert tw.tick(now, 1.0)["reason"] == "below-threshold"
    assert tw.port.snapshot()["swaps"] == 0 and tw.port.layout is None
    assert tw.tick(5.0, 5.0)["reason"] == "hysteresis"
    assert tw.tick(8.9)["reason"] == "hysteresis"
    assert tw.tick(9.5)["action"] == "swap"


def test_resharder_recover_band_holds_latch():
    tw = _Twin()
    tw.tick(0.0, 3.0)
    assert tw.tick(2.0, 1.9)["reason"] == "below-threshold"
    assert tw.tick(4.5, 3.0)["action"] == "swap"


def test_resharder_windowed_frame_counter_evidence():
    tw = _Twin()
    tw.set_history([{"gauges": {"dht_shard_imbalance": 1.2}}])
    tw.tick(0.0, 3.0)
    res = tw.tick(4.5)
    assert res["reason"] == "hysteresis" and res["window_min"] == 1.2
    tw.set_history([{"gauges": {"dht_shard_imbalance": -1.0}}])
    assert tw.tick(5.0)["reason"] == "hysteresis"
    tw.set_history([{"gauges": {"dht_shard_imbalance{node=x}": 2.7}}])
    assert tw.tick(5.5)["action"] == "swap"
    tw2 = _Twin()
    tw2.set_history([])
    tw2.tick(0.0, 3.0)
    assert tw2.tick(4.5)["action"] == "swap"


def test_resharder_disabled_and_swap_error_keep_layout():
    tw = _Twin(enabled=False)
    assert tw.tick()["reason"] == "disabled"
    assert tw.port.snapshot()["skips"]["disabled"] == 1
    calls = {"n": 0}

    def on_swap(layout):
        # the JAX and the port resharder call in turn: the first call of
        # each fails
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("rebuild failed")
        return {"mode": "physical"}

    tw = _Twin(on_swap=on_swap, sustain=0.0, min_interval=0.0)
    res = tw.tick(10.0, 3.0)
    assert res == {"action": "skip", "reason": "error"}
    assert tw.port.layout is None and tw.port.snapshot()["gen"] == 0
    res = tw.tick(11.0)
    assert res["action"] == "swap" and res["mode"] == "physical"
    assert tw.port.layout.gen == 1


def test_resharder_attach_arms_the_tick_on_the_scheduler():
    """attach() arms the periodic job on the node scheduler (period 5 s
    by default); each tick re-arms itself; a disabled or period-0
    resharder arms nothing."""
    from opendht_tpu_torch.scheduler import Scheduler
    clk = [0.0]
    sched = Scheduler(clock=lambda: clk[0])
    rs = TR.Resharder(TR.ReshardConfig(), keyspace=_KS(),
                      clock=lambda: clk[0])
    rs.attach(sched)
    assert rs._job is not None and rs._job.time == 5.0
    for now in (5.0, 10.0):
        clk[0] = now
        sched.run()
    assert rs.snapshot()["ticks"] == 2 and rs._job.time == 15.0
    for cfg in (TR.ReshardConfig(enabled=False), TR.ReshardConfig(period=0)):
        off = TR.Resharder(cfg, keyspace=_KS())
        off.attach(sched)
        assert off._job is None


# --------------------------------------------------- attribution plumbing

def test_keyspace_shard_edges_arities():
    obs = KeyspaceObservatory(
        KeyspaceConfig(), shard_info=lambda: (4, [10.5, 10.25, 10.75], True),
        device="cpu")
    t, edges, virtual = obs._shard_edges()
    assert (t, virtual) == (4, True)
    assert edges == [10.25, 10.5, 10.75]
    ids = np.zeros((3, 5), np.uint32)
    ids[:, 0] = [1 << 30, 2 << 30, 3 << 30]
    obs = KeyspaceObservatory(KeyspaceConfig(), shard_info=lambda: (4, ids),
                              device="cpu")
    t, edges, virtual = obs._shard_edges()
    assert (t, virtual) == (4, False)
    assert edges == bin_edges_from_ids(ids)
    obs = KeyspaceObservatory(KeyspaceConfig(),
                              shard_info=lambda: (4, ids, True), device="cpu")
    assert obs._shard_edges() == (4, bin_edges_from_ids(ids), True)
    obs = KeyspaceObservatory(KeyspaceConfig(), shard_info=lambda: (4, None),
                              device="cpu")
    assert obs._shard_edges() == (4, bin_edges_uniform(4), True)


def _mk_dhts(t=0):
    """A JAX and a port Dht at the defaults (resolve_mesh_t=t)."""
    from opendht_tpu.runtime.config import Config as JConfig
    from opendht_tpu.runtime.dht import Dht as JDht
    from opendht_tpu.scheduler import Scheduler as JSched
    from opendht_tpu_torch.runtime import Config, Dht
    from opendht_tpu_torch.scheduler import Scheduler
    kw = {"resolve_mesh_t": t} if t else {}
    return (JDht(lambda d, a: 0, config=JConfig(**kw), scheduler=JSched(),
                 has_v6=False),
            Dht(lambda d, a: 0, config=Config(**kw), scheduler=Scheduler(),
                has_v6=False, device="cpu"))


def _install(dht, mod, gen=1, t=4, edges=(8.0,)):
    dht.reshard._layout = _layouts(mod, gen, t, edges)
    dht.reshard._gen = gen


def test_dht_shard_info_virtual_layout():
    jd, pd = _mk_dhts()
    assert pd._keyspace_shard_info() == jd._keyspace_shard_info() == (0, None)
    _install(jd, JR, edges=(10.25, 10.5, 10.75))
    _install(pd, TR, edges=(10.25, 10.5, 10.75))
    assert pd._keyspace_shard_info() == jd._keyspace_shard_info() == \
        (4, [10.25, 10.5, 10.75], True)


def test_dht_shard_info_rereads_boundaries_from_current_snapshot():
    """With a live mesh and a layout, the boundary ids come from the
    CURRENT snapshot's solved rows — on both packages; a rebuilt
    snapshot re-derives them; the observatory's fold follows."""
    jd, pd = _mk_dhts(4)
    cap = 1024
    base = np.zeros((cap, 5), np.uint32)
    base[:, 0] = (np.arange(cap, dtype=np.uint64)
                  * (2 ** 32 // cap)).astype(np.uint32)

    def put_snap(arr, version):
        jd.tables[AF]._snap = JSnapshot(jnp.asarray(arr),
                                        np.arange(cap, dtype=np.int32),
                                        cap, version, ("k", 0))
        pd.tables[AF]._snap = Snapshot(
            TK.to_keys(arr, "cpu"), torch.arange(cap, dtype=torch.int32),
            cap, version, ("k", 0))

    def infos():
        want, got = jd._keyspace_shard_info(), pd._keyspace_shard_info()
        assert len(got) == len(want) and got[0] == want[0]
        np.testing.assert_array_equal(np.asarray(got[1]),
                                      np.asarray(want[1]))
        assert got[2:] == want[2:]
        return got

    put_snap(base, 1)
    t, ids = infos()
    assert t == 4 and np.array_equal(ids, base[[256, 512, 768]])
    obs = KeyspaceObservatory(
        KeyspaceConfig(tick=0, sample_stride=1, min_observed=1),
        shard_info=pd._keyspace_shard_info, device="cpu")
    hot = np.zeros((256, 5), np.uint32)
    hot[:, 0] = np.asarray(np.random.default_rng(31).integers(
        0, 2 ** 30, 256), np.uint32)
    obs.observe_ids(hot)
    obs.tick()
    pre = obs.snapshot()["shards"]
    assert pre["virtual"] is False and pre["imbalance"] > 2.0

    _install(jd, JR)
    _install(pd, TR)
    t, ids, virtual = infos()
    assert (t, virtual) == (4, False)
    assert not np.array_equal(ids, base[[256, 512, 768]])
    obs.observe_ids(hot)
    obs.tick()
    assert obs.snapshot()["shards"]["imbalance"] < pre["imbalance"]

    base_b = np.zeros((cap, 5), np.uint32)
    base_b[:, 0] = (np.arange(cap, dtype=np.uint64) ** 2
                    % (2 ** 32)).astype(np.uint32)
    base_b = base_b[np.argsort(base_b[:, 0], kind="stable")]
    put_snap(base_b, 2)
    _, ids_b, _ = infos()
    assert not np.array_equal(ids_b, ids)


def test_dht_wires_resharder_and_surfaces():
    jd, pd = _mk_dhts()
    assert pd.reshard is not None and pd.reshard.cfg.enabled is True
    snap, jsnap = pd.reshard.snapshot(), jd.reshard.snapshot()
    assert snap == jsnap
    assert snap["gen"] == 0 and snap["layout"] is None
    assert pd.reshard._sched is pd.scheduler
    assert pd.reshard._job is not None
    assert 0.0 < pd.reshard._job.time - pd.scheduler.time() <= 5.0
    # the swap hook: virtual without a mesh (nothing launched), physical
    # with one and a snapshot, the weighted shards built eagerly
    assert pd._reshard_apply(_layouts(TR, 1, 4)) == {"mode": "virtual"}
    jd4, pd4 = _mk_dhts(4)
    ids = np.random.default_rng(5).integers(0, 2 ** 32, size=(5000, 5),
                                            dtype=np.uint32)
    from opendht_tpu.sockaddr import SockAddr as JAddr
    from opendht_tpu_torch.sockaddr import SockAddr
    jd4.tables[AF].bulk_load(ids, 0.0, addrs=JAddr("127.0.0.2", 4567))
    pd4.tables[AF].bulk_load(ids, 0.0, addrs=SockAddr("127.0.0.2", 4567))
    jd4.tables[AF].snapshot(0.0)
    snap = pd4.tables[AF].snapshot(0.0)
    want = jd4._reshard_apply(_layouts(JR, 1, 4, (8.0, 9.0, 10.0)))
    got = pd4._reshard_apply(_layouts(TR, 1, 4, (8.0, 9.0, 10.0)))
    assert got == want == {"mode": "physical", "t": 4}
    assert snap._tp_state[1] == (1, 4)


# ------------------------------------------------ twin nodes, resharder on

def run_reshard_scenario(node: TwinNode, keys, ranks, extra) -> dict:
    """A node at its defaults (optionally ``resolve_mesh_t=4`` over a
    table past the host-scan size): values on the Zipf keys, one get
    every 50 virtual ms for 30 s — long enough for the keyspace
    imbalance to stay above threshold through the sustain window and
    for the resharder to swap — with its snapshot read every 100 gets,
    then a client's get_values served on the new layout."""
    dht, M = node.dht, node.M
    if extra is not None:
        dht.tables[AF].bulk_load(extra, 0.0,
                                 addrs=M["SockAddr"]("127.0.0.2", 4567))
    for i, k in enumerate(keys):
        dht.storage_store(node.key(k), M["Value"](b"val-%d" % i,
                                                  value_id=100 + i), 0.0)
    results, snaps = [], []

    def get(i, k):
        got, done = [], []
        dht.get(node.key(k), lambda vals: got.extend(vals) or True,
                lambda ok, ns: done.append((ok, node.clock["t"])))
        results.append((i, got, done))
    t = 0.0
    for i, r in enumerate(ranks):
        get(i, keys[r])
        t += 0.05
        node.advance(t, step=0.005)
        if i % 100 == 99:
            snaps.append(dht.reshard.snapshot())
    hot = keys[int(np.bincount(ranks).argmax())]
    for raw in client_requests(lambda ceng, peer, JM: ceng.send_get_values(
            peer(dht.myid), JM["InfoHash"](hot), JM["Query"](), want=1)):
        node.feed(raw)
    node.advance(t + 5.0, step=0.01)
    snaps.append(dht.reshard.snapshot())
    return {"gets": [(i, sorted((v.id, bytes(v.data)) for v in got), done)
                     for i, got, done in results],
            "snaps": snaps, "sent": node.sent,
            "shards": dht.keyspace.snapshot()["shards"],
            "shard_t": dht.resolve_mesh_t()}


@pytest.mark.parametrize("mesh_t", [0, 4])
def test_twin_default_nodes_swap_alike(monkeypatch, mesh_t):
    keys, ranks = zipf_stream(27, 40, 600, 1.2)
    # every key in the first eighth of the keyspace: the traffic lands on
    # one shard, and the imbalance stays above threshold while it lasts
    keys = [bytes([k[0] & 0x1F]) + k[1:] for k in keys]
    extra = None
    if mesh_t:
        extra = np.random.default_rng(28).integers(0, 2 ** 32,
                                                   size=(5000, 5),
                                                   dtype=np.uint32)
    # the mesh node's waves run through the device route; at pipeline
    # depth 2 a wave's scatter waits on the JAX array's is_ready(), which
    # depends on the host's timing, so the twins run depth 1 (launch,
    # block, scatter), the JAX package's pinned-equivalent escape hatch
    cfg = ({"resolve_mesh_t": mesh_t, "ingest_pipeline_depth": 1}
           if mesh_t else {})
    sweeps = []
    want = run_reshard_scenario(
        TwinNode(JAX, monkeypatch, sweeps, "rs-twin", **cfg), keys, ranks,
        extra)
    got = run_reshard_scenario(
        TwinNode(PORT, monkeypatch, sweeps, "rs-twin", **cfg), keys, ranks,
        extra)
    assert not sweeps
    assert want["shard_t"] == got["shard_t"] == max(mesh_t, 1)
    assert want["snaps"][-1]["swaps"] >= 1, "the resharder swapped"
    assert want["snaps"][-1]["mode"] == ("physical" if mesh_t
                                         else "virtual")
    assert got["snaps"] == want["snaps"]
    assert got["shards"] == want["shards"]
    assert got["gets"] == want["gets"]
    assert len(got["sent"]) == len(want["sent"])
    assert got["sent"] == want["sent"]


def test_dht_from_jax_carries_the_resharder():
    """``convert.dht_from_jax`` carries a JAX node's resharder (layout
    generation, edges, ``bin_loads``, latch, last swap, counters, the
    tick's time) and ``resolve_mesh_t``: the carried node reports the
    same snapshot and its next ticks act as the JAX node's."""
    from opendht_tpu.runtime import Config as JConfig, Dht as JDht
    from opendht_tpu.scheduler import Scheduler as JSched
    from opendht_tpu_torch import convert
    from opendht_tpu_torch.scheduler import Scheduler
    clk = [0.0]
    jd = JDht(lambda d, a: 0, JConfig(resolve_mesh_t=4),
              JSched(clock=lambda: clk[0]), has_v6=False)
    jd.keyspace.imbalance = lambda: 3.0
    for now in (5.0, 10.0, 15.0, 20.0, 25.0):
        clk[0] = now
        jd.scheduler.run()
    assert jd.reshard.snapshot()["swaps"] == 1
    clk[0] = 27.0
    jd.scheduler.run()                    # its clock reads 27 s too
    pd = convert.dht_from_jax(jd, lambda d, a: 0,
                              Scheduler(clock=lambda: clk[0]), device="cpu")
    assert pd.config.resolve_mesh_t == 4 and pd.resolve_mesh_t() == 4
    assert pd.reshard.snapshot() == jd.reshard.snapshot()
    lay, jlay = pd.reshard.layout, jd.reshard.layout
    assert (lay.gen, lay.t, lay.edges) == (jlay.gen, jlay.t, jlay.edges)
    np.testing.assert_array_equal(lay.bin_loads, jlay.bin_loads)
    assert pd.reshard._job.time == jd.reshard._job.time == 30.0
    pd.keyspace.imbalance = lambda: 3.0
    for now in (30.0, 90.0):
        clk[0] = now
        jd.scheduler.run()
        pd.scheduler.run()
        assert pd.reshard.snapshot() == jd.reshard.snapshot()
    assert pd.reshard.snapshot()["swaps"] == 2
