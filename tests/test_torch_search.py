"""The port's iterative lookup engine against the JAX package's.

The same numpy inputs go through ``opendht_tpu.core.search`` and
``opendht_tpu_torch.core.search`` (on CPU tensors); the tolerance is
BIT-IDENTICAL: ``nodes``, ``hops`` and ``converged`` equal as arrays,
``dist`` equal after ``from_keys``.  Covered: the three golden modes and
config 3's settings (α=3, k=8, state_limbs=2), the tiny and the empty
table, clustered tables (LUT budget exceeded, top-64 ties), survivor
compaction at a full, a partial and an overflowing cap, the engine's
positioning, block-bound and gather primitives, the uint32 hash and
reply counter at wrap-around values, the scalar oracle, the committed
reply-stream goldens (port alone) and the telemetry envelope.
"""

import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opendht_tpu.core import search as JS
from opendht_tpu.ops import sorted_table as JST
from opendht_tpu.ops import xor_topk as JX
from opendht_tpu_torch import telemetry as TT
from opendht_tpu_torch.core import search as TS
from opendht_tpu_torch.ops import ids as TK
from opendht_tpu_torch.ops import sorted_table as TST
from opendht_tpu_torch.ops import xor_topk as TX

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "search_engine.json")


def _tables(ids_np, valid=None):
    """The sorted table in both packages: ((jax sorted, n), (keys, n))."""
    js, _, jn = JST.sort_table(jnp.asarray(ids_np),
                               None if valid is None else jnp.asarray(valid))
    ts, _, tn = TST.sort_table(
        TK.to_keys(ids_np, "cpu"),
        None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(js), TK.from_keys(ts))
    return (js, jn), (ts, tn)


def _run_both(ids_np, targets_np, valid=None, **kw):
    (js, jn), (ts, tn) = _tables(ids_np, valid)
    want = JS.simulate_lookups(js, jn, jnp.asarray(targets_np), **kw)
    got = TS.simulate_lookups(ts, tn, TK.to_keys(targets_np, "cpu"),
                              device="cpu", **kw)
    _assert_same(want, got)
    return got


def _assert_same(want, got):
    for key in ("nodes", "hops", "converged"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(TK.from_keys(got["dist"]),
                                  np.asarray(want["dist"]), err_msg="dist")


def _golden_inputs():
    rng = np.random.default_rng(1234)
    ids = rng.integers(0, 2**32, size=(4096, 5), dtype=np.uint32)
    targets = rng.integers(0, 2**32, size=(96, 5), dtype=np.uint32)
    return ids, targets


MODES = {"lut_l5": {}, "lut_l2": {"state_limbs": 2},
         "exact_l5": {"block_mode": "exact"},
         "config3": {"alpha": 3, "k": 8, "state_limbs": 2}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_simulate_lookups_matches_jax(mode):
    ids, targets = _golden_inputs()
    got = _run_both(ids, targets, seed=99, **MODES[mode])
    assert bool(got["converged"].all())


def test_golden_modes_are_the_committed_sha256_port_alone():
    """No JAX here: the port reproduces tests/goldens/search_engine.json."""
    with open(GOLDENS) as f:
        gold = json.load(f)
    ids, targets = _golden_inputs()
    s, _, n = TST.sort_table(TK.to_keys(ids, "cpu"))
    for tag in ("lut_l5", "lut_l2", "exact_l5"):
        out = TS.simulate_lookups(s, n, TK.to_keys(targets, "cpu"), seed=99,
                                  device="cpu", **MODES[tag])
        h = hashlib.sha256()
        for key in ("nodes", "hops", "converged", "dist"):
            a = TK.from_keys(out[key]) if key == "dist" else out[key].numpy()
            h.update(np.ascontiguousarray(a).tobytes())
        assert h.hexdigest() == gold[tag]["sha256"], tag
        assert out["nodes"][0].tolist() == gold[tag]["nodes_row0"], tag
        assert int(out["converged"].sum()) == gold[tag]["converged"], tag


def test_tiny_network_matches_jax():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 2**32, size=(5, 5), dtype=np.uint32)
    targets = rng.integers(0, 2**32, size=(8, 5), dtype=np.uint32)
    got = _run_both(ids, targets, seed=1)
    for row in got["nodes"].numpy():          # every node found
        assert set(row[row >= 0]) == {0, 1, 2, 3, 4}


def test_empty_table_matches_jax():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 2**32, size=(64, 5), dtype=np.uint32)
    targets = rng.integers(0, 2**32, size=(8, 5), dtype=np.uint32)
    got = _run_both(ids, targets, valid=np.zeros(64, bool), seed=3)
    assert not bool(got["converged"].any())
    assert bool((got["nodes"] == -1).all())


def _clustered_tables():
    """The geometries of tests/test_search.py's guarded-lower-bound test —
    random, 40 rows sharing their top 64 bits (tie64), 300 full
    duplicates, 1800 rows in one top-32 prefix (clustered) — plus 10
    rows sharing their top 64 bits (tie64_small, within the LUT budget),
    with probes that hit rows and their ±1 neighbours."""
    rng = np.random.default_rng(64)
    base = rng.integers(0, 2**32, size=(2048, 5), dtype=np.uint32)
    probes = rng.integers(0, 2**32, size=(256, 5), dtype=np.uint32)
    probes[:64] = base[rng.integers(0, 2048, 64)]
    probes[64:96] = base[rng.integers(0, 2048, 32)]
    probes[64:96, 4] += 1
    probes[96:128] = base[rng.integers(0, 2048, 32)]
    probes[96:128, 4] -= 1
    dup = base.copy()
    dup[100:140, :2] = dup[100, :2]
    dup_small = base.copy()
    dup_small[100:110, :2] = dup_small[100, :2]
    dup2 = base.copy()
    dup2[:300] = dup2[0]
    clus = base.copy()
    clus[:1800, 0] = 0x7777AAAA
    p2 = probes.copy()
    p2[:128, 0] = 0x7777AAAA
    return {"random": (base, probes), "tie64": (dup, probes),
            "tie64_small": (dup_small, probes), "full-dup": (dup2, probes),
            "clustered": (clus, p2)}


# (tie64, lut_ok) of each geometry: which tier _guarded_lower_bound takes
TIERS = {"random": (False, True), "tie64": (True, False),
         "tie64_small": (True, True), "full-dup": (True, False),
         "clustered": (False, False)}


@pytest.mark.parametrize("geometry", sorted(TIERS))
def test_guarded_lower_bound_matches_jax(geometry):
    ids, probes = _clustered_tables()[geometry]
    (js, jn), (ts, tn) = _tables(ids)
    jl = JST.build_prefix_lut(js, jn)
    tl = TST.build_prefix_lut(ts, tn)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    want = np.asarray(JS._guarded_lower_bound(js, jn, jl)(
        jnp.asarray(probes)))
    got = TS._guarded_lower_bound(ts, int(tn), tl)(TK.to_keys(probes, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    # and the exact full-depth search agrees
    np.testing.assert_array_equal(
        got.numpy(), TST._lower_bound(ts, TK.to_keys(probes, "cpu"),
                                      tn).numpy())


@pytest.mark.parametrize("geometry", sorted(TIERS))
def test_geometries_take_their_tiers(geometry):
    """Each geometry reaches the tier it is meant to: adjacent top-64
    duplicates (tie64) and LUT buckets over the budget (not lut_ok)."""
    ids = _clustered_tables()[geometry][0]
    s = ids[np.lexsort(ids.T[::-1])]
    tie = bool(((s[1:, 0] == s[:-1, 0]) & (s[1:, 1] == s[:-1, 1])).any())
    lut = TST.build_prefix_lut(TK.to_keys(s, "cpu"), s.shape[0])
    steps = TST.lut_budget_steps(s.shape[0], TST._lut_bits(lut))
    lut_ok = int((lut[1:] - lut[:-1]).max()) <= 1 << (steps - 1)
    assert (tie, lut_ok) == TIERS[geometry]


@pytest.mark.parametrize("geometry,mode", [("tie64", "lut"),
                                           ("tie64_small", "lut"),
                                           ("clustered", "lut"),
                                           ("clustered", "exact")])
def test_simulate_lookups_on_clustered_tables_matches_jax(geometry, mode):
    ids, probes = _clustered_tables()[geometry]
    _run_both(ids, probes[:96], seed=21, block_mode=mode)


@pytest.mark.parametrize("cluster", [False, True])
def test_lut_block_bounds_matches_jax(cluster):
    rng = np.random.default_rng(55)
    raw = rng.integers(0, 2**32, size=(4096, 5), dtype=np.uint32)
    if cluster:
        raw[:3000, 0] = raw[0, 0]
    (js, jn), (ts, tn) = _tables(raw)
    jl = JST.build_prefix_lut(js, jn, bits=16)
    tl = TST.build_prefix_lut(ts, tn, bits=16)
    t0 = rng.integers(0, 2**32, size=64, dtype=np.uint32)
    t0[:8] = np.asarray(js)[::512, 0][:8]
    t0[8:12] = (0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF)
    for L in (0, 1, 7, 15, 16, 19, 40, 160):
        wl, wu = JS._lut_block_bounds(jl, jnp.asarray(t0),
                                      jnp.full((64,), L, jnp.int32))
        gl, gu = TS._lut_block_bounds(tl, TK.to_keys(t0, "cpu"),
                                      torch.full((64,), L, dtype=torch.int32))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl), str(L))
        np.testing.assert_array_equal(gu.numpy(), np.asarray(wu), str(L))


def test_prefix_block_bounds_matches_jax_incl_the_wrap():
    """The exact block edges, with all-ones and all-zeros targets (the
    increment wraps to zero and the block runs to n) and prefix lengths
    0..160."""
    rng = np.random.default_rng(56)
    ids = rng.integers(0, 2**32, size=(2048, 5), dtype=np.uint32)
    (js, jn), (ts, tn) = _tables(ids)
    t = rng.integers(0, 2**32, size=(64, 5), dtype=np.uint32)
    t[0], t[1] = 0xFFFFFFFF, 0
    t[2:10] = ids[rng.integers(0, 2048, 8)]
    plen = rng.integers(0, 161, size=64).astype(np.int32)
    plen[:4] = (5, 160, 0, 33)

    def jlower(q):
        return JST._lower_bound(js, q, jn)

    def tlower(q):
        return TST._lower_bound(ts, q, tn)

    wl, wu = JS._prefix_block_bounds(jlower, jn, jnp.asarray(t),
                                     jnp.asarray(plen))
    gl, gu = TS._prefix_block_bounds(tlower, int(tn), TK.to_keys(t, "cpu"),
                                     torch.from_numpy(plen))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))
    assert int(gu[0]) == int(tn)                   # the wrap


@pytest.fixture(scope="module")
def compaction_case():
    rng = np.random.default_rng(23)
    ids = rng.integers(0, 2**32, size=(4096, 5), dtype=np.uint32)
    targets = rng.integers(0, 2**32, size=(256, 5), dtype=np.uint32)
    (js, jn), (ts, tn) = _tables(ids)
    ref = TS.simulate_lookups(ts, tn, TK.to_keys(targets, "cpu"), seed=11,
                              state_limbs=2, device="cpu")
    return (js, jn), (ts, tn), targets, ref


@pytest.mark.parametrize("after,cap", [(4, 256), (4, 192), (2, 8)])
def test_survivor_compaction_matches_jax(compaction_case, after, cap):
    """cap = Q, a partial cap and an overflowing cap of 8: each equals
    the JAX package's compacted run and the port's plain run."""
    (js, jn), (ts, tn), targets, ref = compaction_case
    kw = dict(seed=11, state_limbs=2, compact_after=after, compact_cap=cap)
    want = JS.simulate_lookups(js, jn, jnp.asarray(targets), **kw)
    got = TS.simulate_lookups(ts, tn, TK.to_keys(targets, "cpu"),
                              device="cpu", **kw)
    _assert_same(want, got)
    for key in ("nodes", "hops", "converged", "dist"):
        assert torch.equal(got[key], ref[key]), key
    if cap == 8:
        # the cap overflowed: more than 8 searches were alive at the cut
        assert int((ref["hops"] > after).sum()) > 8


@pytest.mark.parametrize("limbs", [1, 2, 5])
def test_fused_gather_planar_and_gather_rows_match_jax(limbs):
    rng = np.random.default_rng(7)
    table = rng.integers(0, 2**32, size=(300, 5), dtype=np.uint32)
    rows = rng.integers(-3, 310, size=(17, 6)).astype(np.int32)
    rows[0, :3] = (-1, 0, 299)
    want = JST.fused_gather_planar(jnp.asarray(table).T, jnp.asarray(rows),
                                   limbs)
    got = TST.fused_gather_planar(TK.to_keys(table, "cpu"),
                                  torch.from_numpy(rows), limbs)
    assert len(got) == limbs
    for w, g in zip(want, got):
        assert g.shape == tuple(rows.shape)
        np.testing.assert_array_equal(TK.from_keys(g), np.asarray(w))
    want_rows = np.asarray(JX.gather_rows(jnp.asarray(table),
                                          jnp.asarray(rows)))
    got_rows = TK.from_keys(TX.gather_rows(TK.to_keys(table, "cpu"),
                                           torch.from_numpy(rows)))
    np.testing.assert_array_equal(got_rows, want_rows)
    # masked fused planes == the oracle's limbs
    ok = (rows >= 0) & (rows < 300)
    for l in range(limbs):
        np.testing.assert_array_equal(TK.from_keys(got[l])[ok],
                                      got_rows[..., l][ok])


def _mix32_np(x):
    x = x.astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


EDGE_U32 = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0xFFFF,
                     0x10000, 0xDEADBEEF], dtype=np.uint32)


def test_mix32_matches_numpy_uint32_and_jax():
    rng = np.random.default_rng(8)
    x = np.concatenate([EDGE_U32, rng.integers(0, 2**32, 4096,
                                               dtype=np.uint32)])
    want = _mix32_np(x)
    for arg in (torch.from_numpy(x.view(np.int32)),          # raw bits
                torch.from_numpy(x.astype(np.int64))):        # values
        got = TS._mix32(arg)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(np.asarray(JS._mix32(jnp.asarray(x))),
                                  want)


@pytest.mark.parametrize("round_no,q_total,seed", [
    (0, 96, 99), (7, 65536, 0), (48, 2**27, 0xFFFFFFFF),
    (3, 2**31 + 5, 0x80000000), (47, 0xFFFFFFFF, 12345)])
def test_reply_counter_matches_numpy_uint32(round_no, q_total, seed):
    """The counter wraps mod 2^32 (48·2^27 > 2^32, and q_total up to
    2^32-1), and its hash equals numpy's uint32 arithmetic."""
    alpha, k = 3, 8
    q = np.array([0, 1, 65535, 2**31 - 1, 2**31, 2**32 - 1],
                 dtype=np.uint32)
    u = np.uint32
    with np.errstate(over="ignore"):
        want = ((((u(round_no) * u(q_total) + q[:, None, None]) * u(alpha)
                  + np.arange(alpha, dtype=u)[None, :, None]) * u(k)
                 + np.arange(k, dtype=u)[None, None, :]) ^ u(seed))
        want_h = _mix32_np(want)
    got = TS._reply_counter(round_no, q_total,
                            torch.from_numpy(q.view(np.int32)), alpha, k,
                            seed)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(
        TS._mix32(got).numpy().astype(np.uint32), want_h)


def test_scalar_lookup_matches_jax():
    ids, targets = _golden_inputs()
    (js, jn), _ = _tables(ids[:1500])
    s = np.asarray(js)
    for i in range(4):
        want = JS.scalar_lookup(s, int(jn), targets[i], k=8, alpha=3,
                                rng=np.random.default_rng(100 + i))
        got = TS.scalar_lookup(s, int(jn), targets[i], k=8, alpha=3,
                               rng=np.random.default_rng(100 + i))
        assert got == want


def test_telemetry_on_and_off_bit_identical():
    ids, targets = _golden_inputs()
    s, _, n = TST.sort_table(TK.to_keys(ids[:2048], "cpu"))
    q = TK.to_keys(targets[:48], "cpu")
    reg = TT.get_registry()
    before = reg.snapshot()
    on = TS.simulate_lookups(s, n, q, seed=5, state_limbs=2, device="cpu")
    diff = TT.snapshot_diff(before, reg.snapshot())
    assert diff["histograms"]['dht_search_wave_seconds{mode="single"}'][
        "count"] == 1
    assert diff["histograms"]['dht_search_hops{mode="single"}'][
        "count"] == 48
    reg.enabled = False
    try:
        off = TS.simulate_lookups(s, n, q, seed=5, state_limbs=2,
                                  device="cpu")
    finally:
        reg.enabled = True
    for key in ("nodes", "hops", "converged", "dist"):
        assert torch.equal(on[key], off[key]), key


def test_record_wave_traces_the_wave_under_a_context():
    """The round spans carry the clock's measured rounds, not the wave
    divided evenly; without a clock (the tp wave) no round is made up."""
    from opendht_tpu_torch import tracing
    tr = tracing.get_tracer()
    out = {"hops": torch.tensor([1, 3, 2], dtype=torch.int32)}
    clock = TS._StageClock()
    clock.t = 1000.0                      # the record stage's entry
    clock.rounds = [[999.9972, 0.0010, 0.0002], [999.9984, 0.0004, 0.0001],
                    [999.9989, 0.0009, 0.0002]]
    root = tracing.TraceContext.new_root()
    with tracing.activate(root):
        TS.record_wave(out, 0.003, 3, clock=clock)
    spans = tr.spans(root.trace_hex)
    (wave,) = [s for s in spans if s["name"] == "dht.search.wave"]
    rounds = sorted((s for s in spans if s["name"] == "dht.search.round"),
                    key=lambda s: s["attrs"]["round"])
    assert [r["parent_id"] for r in rounds] == [wave["span_id"]] * 3
    assert [r["attrs"]["round"] for r in rounds] == [0, 1, 2]
    for r, (t0, launch, sync) in zip(rounds, clock.rounds):
        assert r["dur"] == pytest.approx(launch + sync, abs=1e-12)
        assert r["attrs"]["launch_s"] == launch
        assert r["attrs"]["sync_s"] == sync
        # one offset maps the clock to the tracer's: the wave starts
        # ``elapsed`` before the record stage
        assert r["start"] - wave["start"] == pytest.approx(
            t0 - (clock.t - 0.003), abs=1e-6)
    assert wave["dur"] == 0.003 and wave["attrs"]["rounds"] == 3

    root = tracing.TraceContext.new_root()
    with tracing.activate(root):
        TS.record_wave(out, 0.003, 3, mode="tp")
    assert [s["name"] for s in tr.spans(root.trace_hex)] == [
        "dht.search.wave"]


# -- the stage clock -------------------------------------------------------

ROUND_STAGES = ("select", "reply", "gather", "merge", "done", "sync")
#: the stages inside the wave's envelope, ``dht_search_wave_seconds``
ENVELOPE = ("prepare", "bootstrap") + ROUND_STAGES + ("compact", "finish")


def _stage_wave(**kw):
    """One CPU wave with the registry on: (outputs, the registry's diff,
    loop iterations counted by the reply streams it drew, wall seconds
    around the call)."""
    ids, targets = _golden_inputs()
    s, _, n = TST.sort_table(TK.to_keys(ids[:2048], "cpu"))
    q = TK.to_keys(targets[:64], "cpu")
    reg = TT.get_registry()
    streams = []
    counter = TS._reply_counter

    def counting(*a, **k):
        streams.append(a[0])
        return counter(*a, **k)

    TS._reply_counter = counting
    try:
        before = reg.snapshot()
        t0 = time.perf_counter()
        out = TS.simulate_lookups(s, n, q, seed=5, state_limbs=2,
                                  device="cpu", **kw)
        wall = time.perf_counter() - t0
        diff = TT.snapshot_diff(before, reg.snapshot())
    finally:
        TS._reply_counter = counter
    return out, diff, len(streams) - 1, wall      # minus the bootstrap's


def _stages(diff):
    pre = 'dht_search_stage_seconds{mode="single",stage="'
    return {k[len(pre):-2]: v for k, v in diff["histograms"].items()
            if k.startswith(pre)}


#: (engine settings, reads besides one per iteration on the CPU)
SYNC_CASES = {
    # the tier, the final all_done, the hops' copy back
    "plain": ({}, 3),
    # the loop stops on its round cap: no final all_done
    "capped": ({"max_hops": 2}, 2),
    # the cut (no final read), the nonzero, the sub-batch's and the
    # safety net's final reads
    "compacted": ({"compact_after": 2, "compact_cap": 64}, 5),
    "overflowed": ({"compact_after": 2, "compact_cap": 8}, 5),
}


@pytest.mark.parametrize("case", ["plain", "compacted"])
def test_stages_partition_the_wave(case):
    kw, _ = SYNC_CASES[case]
    out, diff, _, wall = _stage_wave(**kw)
    st = _stages(diff)
    assert all(h["count"] == 1 for h in st.values())
    want = {"upload", "record", *ENVELOPE}
    if case == "plain":
        want.discard("compact")
    assert set(st) == want
    inside = sum(st[s]["sum"] for s in ENVELOPE if s in st)
    wave = diff["histograms"]['dht_search_wave_seconds{mode="single"}']
    assert wave["count"] == 1
    assert inside == pytest.approx(wave["sum"], rel=0.01, abs=50e-6)
    # the stages cover the call, from its first reading to its last
    total = sum(h["sum"] for h in st.values())
    assert total <= wall
    assert all(h["sum"] > 0 for h in st.values())


@pytest.mark.parametrize("case", ["plain", "capped", "compacted"])
def test_rounds_total_counts_the_loop_iterations(case):
    kw, _ = SYNC_CASES[case]
    out, diff, iterations, _ = _stage_wave(**kw)
    got = diff["counters"]['dht_search_rounds_total{mode="single"}']
    assert got == iterations
    assert iterations >= int(out["hops"].max())
    if case == "capped":
        assert iterations == 2
    assert _stages(diff)["select"]["count"] == 1


@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_host_syncs_are_iterations_plus_the_fixed_reads(case):
    kw, fixed = SYNC_CASES[case]
    out, diff, iterations, _ = _stage_wave(**kw)
    assert diff["counters"]['dht_search_host_syncs_total{mode="single"}'] \
        == iterations + fixed
    if case == "overflowed":
        # the cap overflowed, so the safety net ran rounds of its own
        assert int((out["hops"] > 2).sum()) > 8


def test_registry_disabled_reads_no_clock_and_writes_no_series(
        monkeypatch):
    on, _, _, _ = _stage_wave()
    ids, targets = _golden_inputs()
    s, _, n = TST.sort_table(TK.to_keys(ids[:2048], "cpu"))
    q = TK.to_keys(targets[:64], "cpu")

    def no_clock():
        raise AssertionError("a clock was read")

    monkeypatch.setattr(TS, "time", type("NoClock", (), {
        "perf_counter": staticmethod(no_clock),
        "time": staticmethod(no_clock)}))
    reg = TT.get_registry()
    before = reg.snapshot()
    reg.enabled = False
    try:
        off = TS.simulate_lookups(s, n, q, seed=5, state_limbs=2,
                                  device="cpu")
    finally:
        reg.enabled = True
    diff = TT.snapshot_diff(before, reg.snapshot())
    assert not any(k.startswith("dht_search_")
                   for k in (*diff["histograms"], *diff["counters"]))
    for key in ("nodes", "hops", "converged", "dist"):
        assert torch.equal(on[key], off[key]), key


@pytest.fixture(scope="module")
def profiled_wave():
    """One CPU wave under ``torch.profiler`` and a sampled trace context:
    (the profiler's ``search.*`` intervals by name, in µs, the ring's
    spans, the registry's diff)."""
    from torch.profiler import ProfilerActivity, profile
    from opendht_tpu_torch import tracing
    ids, targets = _golden_inputs()
    s, _, n = TST.sort_table(TK.to_keys(ids[:2048], "cpu"))
    q = TK.to_keys(targets[:64], "cpu")
    reg = TT.get_registry()
    tr = tracing.get_tracer()
    root = tracing.TraceContext.new_root()
    before = reg.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            tracing.activate(root):
        TS.simulate_lookups(s, n, q, seed=5, state_limbs=2, device="cpu")
    diff = TT.snapshot_diff(before, reg.snapshot())
    marks = {}
    for e in prof.events():
        if e.name.startswith("search."):
            marks.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return ({k: sorted(v) for k, v in marks.items()},
            tr.spans(root.trace_hex), diff)


def test_profiler_sees_one_select_per_iteration_and_every_stage(
        profiled_wave):
    marks, _, diff = profiled_wave
    rounds = diff["counters"]['dht_search_rounds_total{mode="single"}']
    assert rounds > 0
    assert len(marks["search.select"]) == rounds
    assert set(marks) == {"search." + s for s in ENVELOPE
                          if s != "compact"} | {"search.upload",
                                                "search.record"}
    # the bootstrap's gather and merge keep their labels, inside it
    (boot,) = marks["search.bootstrap"]
    inner = [m for m in marks["search.merge"]
             if boot[0] <= m[0] and m[1] <= boot[1]]
    assert len(inner) == 1 and len(marks["search.merge"]) == rounds + 1


def test_round_spans_match_the_profilers_rounds(profiled_wave):
    """Each ring round lasts from its ``search.select`` start to the end
    of the ``search.sync`` after it, on the profiler's clock."""
    marks, spans, _ = profiled_wave
    (wave,) = [s for s in spans if s["name"] == "dht.search.wave"]
    rounds = sorted((s for s in spans if s["name"] == "dht.search.round"),
                    key=lambda s: s["attrs"]["round"])
    selects = marks["search.select"]
    assert len(rounds) == len(selects)
    for r, (a, _) in zip(rounds, selects):
        end = min(b for s, b in marks["search.sync"] if s > a)
        want = (end - a) / 1e6
        assert r["dur"] == pytest.approx(want, rel=0.05, abs=2e-4)
        assert r["dur"] == pytest.approx(
            r["attrs"]["launch_s"] + r["attrs"]["sync_s"], abs=1e-12)
        assert wave["start"] <= r["start"]
        assert r["start"] + r["dur"] <= wave["start"] + wave["dur"]
