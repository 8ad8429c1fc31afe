"""The port's scale-out layer (``opendht_tpu_torch.parallel``) against the
JAX package's (``opendht_tpu.parallel``).

Each test twins one of tests/test_sharded.py: the same numpy inputs go
through the JAX function on the JAX tests' 8 virtual CPU devices and
through the port's on a mesh of virtual CPU shards of the same (q, t)
geometry (``make_mesh(n, devices="cpu")``).  Tolerance: BIT-IDENTICAL —
distance limbs (after ``from_keys``), global rows, hop counts,
convergence flags, sketch cells.  Also twinned: the keyspace sketch,
hot-cache probe and listener-match sharded planes, and the node's
``resolve_mesh_t`` knob, whose sharded resolve answers as the JAX node's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opendht_tpu import parallel as JP
from opendht_tpu.parallel import sharded as JSh
from opendht_tpu.core.search import simulate_lookups as j_simulate
from opendht_tpu.ops.sorted_table import sort_table as j_sort
from opendht_tpu_torch import parallel as TP
from opendht_tpu_torch.core.search import simulate_lookups
from opendht_tpu_torch.ops import ids as TK
from opendht_tpu_torch.ops import radix as TR
from opendht_tpu_torch.ops.sorted_table import build_prefix_lut, sort_table
from opendht_tpu_torch.ops.xor_topk import xor_topk


def _rand_ids(rng, n):
    return rng.integers(0, 2**32, size=(n, 5), dtype=np.uint32)


def _meshes(q, t):
    """(JAX mesh, port mesh) of the same geometry."""
    if len(jax.devices()) < q * t:
        pytest.skip(f"needs {q * t} virtual JAX devices")
    return (JP.make_mesh(q * t, q=q, t=t),
            TP.make_mesh(q * t, q=q, t=t, devices="cpu"))


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual JAX devices")
    return JP.make_mesh(8), TP.make_mesh(8, devices="cpu")


def _same_topk(j, p):
    """(dist, idx) of a JAX function vs the port's, bit for bit."""
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(TK.from_keys(p[0]), np.asarray(j[0]))


def _same_engine(j, p, keys=("nodes", "hops", "converged", "dist")):
    for key in keys:
        got = p[key]
        got = TK.from_keys(got) if key == "dist" else got.numpy()
        np.testing.assert_array_equal(got, np.asarray(j[key]), err_msg=key)


def _sorted_both(ids):
    """A globally sorted table in both packages (and its n_valid)."""
    js, _, jn = j_sort(jnp.asarray(ids))
    ts, _, tn = sort_table(TK.to_keys(ids, "cpu"))
    np.testing.assert_array_equal(TK.from_keys(ts), np.asarray(js))
    assert int(tn) == int(jn)
    return np.asarray(js), int(jn), ts


def test_mesh_shape(meshes):
    jm, pm = meshes
    assert pm.shape == dict(jm.shape)
    assert pm.shape["q"] * pm.shape["t"] == 8
    assert pm.axis_names == tuple(jm.axis_names)


def test_make_mesh_needs_cards_or_an_explicit_device_list():
    """Without explicit devices the mesh is the first n CUDA cards, and
    asking for more than exist raises; a device list (or one device,
    repeated) builds a virtual mesh."""
    with pytest.raises(RuntimeError, match="CUDA device"):
        TP.make_mesh(torch.cuda.device_count() + 1)
    m = TP.make_mesh(4, q=2, devices=["cpu"] * 4)
    assert m.shape == {"q": 2, "t": 2}
    assert m.merge_device == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh 3x2"):
        TP.make_mesh(4, q=3, t=2, devices="cpu")


def test_sharded_xor_topk_matches_single_device(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(7)
    table = _rand_ids(rng, 512)
    queries = _rand_ids(rng, 16 * pm.shape["q"])
    p = TP.sharded_xor_topk(pm, queries, table, k=8)
    _same_topk(JP.sharded_xor_topk(jm, queries, table, k=8), p)
    ref = xor_topk(TK.to_keys(queries, "cpu"), TK.to_keys(table, "cpu"), k=8)
    assert torch.equal(p[0], ref[0]) and torch.equal(p[1], ref[1])


def test_sharded_xor_topk_with_invalid_rows(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(8)
    table = _rand_ids(rng, 256)
    valid = rng.random(256) > 0.3
    queries = _rand_ids(rng, 8 * pm.shape["q"])
    _same_topk(JP.sharded_xor_topk(jm, queries, table, k=8,
                                   valid=jnp.asarray(valid)),
               TP.sharded_xor_topk(pm, queries, table, k=8, valid=valid))


def test_sharded_xor_topk_padded_table(meshes):
    """A row count not divisible by n_t is padded with invalid rows; the
    result is the unpadded one."""
    jm, pm = meshes
    rng = np.random.default_rng(9)
    table = _rand_ids(rng, 301)
    queries = _rand_ids(rng, 4 * pm.shape["q"])
    padded, n = TP.pad_to_multiple(table, pm.shape["t"])
    assert padded.shape[0] > n
    valid = np.arange(padded.shape[0]) < n
    p = TP.sharded_xor_topk(pm, queries, padded, k=8, valid=valid)
    _same_topk(JP.sharded_xor_topk(jm, queries, padded, k=8,
                                   valid=jnp.asarray(valid)), p)
    ref = xor_topk(TK.to_keys(queries, "cpu"), TK.to_keys(table, "cpu"), k=8)
    assert torch.equal(p[0], ref[0]) and torch.equal(p[1], ref[1])


def test_sharded_xor_topk_q_must_divide(meshes):
    """A query batch that does not divide the q axis is refused, as the
    JAX placement refuses it."""
    jm, pm = meshes
    if pm.shape["q"] == 1:
        pytest.skip("q axis of 1")
    rng = np.random.default_rng(12)
    table = _rand_ids(rng, 64)
    queries = _rand_ids(rng, pm.shape["q"] + 1)
    with pytest.raises(ValueError, match="not divisible"):
        TP.sharded_xor_topk(pm, queries, table, k=8)
    with pytest.raises(ValueError):
        JP.sharded_xor_topk(jm, queries, table, k=8)


def test_sharded_window_lookup_matches_full_scan(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(10)
    table = _rand_ids(rng, 1024)
    queries = _rand_ids(rng, 8 * pm.shape["q"])
    p = TP.sharded_lookup(pm, queries, table, k=8, window=64)
    _same_topk(JP.sharded_lookup(jm, queries, table, k=8, window=64), p)


def test_sharded_sort_once_lookup_many(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(12)
    table = _rand_ids(rng, 512)
    js, jp, jn = JP.sharded_sort_table(jm, table)
    ps, pp, pn = TP.sharded_sort_table(pm, table)
    np.testing.assert_array_equal(TK.from_keys(ps.gather()), np.asarray(js))
    np.testing.assert_array_equal(pp.gather().numpy(), np.asarray(jp))
    np.testing.assert_array_equal(pn.gather().numpy(), np.asarray(jn))
    for _ in range(3):
        queries = _rand_ids(rng, 8 * pm.shape["q"])
        _same_topk(JP.sharded_window_lookup(jm, queries, js, jp, jn, k=8,
                                            window=64),
                   TP.sharded_window_lookup(pm, queries, ps, pp, pn, k=8,
                                            window=64))


def test_sharded_expanded_lookup_matches_full_scan(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(21)
    table = _rand_ids(rng, 1024)
    js, jp, jn = JP.sharded_sort_table(jm, table)
    jx, jl = JP.sharded_expand_table(jm, js, jn)
    ps, pp, pn = TP.sharded_sort_table(pm, table)
    px, pl = TP.sharded_expand_table(pm, ps, pn)
    np.testing.assert_array_equal(TK.from_keys(px.gather()), np.asarray(jx))
    np.testing.assert_array_equal(pl.gather().numpy(), np.asarray(jl))
    for _ in range(2):
        queries = _rand_ids(rng, 8 * pm.shape["q"])
        _same_topk(JP.sharded_window_lookup(jm, queries, js, jp, jn, k=8,
                                            expanded=jx, lut=jl),
                   TP.sharded_window_lookup(pm, queries, ps, pp, pn, k=8,
                                            expanded=px, lut=pl))


def test_sharded_window_fallback_on_clustered_ids(meshes):
    """Clustered ids with duplicates across shards: every shard's window
    certificate fails for the cluster's queries, the shard-local exact
    scan answers them, and the merge (shard-major candidates, ties by
    position) gives the JAX rows — both routes."""
    jm, pm = meshes
    rng = np.random.default_rng(22)
    table = _rand_ids(rng, 1024)
    table[:600, 0] = 0x41414141
    table[:600, 1] = 0x42424242
    table[600:700] = table[:100]                 # exact duplicates
    queries = _rand_ids(rng, 8 * pm.shape["q"])
    queries[: 4 * pm.shape["q"], 0] = 0x41414141
    queries[: 4 * pm.shape["q"], 1] = 0x42424242
    js, jp, jn = JP.sharded_sort_table(jm, table)
    ps, pp, pn = TP.sharded_sort_table(pm, table)
    _same_topk(JP.sharded_window_lookup(jm, queries, js, jp, jn, k=8,
                                        window=32),
               TP.sharded_window_lookup(pm, queries, ps, pp, pn, k=8,
                                        window=32))
    jx, jl = JP.sharded_expand_table(jm, js, jn)
    px, pl = TP.sharded_expand_table(pm, ps, pn)
    _same_topk(JP.sharded_window_lookup(jm, queries, js, jp, jn, k=8,
                                        expanded=jx, lut=jl),
               TP.sharded_window_lookup(pm, queries, ps, pp, pn, k=8,
                                        expanded=px, lut=pl))


def test_dp_simulate_matches_unsharded(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(11)
    ids = _rand_ids(rng, 2048)
    js, n, ts = _sorted_both(ids)
    targets = _rand_ids(rng, 16 * 8)
    want = JP.dp_simulate_lookups(jm, js, n, targets, seed=3)
    got = TP.dp_simulate_lookups(pm, ts, n, targets, seed=3)
    _same_engine(want, got)
    _same_engine(want, simulate_lookups(ts, n, targets, seed=3,
                                        device="cpu"))


def test_tp_simulate_matches_unsharded(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(13)
    ids = _rand_ids(rng, 4096)
    js, n, ts = _sorted_both(ids)
    targets = _rand_ids(rng, 16 * pm.shape["q"])
    want = JP.tp_simulate_lookups(jm, js, n, targets, seed=5)
    got = TP.tp_simulate_lookups(pm, ts, n, targets, seed=5)
    _same_engine(want, got)
    _same_engine(j_simulate(jnp.asarray(js), n, jnp.asarray(targets),
                            seed=5), got)


def test_tp_simulate_padded_table(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(14)
    ids = _rand_ids(rng, 1021)
    js, n, ts = _sorted_both(ids)
    targets = _rand_ids(rng, 8 * pm.shape["q"])
    padded, _ = TP.pad_to_multiple(js, pm.shape["t"])
    _same_engine(JP.tp_simulate_lookups(jm, padded, n, targets, seed=2),
                 TP.tp_simulate_lookups(pm, padded, n, targets, seed=2))


def test_tp_simulate_clustered_ids(meshes):
    """Clustered ids overflow the per-shard LUT buckets: the guarded
    positioning drops to the full-depth search on those shards and the
    engine still matches JAX."""
    jm, pm = meshes
    rng = np.random.default_rng(15)
    ids = _rand_ids(rng, 2048)
    ids[:1500, 0] = 0x41414141
    js, n, ts = _sorted_both(ids)
    targets = _rand_ids(rng, 8 * pm.shape["q"])
    targets[: 4 * pm.shape["q"], 0] = 0x41414141
    _same_engine(JP.tp_simulate_lookups(jm, js, n, targets, seed=6),
                 TP.tp_simulate_lookups(pm, ts, n, targets, seed=6))


@pytest.mark.parametrize("q,t", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_tp_simulate_mesh_geometries(q, t):
    jm, pm = _meshes(q, t)
    rng = np.random.default_rng(40 + q)
    ids = _rand_ids(rng, 2048)
    js, n, ts = _sorted_both(ids)
    targets = _rand_ids(rng, 8 * q)
    want = JP.tp_simulate_lookups(jm, js, n, targets, seed=4)
    _same_engine(want, TP.tp_simulate_lookups(pm, ts, n, targets, seed=4),
                 keys=("nodes", "hops", "converged"))


def test_tp_simulate_state_limbs_2_and_telemetry():
    """state_limbs=2 (config 3's setting) and the telemetry envelope
    (mode="tp" wave series) leave the engine's result unchanged."""
    from opendht_tpu_torch import telemetry as TT
    jm, pm = _meshes(1, 4)
    rng = np.random.default_rng(44)
    ids = _rand_ids(rng, 2048)
    js, n, ts = _sorted_both(ids)
    targets = _rand_ids(rng, 32)
    want = JP.tp_simulate_lookups(jm, js, n, targets, seed=1, alpha=3,
                                  state_limbs=2)
    reg = TT.get_registry()
    was = reg.enabled
    reg.enabled = True
    try:
        got = TP.tp_simulate_lookups(pm, ts, n, targets, seed=1, alpha=3,
                                     state_limbs=2)
        assert reg.histogram("dht_search_wave_width", mode="tp").count >= 1
    finally:
        reg.enabled = was
    _same_engine(want, got)


def test_sharded_maintenance_sweep_matches_single_device(meshes):
    """Counts, last-reply maxima and staleness equal the JAX sharded
    sweep; the refresh targets equal the port's single-device sweep with
    the same generator and lie in their buckets (the JAX package draws
    them from jax.random, which torch cannot reproduce:
    tests/test_torch_radix.py holds the bit arithmetic)."""
    jm, pm = meshes
    rng = np.random.default_rng(55)
    N = 4096
    ids = _rand_ids(rng, N)
    self_id = _rand_ids(rng, 1).reshape(-1)
    valid = rng.random(N) > 0.1
    last = np.where(rng.random(N) > 0.3,
                    rng.uniform(1.0, 100.0, N), 0.0).astype(np.float32)
    now, age = 700.0, 600.0
    want = JP.sharded_maintenance_sweep(jm, self_id, ids, valid, last, now,
                                        age, jax.random.PRNGKey(9))
    got = TP.sharded_maintenance_sweep(pm, self_id, ids, valid, last, now,
                                       age, torch.Generator().manual_seed(9))
    for a, b, name in zip(got[:3], want[:3], ("counts", "last", "stale")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    single = TR.maintenance_sweep(self_id, ids, valid, last, now, age,
                                  torch.Generator().manual_seed(9),
                                  device="cpu")
    assert torch.equal(got[3], single[3])
    cb = TK.common_bits(TK.to_keys(self_id, "cpu")[None], got[3])
    assert torch.equal(cb, torch.arange(160, dtype=torch.int32))


def test_sharded_maintenance_sweep_padded_table(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(56)
    ids = _rand_ids(rng, 1000)
    self_id = _rand_ids(rng, 1).reshape(-1)
    last = rng.uniform(1.0, 100.0, 1000).astype(np.float32)
    padded, n = TP.pad_to_multiple(ids, pm.shape["t"] * 256)
    valid = np.arange(padded.shape[0]) < n
    last_p, _ = TP.pad_to_multiple(last, pm.shape["t"] * 256)
    want = JP.sharded_maintenance_sweep(jm, self_id, padded, valid, last_p,
                                        700.0, 600.0, jax.random.PRNGKey(10))
    got = TP.sharded_maintenance_sweep(pm, self_id, padded, valid, last_p,
                                       700.0, 600.0)
    for a, b, name in zip(got[:3], want[:3], ("counts", "last", "stale")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    with pytest.raises(ValueError, match="not divisible"):
        TP.sharded_maintenance_sweep(pm, self_id, ids[:1001 - 2], None,
                                     last[:999], 700.0, 600.0)


# ---------------------------------------------------------------------------
# the declarative partition layer
# ---------------------------------------------------------------------------

def test_match_partition_rules_names_and_scalars():
    from jax.sharding import PartitionSpec as JPS
    from opendht_tpu.parallel import partition as JPart
    from opendht_tpu_torch.parallel import partition as Part
    tree = {"sorted_ids": np.zeros((8, 5), np.uint32),
            "local_lut": np.zeros((2, 9), np.int32),
            "block_lut": np.zeros((17,), np.int32),
            "n_valid": np.int32(7),
            "nested": {"targets": np.zeros((4, 5), np.uint32)},
            "seq": [np.zeros((4,), bool), np.zeros((3, 5), np.uint32)]}
    want = JPart.match_partition_rules(JPart.TABLE_AXIS_RULES, tree)
    got = Part.match_partition_rules(Part.TABLE_AXIS_RULES, tree)
    assert got["sorted_ids"] == Part.P("t", None)
    assert got["local_lut"] == Part.P("t", None)
    assert got["block_lut"] == Part.P()
    assert got["n_valid"] == Part.P()
    assert got["nested"]["targets"] == Part.P("q", None)
    flat = lambda t: [t["block_lut"], t["local_lut"], t["n_valid"],  # noqa
                      t["nested"]["targets"], t["seq"][0], t["seq"][1],
                      t["sorted_ids"]]
    assert [tuple(s) for s in flat(got)] == [tuple(s) for s in flat(want)]
    assert Part.tree_paths(tree)["seq"][1] == JPart.tree_paths(tree)["seq"][1]
    dp = {"targets": np.zeros((4, 5)), "x": np.zeros((4, 2))}
    assert Part.match_partition_rules(Part.DP_AXIS_RULES, dp) == {
        "targets": Part.P(("q", "t"), None), "x": Part.P()}
    assert tuple(JPart.match_partition_rules(JPart.DP_AXIS_RULES, dp)[
        "targets"]) == (("q", "t"), None)
    with pytest.raises(ValueError, match="no partition rule"):
        Part.match_partition_rules([(r"^only_this$", Part.P("t"))],
                                   {"other": np.zeros((4,))})
    assert JPS("t", None) == JPS("t", None)


def test_shard_and_gather_fns_roundtrip(meshes):
    """A shard fn gives each device only its rows (N/t per shard); the
    gather fn returns the original; placing a placed leaf again is the
    identity (the snapshot resolve cache depends on it)."""
    from opendht_tpu_torch.parallel import partition as Part
    jm, pm = meshes
    rng = np.random.default_rng(70)
    tree = {"sorted_ids": _rand_ids(rng, 64 * pm.shape["t"])}
    specs = Part.match_partition_rules(Part.TABLE_AXIS_RULES, tree)
    shard_fns, gather_fns = Part.make_shard_and_gather_fns(pm, specs)
    placed = shard_fns["sorted_ids"](tree["sorted_ids"])
    shard = placed.shard(0, 0)
    assert shard.shape[0] == 64
    assert shard.numel() * shard.element_size() == \
        placed.nbytes // pm.shape["t"]
    np.testing.assert_array_equal(gather_fns["sorted_ids"](placed).numpy(),
                                  tree["sorted_ids"])
    assert shard_fns["sorted_ids"](placed) is placed
    # every q row holds the same t shards; the JAX placement agrees
    jplaced = JP.shard_put(jm, tree, JP.TABLE_AXIS_RULES)["sorted_ids"]
    for qi in range(pm.shape["q"]):
        for ti in range(pm.shape["t"]):
            np.testing.assert_array_equal(
                placed.shard(qi, ti).numpy(),
                np.asarray(jplaced.addressable_shards[
                    qi * pm.shape["t"] + ti].data))
    assert Part.constrain(tree, pm, Part.TABLE_AXIS_RULES) is tree


def test_shard_table_state_block_lut_is_global(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(71)
    ids = _rand_ids(rng, 2048)
    js, n, ts = _sorted_both(ids)
    want = JP.shard_table_state(jm, js, n)
    got = TP.shard_table_state(pm, ts, n)
    assert (got.shard_n, got.lut_bits, got.block_bits) == \
        (want.shard_n, want.lut_bits, want.block_bits)
    np.testing.assert_array_equal(got.arrays["block_lut"].gather().numpy(),
                                  np.asarray(want.arrays["block_lut"]))
    np.testing.assert_array_equal(got.arrays["local_lut"].gather().numpy(),
                                  np.asarray(want.arrays["local_lut"]))
    ref = build_prefix_lut(ts, n, bits=got.block_bits)
    assert torch.equal(got.arrays["block_lut"].shard(0, 0), ref)
    assert got.table_bytes_per_shard() == want.table_bytes_per_shard() \
        == 2048 // pm.shape["t"] * 20


def test_shard_table_state_casts_dtype(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(74)
    ids = _rand_ids(rng, 1024)
    js, n, ts = _sorted_both(ids)
    targets = _rand_ids(rng, 8 * pm.shape["q"])
    _same_engine(
        JP.tp_simulate_lookups(jm, js.astype(np.int64), n, targets, seed=7),
        TP.tp_simulate_lookups(pm, js.astype(np.int64), n, targets, seed=7))
    with pytest.raises(TypeError, match="keys"):
        TP.shard_table_state(pm, ts.to(torch.int64), n)


def test_tp_simulate_with_prebuilt_state(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(72)
    ids = _rand_ids(rng, 2048)
    js, n, ts = _sorted_both(ids)
    targets = _rand_ids(rng, 8 * pm.shape["q"])
    want = JP.tp_simulate_lookups(jm, targets=targets, seed=9,
                                  state=JP.shard_table_state(jm, js, n))
    state = TP.shard_table_state(pm, ts, n)
    for _ in range(2):
        _same_engine(want, TP.tp_simulate_lookups(pm, targets=targets, seed=9,
                                                  state=state))
    with pytest.raises(ValueError, match="state="):
        TP.tp_simulate_lookups(pm, targets=targets)


@pytest.mark.parametrize("q,t", [(1, 2), (2, 2), (1, 4), (4, 1)])
def test_row_sharded_geometry_sweep(q, t):
    """Every entry point on the ROW-SHARDED table across q×t splits: a
    ragged N (pad rows on the last shard) and an ALL-INVALID shard."""
    jm, pm = _meshes(q, t)
    rng = np.random.default_rng(60 + 4 * q + t)
    ids = _rand_ids(rng, 1021)
    js, n, ts = _sorted_both(ids)
    padded, _ = TP.pad_to_multiple(js, t * 4)
    targets = _rand_ids(rng, 8 * q)
    _same_engine(JP.tp_simulate_lookups(jm, padded, n, targets, seed=8),
                 TP.tp_simulate_lookups(pm, padded, n, targets, seed=8),
                 keys=("nodes", "hops", "converged"))

    table = _rand_ids(rng, 64 * t * 4)
    valid = np.zeros(table.shape[0], bool)
    valid[:table.shape[0] // 4] = True
    queries = _rand_ids(rng, 8 * q)
    _same_topk(JP.sharded_xor_topk(jm, queries, table, k=8,
                                   valid=jnp.asarray(valid)),
               TP.sharded_xor_topk(pm, queries, table, k=8, valid=valid))
    _same_topk(JP.sharded_lookup(jm, queries, table, k=8, window=32,
                                 valid=jnp.asarray(valid)),
               TP.sharded_lookup(pm, queries, table, k=8, window=32,
                                 valid=valid))

    self_id = _rand_ids(rng, 1).reshape(-1)
    last = rng.uniform(1.0, 100.0, table.shape[0]).astype(np.float32)
    want = JP.sharded_maintenance_sweep(jm, self_id, table, valid, last,
                                        700.0, 600.0, jax.random.PRNGKey(31))
    got = TP.sharded_maintenance_sweep(pm, self_id, table, valid, last,
                                       700.0, 600.0)
    for a, b, name in zip(got[:3], want[:3], ("counts", "last", "stale")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# the planes' sharded twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [2, 4])
def test_sharded_sketch_update_matches_jax(t):
    from opendht_tpu.ops import sketch as JS
    from opendht_tpu_torch.ops import sketch as TS
    jm, pm = _meshes(1, t)
    rng = np.random.default_rng(80 + t)
    ids = _rand_ids(rng, 301)                   # ragged: weight-0 pad rows
    ids[:40] = ids[0]                           # one hot id
    js, jh = JS.sketch_init(4, 1024)
    js, jh = JSh.sharded_sketch_update(jm, js, jh, ids)
    ts, th = TS.sketch_init(4, 1024, device="cpu")
    got_s, got_h = TP.sharded_sketch_update(pm, ts, th, ids)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(jh))
    ref_s, ref_h = TS.sketch_update(*TS.sketch_init(4, 1024, device="cpu"),
                                    ids)
    assert torch.equal(got_s, ref_s) and torch.equal(got_h, ref_h)
    assert int(ts.sum()) == 0                    # the input is untouched


@pytest.mark.parametrize("t", [2, 4])
def test_sharded_cache_probe_and_listener_match_match_jax(t):
    jm, pm = _meshes(1, t)
    rng = np.random.default_rng(90 + t)
    table = _rand_ids(rng, 64)
    valid = rng.random(64) > 0.2
    probe = _rand_ids(rng, 37)
    probe[::3] = table[rng.integers(0, 64, size=13)]
    for jfn, tfn in ((JSh.sharded_cache_probe, TP.sharded_cache_probe),
                     (JSh.sharded_listener_match,
                      TP.sharded_listener_match)):
        jh, js = jfn(jm, table, valid, probe)
        th, ts = tfn(pm, table, valid, probe)
        np.testing.assert_array_equal(th, jh)
        np.testing.assert_array_equal(ts, js)
        assert th.any() and not th.all()


# ---------------------------------------------------------------------------
# the node's resolve mesh
# ---------------------------------------------------------------------------

def _tables_both(rng, n=300, cap=512):
    from opendht_tpu.core.table import NodeTable as JTable
    from opendht_tpu.infohash import InfoHash as JHash
    from opendht_tpu_torch.core.table import NodeTable
    from opendht_tpu_torch.infohash import InfoHash
    me = rng.integers(0, 256, size=20, dtype=np.uint8).tobytes()
    jt = JTable(JHash(me), capacity=cap)
    pt = NodeTable(InfoHash(me), capacity=cap, device="cpu")
    for i in range(n):
        nid = rng.integers(0, 256, size=20, dtype=np.uint8).tobytes()
        addr = ("10.0.0.%d" % (i % 250), 4222)
        jt.insert(JHash(nid), addr, now=100.0, confirm=2)
        pt.insert(InfoHash(nid), addr, now=100.0, confirm=2)
    return jt, pt


def test_snapshot_lookup_sharded_matches_unsharded(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(73)
    jt, pt = _tables_both(rng)
    jsnap, psnap = jt.snapshot(100.0), pt.snapshot(100.0)
    q = _rand_ids(rng, 16)
    ref_rows, ref_dist = psnap.lookup(q, k=8)
    j_rows, j_dist = jsnap.lookup(q, k=8, mesh=jm)
    rows, dist = psnap.lookup(q, k=8, mesh=pm)
    np.testing.assert_array_equal(rows, j_rows)
    np.testing.assert_array_equal(dist, j_dist)
    np.testing.assert_array_equal(rows, ref_rows)
    np.testing.assert_array_equal(dist, ref_dist)
    placed = psnap._tp_state[2]
    rows2, _ = psnap.lookup(q, k=8, mesh=pm)      # the cached shards
    assert psnap._tp_state[2] is placed
    np.testing.assert_array_equal(rows2, ref_rows)
    # the table's find_closest hands the mesh through, past the host-scan
    # sizes, and records that the resolve ran sharded
    big = _rand_ids(rng, 128)
    want = jt.find_closest(big, k=8, now=100.0, mesh=jm)
    got = pt.find_closest(big, k=8, now=100.0, mesh=pm)
    assert pt.last_resolve_sharded and jt.last_resolve_sharded
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_dht_resolve_mesh_knob(caplog):
    """config.resolve_mesh_t builds the (q=1, t) mesh lazily, 0 keeps the
    unsharded path and an over-sized t degrades with a warning — on both
    packages (the port's CPU node has 8 virtual devices, as the JAX
    tests' host platform has)."""
    from opendht_tpu.runtime.config import Config as JConfig
    from opendht_tpu.runtime.dht import Dht as JDht
    from opendht_tpu_torch.runtime import Config, Dht
    for D, C, kw in ((JDht, JConfig, {}), (Dht, Config, {"device": "cpu"})):
        d0 = D(lambda data, addr: 0, C(), **kw)
        assert d0.resolve_mesh() is None and d0.resolve_mesh_t() == 1
        d4 = D(lambda data, addr: 0, C(resolve_mesh_t=4), **kw)
        m = d4.resolve_mesh()
        assert m is not None and m.shape["t"] == 4 and m.shape["q"] == 1
        assert d4.resolve_mesh_t() == 4
        assert d4.wave_builder.snapshot()["table_shard_t"] == 4
        with caplog.at_level("WARNING"):
            d_big = D(lambda data, addr: 0, C(resolve_mesh_t=512), **kw)
            assert d_big.resolve_mesh() is None
            assert d_big.resolve_mesh_t() == 1
    assert caplog.text.count("serving the unsharded resolve path") >= 2


def test_dht_sharded_batched_resolve_matches_jax():
    """A node with resolve_mesh_t=4 past the host-scan size answers a
    batched resolve through the sharded snapshot route with the JAX
    node's rows, and stamps the shard width it ran on."""
    from opendht_tpu.infohash import InfoHash as JHash
    from opendht_tpu.runtime import Config as JConfig, Dht as JDht
    from opendht_tpu.sockaddr import SockAddr as JAddr
    from opendht_tpu_torch.infohash import InfoHash
    from opendht_tpu_torch.runtime import Config, Dht
    from opendht_tpu_torch.sockaddr import SockAddr
    rng = np.random.default_rng(75)
    ids = _rand_ids(rng, 5000)
    me = bytes(range(20))
    nodes = []
    for D, C, H, A, kw in ((JDht, JConfig, JHash, JAddr, {}),
                           (Dht, Config, InfoHash, SockAddr,
                            {"device": "cpu"})):
        d = D(lambda data, addr: 0, C(node_id=H(me), resolve_mesh_t=4),
              has_v6=False, **kw)
        d.tables[2].bulk_load(ids, d.scheduler.time(),
                              addrs=A("10.0.0.7", 4222))
        targets = [H(t.tobytes()) for t in
                   TK.ids_to_bytes(_rand_ids(np.random.default_rng(76),
                                             100))]
        res = d.find_closest_nodes_batched(targets, 2, 8)
        assert d.last_resolve_shard_t == 4
        nodes.append([[bytes(n.id) for n in r] for r in res])
    assert nodes[0] == nodes[1]
