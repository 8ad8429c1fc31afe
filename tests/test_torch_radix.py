"""The port's k-bucket maintenance (``ops/radix.py``, the bit helpers of
``ops/ids.py`` and the ``NodeTable`` maintenance methods) against the
JAX package's, bit for bit, on the same numpy inputs.

Reply times near now ≈ 1.7e9 s show the float32 rule: the JAX package
runs without x64, so the table's float64 reply times and ``now - age``
reach the sweep as float32 — at that magnitude float32 steps are 128 s,
and a float64 comparison would call other buckets stale.  Random bits
cannot be shared between ``jax.random`` and ``torch.Generator``, so the
refresh targets are compared through ``_random_id_from_bits`` fed with
the bits ``jax.random.bits`` drew, and otherwise checked to lie in their
buckets.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opendht_tpu.core.table import NodeTable as JaxTable
from opendht_tpu.infohash import InfoHash as JaxHash
from opendht_tpu.ops import ids as JK
from opendht_tpu.ops import radix as JR
from opendht_tpu_torch.core.table import NODE_EXPIRE_TIME, NodeTable
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.ops import ids as TK
from opendht_tpu_torch.ops import radix as TR

NOW = 1.7e9


def _ids(geometry, n=3000, seed=0):
    """Self id, ids (random, or clustered: sharing 0..40 leading bits
    with self, self's own id in rows 0..4), a valid mask and reply times
    near ``NOW`` (a quarter never replied)."""
    rng = np.random.default_rng(seed)
    me = rng.integers(0, 2**32, size=5, dtype=np.uint32)
    ids = rng.integers(0, 2**32, size=(n, 5), dtype=np.uint32)
    if geometry == "clustered":
        # share 0..40 leading bits with self
        depth = rng.integers(0, 41, size=n)
        for d in range(41):
            rows = depth == d
            masks = JR._PREFIX_MASKS[d]
            ids[rows] = (me & masks) | (ids[rows] & ~masks)
        ids[:5] = me                                    # self's own id
    valid = rng.random(n) > 0.1
    last = NOW - rng.uniform(0, 3600, size=n)
    last[rng.random(n) < 0.25] = 0.0                    # never replied
    return me, ids, valid, last


def _keys(a):
    return TK.to_keys(a, "cpu")


@pytest.mark.parametrize("geometry", ["random", "clustered"])
def test_bucket_counts_and_last_seen_match_jax(geometry):
    me, ids, valid, last = _ids(geometry)
    want_c = np.asarray(JR.bucket_counts(jnp.asarray(me), jnp.asarray(ids),
                                         jnp.asarray(valid)))
    got_c = TR.bucket_counts(_keys(me), _keys(ids), torch.from_numpy(valid))
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    want_l = np.asarray(JR.bucket_last_seen(
        jnp.asarray(me), jnp.asarray(ids), jnp.asarray(valid),
        jnp.asarray(last)))
    got_l = TR.bucket_last_seen(_keys(me), _keys(ids),
                                torch.from_numpy(valid),
                                torch.from_numpy(last))
    assert got_l.dtype == torch.float32 and want_l.dtype == np.float32
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    assert np.isneginf(want_l).any()          # never-replied / empty


def _float32_boundary_case():
    """Buckets whose last reply lies within one float32 step of
    now - age: the float32 and float64 stale sets differ on them."""
    me, ids, valid, last = _ids("clustered", seed=3)
    valid[:] = True
    now, age = NOW + 601.5, 600.0
    last[last > 0] = NOW + 1.0                 # f64: stale, f32: fresh
    return me, ids, valid, last, now, age


@pytest.mark.parametrize("geometry", ["random", "clustered", "boundary"])
def test_maintenance_sweep_matches_jax(geometry):
    if geometry == "boundary":
        me, ids, valid, last, now, age = _float32_boundary_case()
    else:
        me, ids, valid, last = _ids(geometry)
        now, age = NOW, NODE_EXPIRE_TIME
    key = jax.random.PRNGKey(5)
    wc, wl, ws, wt = JR.maintenance_sweep(
        jnp.asarray(me), jnp.asarray(ids), jnp.asarray(valid),
        jnp.asarray(last), now, age, key)
    gc, gl, gs, gt = TR.maintenance_sweep(me, ids, valid, last, now, age,
                                          device="cpu")
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    if geometry == "boundary":
        # the case exercises the rule: float64 would call these stale
        stale64 = (gc.numpy() > 0) & (
            np.where(np.isfinite(gl.numpy()), NOW + 1.0, -np.inf)
            < now - age)
        assert stale64.sum() > gs.numpy().sum()
    # targets: same bits → same ids; every target in its bucket
    bits = np.array(jax.random.bits(key, (160, 5), dtype=jnp.uint32))
    from_bits = TR._random_id_from_bits(
        _keys(me), torch.arange(160), torch.from_numpy(bits.view(np.int32)))
    np.testing.assert_array_equal(TK.from_keys(from_bits), np.asarray(wt))
    cb = np.asarray(JK.common_bits(jnp.asarray(me)[None], jnp.asarray(
        TK.from_keys(gt))))
    np.testing.assert_array_equal(cb, np.arange(160))


@pytest.mark.parametrize("bucket", [0, 1, 31, 32, 33, 63, 64, 100, 159])
def test_random_id_from_bits_matches_random_id_in_bucket(bucket):
    rng = np.random.default_rng(bucket)
    me = rng.integers(0, 2**32, size=5, dtype=np.uint32)
    key = jax.random.PRNGKey(bucket)
    b = np.full(16, bucket, np.int32)
    want = np.asarray(JR.random_id_in_bucket(jnp.asarray(me),
                                             jnp.asarray(b), key))
    bits = np.array(jax.random.bits(key, (16, 5), dtype=jnp.uint32))
    got = TR._random_id_from_bits(_keys(me), torch.from_numpy(b),
                                  torch.from_numpy(bits.view(np.int32)))
    np.testing.assert_array_equal(TK.from_keys(got), want)
    drawn = TR.random_id_in_bucket(_keys(me), torch.from_numpy(b),
                                   torch.Generator().manual_seed(1))
    cb = np.asarray(JK.common_bits(jnp.asarray(me)[None],
                                   jnp.asarray(TK.from_keys(drawn))))
    assert (cb == bucket).all()


@pytest.mark.parametrize("geometry", ["random", "clustered", "small"])
def test_estimate_network_size_matches_jax(geometry):
    me, ids, valid, _ = _ids("clustered" if geometry == "small"
                             else geometry)
    if geometry == "small":
        ids, valid = ids[:6], valid[:6]              # fewer than k: count
    want = int(JR.estimate_network_size(jnp.asarray(me), jnp.asarray(ids),
                                        jnp.asarray(valid)))
    got = TR.estimate_network_size(_keys(me), _keys(ids),
                                   torch.from_numpy(valid))
    assert got.dtype == torch.int32 and int(got) == want


def test_get_bit_set_bit_lowbit_match_jax():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 2**32, size=(64, 5), dtype=np.uint32)
    a[0] = 0
    a[1] = 0xFFFFFFFF
    a[2] = (0, 0, 0, 0, 1)
    a[3] = (0x80000000, 0, 0, 0, 0)
    nbit = rng.integers(0, 160, size=64).astype(np.int32)
    nbit[:6] = (0, 31, 32, 63, 159, 128)
    value = rng.random(64) < 0.5
    np.testing.assert_array_equal(
        TK.get_bit(_keys(a), torch.from_numpy(nbit)).numpy(),
        np.asarray(JK.get_bit(jnp.asarray(a), jnp.asarray(nbit))))
    np.testing.assert_array_equal(
        TK.from_keys(TK.set_bit(_keys(a), torch.from_numpy(nbit),
                                torch.from_numpy(value))),
        np.asarray(JK.set_bit(jnp.asarray(a), jnp.asarray(nbit),
                              jnp.asarray(value))))
    np.testing.assert_array_equal(TK.lowbit(_keys(a)).numpy(),
                                  np.asarray(JK.lowbit(jnp.asarray(a))))
    # a scalar bit index broadcasts, as in the JAX package
    np.testing.assert_array_equal(
        TK.get_bit(_keys(a), 7).numpy(),
        np.asarray(JK.get_bit(jnp.asarray(a), 7)))


def _pair(seed, n_replied=300, n_hearsay=300):
    rng = np.random.default_rng(seed)
    me = rng.integers(0, 256, 20, dtype=np.uint8).tobytes()
    jt = JaxTable(JaxHash(me), capacity=64)
    tt = NodeTable(InfoHash(me), capacity=64, device="cpu")
    replied = JK.ids_from_bytes(rng.integers(0, 256, (n_replied, 20),
                                             dtype=np.uint8))
    hearsay = JK.ids_from_bytes(rng.integers(0, 256, (n_hearsay, 20),
                                             dtype=np.uint8))
    for t in (jt, tt):
        t.bulk_load(replied, now=NOW, replied=True)
        t.bulk_load(hearsay, now=NOW, replied=False)
    return jt, tt, me


@pytest.mark.parametrize("dt", [1.0, NODE_EXPIRE_TIME - 100.0,
                                NODE_EXPIRE_TIME + 1.0, 700.0, 5000.0])
def test_node_table_maintenance_matches_jax(dt):
    jt, tt, me = _pair(13)
    now = NOW + dt
    np.testing.assert_array_equal(tt.bucket_occupancy(),
                                  jt.bucket_occupancy())
    np.testing.assert_array_equal(tt.stale_buckets(now),
                                  jt.stale_buckets(now))
    w_stale, _ = jt.maintenance_sweep(now)
    g_stale, g_targets = tt.maintenance_sweep(now)
    np.testing.assert_array_equal(g_stale, w_stale)
    assert g_stale.dtype == w_stale.dtype
    assert g_targets.shape == (len(g_stale), 5)
    for j, b in enumerate(g_stale):
        h = InfoHash(TK.ids_to_bytes(g_targets[j]).tobytes())
        assert InfoHash.common_bits(InfoHash(me), h) == b
    assert tt.network_size_estimate() == jt.network_size_estimate()


def test_float32_disagreement_of_the_two_stale_paths_is_reproduced():
    """A fault of the JAX package, reproduced and not repaired: replies
    at 1.7e9 + 1 s, now = 1.7e9 + 700 s, age 600 s.  ``stale_buckets``
    compares the float32 last reply with the float64 ``now - age`` cast
    once; ``maintenance_sweep`` subtracts in float32.  At this magnitude
    a float32 step is 128 s, so the first calls the buckets stale and the
    second does not — in both packages alike."""
    rng = np.random.default_rng(16)
    me = rng.integers(0, 256, 20, dtype=np.uint8).tobytes()
    ids = JK.ids_from_bytes(rng.integers(0, 256, (200, 20), dtype=np.uint8))
    jt = JaxTable(JaxHash(me), capacity=64)
    tt = NodeTable(InfoHash(me), capacity=64, device="cpu")
    for t in (jt, tt):
        t.bulk_load(ids, now=NOW + 1.0, replied=True)
    now = NOW + 700.0
    j_stale, t_stale = jt.stale_buckets(now), tt.stale_buckets(now)
    j_sweep, t_sweep = jt.maintenance_sweep(now)[0], tt.maintenance_sweep(
        now)[0]
    np.testing.assert_array_equal(t_stale, j_stale)
    np.testing.assert_array_equal(t_sweep, j_sweep)
    assert len(t_stale) > 0 and len(t_sweep) == 0


def test_never_replied_buckets_are_stale_from_birth():
    """Shortly after a load only the buckets whose peers never replied
    are stale, in both packages (the reference's Bucket::time starts at
    time_point::min())."""
    jt, tt, _ = _pair(14, n_replied=40, n_hearsay=40)
    stale, _ = tt.maintenance_sweep(NOW + 1.0)
    np.testing.assert_array_equal(stale, jt.maintenance_sweep(NOW + 1.0)[0])
    assert len(stale) > 0
    replied_buckets = set(tt._bucket[(tt._time_reply > 0)
                                     & tt._valid].tolist())
    assert set(stale.tolist()).isdisjoint(replied_buckets)


def test_refresh_targets_thread_the_table_generator():
    """Without a generator the table threads its own, seeded once:
    consecutive calls differ; an explicit generator is deterministic."""
    _, tt, me = _pair(15, 20, 20)
    buckets = np.array([0, 1, 5, 42, 159])
    a = tt.refresh_targets(buckets)
    gen = tt._maint_gen
    b = tt.refresh_targets(buckets)
    assert tt._maint_gen is gen and not np.array_equal(a, b)
    c = tt.refresh_targets(buckets, torch.Generator().manual_seed(3))
    d = tt.refresh_targets(buckets, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(c, d)
    for arr in (a, b, c):
        for j, bk in enumerate(buckets):
            h = InfoHash(TK.ids_to_bytes(arr[j]).tobytes())
            assert InfoHash.common_bits(InfoHash(me), h) == bk
