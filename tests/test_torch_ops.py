"""Parity of the torch port's ops with the JAX package, bit for bit.

The same numpy-seeded inputs go through each JAX function (on the JAX
CPU backend; Pallas selects in interpret mode) and its counterpart in
``opendht_tpu_torch`` on CPU tensors, where the ``"kernel"`` selects run
their plain torch versions.  Every output is an integer array, so the
tolerance is exact equality.  Geometries follow tests/test_topk.py and
tests/test_pallas_select.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opendht_tpu.ops import ids as JK
from opendht_tpu.ops import sorted_table as JS
from opendht_tpu.ops import xor_topk as JX
from opendht_tpu_torch.ops import ids as TK
from opendht_tpu_torch.ops import sorted_table as TS
from opendht_tpu_torch.ops import xor_topk as TX


def _rand_raw(n, seed, cluster=0):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n, 20), dtype=np.uint8)
    if cluster:
        raw[: n // 2, :cluster] = raw[0, :cluster]
    return raw


def _keys(u32):
    return TK.to_keys(u32, "cpu")


def _eq(jax_out, torch_out, what=""):
    """Exact equality; torch int32 key tensors are compared as uint32."""
    j = np.asarray(jax_out)
    if isinstance(torch_out, torch.Tensor):
        t = (TK.from_keys(torch_out) if j.dtype == np.uint32
             else torch_out.numpy())
    else:
        t = np.asarray(torch_out)
    assert j.shape == t.shape, (what, j.shape, t.shape)
    np.testing.assert_array_equal(t, j, err_msg=what)


def _triple_eq(jout, tout, what=""):
    for name, a, b in zip(("dist", "idx", "cert"), jout, tout):
        _eq(a, b, f"{what} {name}")


# ---------------------------------------------------------------------------
# ids
# ---------------------------------------------------------------------------

def test_ids_codec_matches_jax():
    raw = _rand_raw(257, 1)
    np.testing.assert_array_equal(TK.ids_from_bytes(raw),
                                  JK.ids_from_bytes(raw))
    np.testing.assert_array_equal(TK.ids_from_bytes(raw.tobytes()),
                                  JK.ids_from_bytes(raw.tobytes()))
    u = JK.ids_from_bytes(raw)
    np.testing.assert_array_equal(TK.ids_to_bytes(u), JK.ids_to_bytes(u))
    np.testing.assert_array_equal(TK.from_keys(_keys(u)), u)
    with pytest.raises(ValueError):
        TK.ids_from_bytes(b"\x00" * 21)


def test_id_math_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 2**32, size=(300, 5), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(300, 5), dtype=np.uint32)
    # edge rows: equal ids, ids differing in one low bit, extremes
    b[:20] = a[:20]
    b[20:40] = a[20:40]
    b[20:40, 4] ^= np.uint32(1)
    b[40:60, :2] = a[40:60, :2]
    a[60] = 0
    b[60] = 0xFFFFFFFF
    ka, kb = _keys(a), _keys(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _eq(JK.xor_ids(ja, jb), TK.xor_ids(ka, kb), "xor")
    _eq(JK.common_bits(ja, jb), TK.common_bits(ka, kb), "common_bits")
    _eq(JK.lex_lt(ja, jb), TK.lex_lt(ka, kb), "lex_lt")
    _eq(JK.lex_lt(jb, ja), TK.lex_lt(kb, ka), "lex_lt rev")
    x = (a ^ b).reshape(-1)
    x[:33] = np.uint32(1) << np.arange(32, dtype=np.uint32).repeat(2)[:33]
    _eq(JK.clz32(jnp.asarray(x)),
        TK.clz32(torch.from_numpy(x.view(np.int32).copy())), "clz32")
    # xor_ids in the key domain round-trips: q ^ dist(q, id) = id
    np.testing.assert_array_equal(
        TK.from_keys(TK.xor_ids(ka, TK.xor_ids(ka, kb))), b)


def test_bucket_of_matches_jax():
    from opendht_tpu.ops import radix as JR
    from opendht_tpu_torch.ops import radix as TR
    rng = np.random.default_rng(3)
    me = rng.integers(0, 2**32, size=(5,), dtype=np.uint32)
    ids = rng.integers(0, 2**32, size=(200, 5), dtype=np.uint32)
    ids[:50, :2] = me[:2]
    ids[50] = me
    _eq(JR.bucket_of(jnp.asarray(me), jnp.asarray(ids)),
        TR.bucket_of(_keys(me), _keys(ids)))


# ---------------------------------------------------------------------------
# xor_topk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [8, 16])
def test_xor_topk_matches_jax(k):
    table_raw = _rand_raw(3000, 10)
    table_raw[100] = table_raw[50]            # duplicate id → index tie-break
    q_raw = _rand_raw(48, 11)
    q_raw[0] = table_raw[7]                   # distance-0 case
    q, t = JK.ids_from_bytes(q_raw), JK.ids_from_bytes(table_raw)
    jd, ji = JX.xor_topk(jnp.asarray(q), jnp.asarray(t), k=k, tile=512)
    td, ti = TX.xor_topk(_keys(q), _keys(t), k=k, tile=512)
    _eq(jd, td, "dist")
    _eq(ji, ti, "idx")


@pytest.mark.parametrize("n_valid,tile", [(43, 512), (3, 16)])
def test_xor_topk_valid_mask_matches_jax(n_valid, tile):
    table_raw = _rand_raw(64, 12)
    valid = np.zeros(64, bool)
    valid[np.random.default_rng(n_valid).permutation(64)[:n_valid]] = True
    q = JK.ids_from_bytes(_rand_raw(16, 13))
    t = JK.ids_from_bytes(table_raw)
    jd, ji = JX.xor_topk(jnp.asarray(q), jnp.asarray(t), k=8, tile=tile,
                         valid=jnp.asarray(valid))
    td, ti = TX.xor_topk(_keys(q), _keys(t), k=8, tile=tile,
                         valid=torch.from_numpy(valid))
    _eq(jd, td, "dist")
    _eq(ji, ti, "idx")


def test_xor_topk_chunked_matches_jax():
    q = JK.ids_from_bytes(_rand_raw(40, 15))
    t = JK.ids_from_bytes(_rand_raw(1000, 14))
    jd, ji = JX.xor_topk_chunked(jnp.asarray(q), jnp.asarray(t), k=8,
                                 tile=256, q_chunk=7)
    td, ti = TX.xor_topk_chunked(_keys(q), _keys(t), k=8, tile=256,
                                 q_chunk=7)
    _eq(jd, td, "dist")
    _eq(ji, ti, "idx")


# ---------------------------------------------------------------------------
# sorted table: sort, LUT, lower bound, expansion
# ---------------------------------------------------------------------------

def test_sort_table_matches_jax():
    raw = _rand_raw(500, 16)
    raw[200] = raw[100] = raw[300]            # duplicates keep row order
    valid = np.ones(500, bool)
    valid[7] = valid[100] = False
    ids = JK.ids_from_bytes(raw)
    js = JS.sort_table(jnp.asarray(ids), jnp.asarray(valid))
    ts = TS.sort_table(_keys(ids), torch.from_numpy(valid))
    for name, a, b in zip(("sorted", "perm", "n_valid"), js, ts):
        _eq(a, b, name)


@pytest.mark.parametrize("bits,lut_steps", [(16, 3), (16, None), (20, None)])
def test_prefix_lut_and_lower_bound_match_jax(bits, lut_steps):
    rng = np.random.default_rng(77)
    raw = rng.integers(0, 256, size=(4096, 20), dtype=np.uint8)
    raw[:3000, :2] = 0x41                     # LUT bucket overflow cluster
    valid = np.ones(4096, bool)
    valid[::9] = False
    ids = JK.ids_from_bytes(raw)
    q_raw = rng.integers(0, 256, size=(128, 20), dtype=np.uint8)
    q_raw[:64, :2] = 0x41
    q_raw[64:70] = raw[10:16]                 # exact hits
    q = JK.ids_from_bytes(q_raw)
    js, _, jn = JS.sort_table(jnp.asarray(ids), jnp.asarray(valid))
    ts, _, tn = TS.sort_table(_keys(ids), torch.from_numpy(valid))
    jl = JS.build_prefix_lut(js, jn, bits=bits)
    tl = TS.build_prefix_lut(ts, tn, bits=bits)
    _eq(jl, tl, "lut")
    _eq(JS._lower_bound(js, jnp.asarray(q), jn),
        TS._lower_bound(ts, _keys(q), tn), "lower_bound plain")
    _eq(JS._lower_bound(js, jnp.asarray(q), jn, lut=jl, lut_steps=lut_steps),
        TS._lower_bound(ts, _keys(q), tn, lut=tl, lut_steps=lut_steps),
        "lower_bound lut")
    assert TS.default_lut_bits(4096) == JS.default_lut_bits(4096)
    assert TS.lut_budget_steps(4096, bits) == JS.lut_budget_steps(4096, bits)


@pytest.mark.parametrize("n,stride", [(300, 64), (4096, 64), (1000, 32)])
def test_expand_table_matches_jax(n, stride):
    ids = JK.ids_from_bytes(_rand_raw(n, 40 + n))
    js, _, _ = JS.sort_table(jnp.asarray(ids))
    ts, _, _ = TS.sort_table(_keys(ids))
    _eq(JS.expand_table(js, stride=stride),
        TS.expand_table(ts, stride=stride))
    with pytest.raises(ValueError, match="SUPPORTED_STRIDES"):
        TS.expand_table(ts, stride=20)


# ---------------------------------------------------------------------------
# window_topk / expanded_topk / lookup_topk
# ---------------------------------------------------------------------------

def _tables(table_raw, valid=None, bits=16):
    ids = JK.ids_from_bytes(table_raw)
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    js, jp, jn = JS.sort_table(jnp.asarray(ids), jv)
    ts, tp, tn = TS.sort_table(_keys(ids), tv)
    return ((js, jn, JS.build_prefix_lut(js, jn, bits=bits),
             JS.expand_table(js)),
            (ts, tn, TS.build_prefix_lut(ts, tn, bits=bits),
             TS.expand_table(ts)))


@pytest.mark.parametrize("select,jselect", [("sort", "sort"),
                                            ("kernel", "pallas")])
@pytest.mark.parametrize("cluster", [0, 10])
def test_window_topk_matches_jax(select, jselect, cluster):
    table_raw = _rand_raw(4096, 17, cluster=cluster)
    q_raw = _rand_raw(64, 18)
    q_raw[1] = table_raw[5]
    q_raw[2:10] = table_raw[:8]
    q_raw[2:10, 19] ^= 0x0F
    # in the clustered case, queries inside the cluster with a narrow
    # window: most of them fail the certificate
    window = 8 if cluster else 64
    q_raw[32:, :cluster] = table_raw[0, :cluster]
    (js, jn, jl, _), (ts, tn, tl, _) = _tables(table_raw)
    q = JK.ids_from_bytes(q_raw)
    jout = JS.window_topk(js, jn, jnp.asarray(q), k=8, window=window,
                          select=jselect)
    tout = TS.window_topk(ts, tn, _keys(q), k=8, window=window,
                          select=select)
    _triple_eq(jout, tout, f"{select} cluster={cluster}")
    if cluster:
        assert not np.asarray(jout[2]).all()  # the fallback case is covered
    jout = JS.window_topk(js, jn, jnp.asarray(q), k=8, window=window,
                          select=jselect, lut=jl, lut_steps=3)
    tout = TS.window_topk(ts, tn, _keys(q), k=8, window=window,
                          select=select, lut=tl, lut_steps=3)
    _triple_eq(jout, tout, f"{select} lut")


@pytest.mark.parametrize("select,jselect", [("sort", "sort"),
                                            ("kernel", "pallas")])
def test_window_topk_small_n_valid_matches_jax(select, jselect):
    table_raw = _rand_raw(8, 20)
    valid = np.array([True] * 5 + [False] * 3)
    (js, jn, _, _), (ts, tn, _, _) = _tables(table_raw, valid)
    q = JK.ids_from_bytes(_rand_raw(4, 21))
    _triple_eq(JS.window_topk(js, jn, jnp.asarray(q), k=8, window=16,
                              select=jselect),
               TS.window_topk(ts, tn, _keys(q), k=8, window=16,
                              select=select))


@pytest.mark.parametrize("expanded", [True, False])
def test_lookup_topk_fallback_matches_jax(expanded):
    table_raw = _rand_raw(2048, 43, cluster=10)
    q_raw = np.concatenate([table_raw[:32], _rand_raw(32, 49)])
    q_raw[:32, 19] ^= 0xFF
    (js, jn, _, je), (ts, tn, _, te) = _tables(table_raw)
    q = JK.ids_from_bytes(q_raw)
    jd, ji, jc = JS.lookup_topk(js, jn, jnp.asarray(q), k=8, window=8,
                                expanded=je if expanded else None)
    td, ti, tc = TS.lookup_topk(ts, tn, _keys(q), k=8, window=8,
                                expanded=te if expanded else None)
    _triple_eq((jd, ji, jc), (td, ti, tc))
    # the certificate failed somewhere, so the fallback really ran
    _, _, tc0 = TS.lookup_topk(ts, tn, _keys(q), k=8, window=8,
                               expanded=te if expanded else None,
                               fallback=False)
    assert not tc0.all()
    # and the fallback rows equal the exact full scan
    ed, ei = TX.xor_topk(_keys(q), ts, k=8,
                         valid=torch.arange(ts.shape[0]) < tn)
    assert torch.equal(ed, td) and torch.equal(ei, ti)


def test_auto_select_on_cpu_resolves_like_jax():
    table_raw = _rand_raw(4096, 50)
    (js, jn, _, je), (ts, tn, _, te) = _tables(table_raw)
    q = JK.ids_from_bytes(_rand_raw(64, 51))
    _triple_eq(JS.expanded_topk(js, je, jn, jnp.asarray(q), k=8),
               TS.expanded_topk(ts, te, tn, _keys(q), k=8), "fast3")
    _triple_eq(JS.window_topk(js, jn, jnp.asarray(q), k=8),
               TS.window_topk(ts, tn, _keys(q), k=8), "sort")
