"""Parity of the port's 2-plane / fast2 / tombstone / cascade lookup
pieces with the JAX package, bit for bit.

The same numpy-seeded inputs go through the JAX function (JAX CPU
backend) and the port on CPU tensors: ``expand_table(limbs=)``,
``expand_table_chunked``, ``expanded_topk`` with ``select="fast2"``,
``planes=`` and ``tomb_bits=`` (and its ValueErrors), ``cascade_topk``
(cap overflow included), ``lookup_topk``'s JAX keywords and
``_fallback_tile``.  Every output is an integer array: the tolerance is
exact equality.  Geometries follow tests/test_topk.py:260-860.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opendht_tpu.ops import ids as JK
from opendht_tpu.ops import sorted_table as JS
from opendht_tpu_torch.ops import sorted_table as TS

from test_torch_ops import _eq, _keys, _rand_raw


def _pack_bits(mask):
    """bool [N] → packed little-endian uint32 words (bit b of word w =
    sorted position 32·w + b)."""
    out = np.zeros((len(mask) + 31) // 32, np.uint32)
    pos = np.nonzero(mask)[0]
    np.bitwise_or.at(out, pos >> 5, np.uint32(1) << (pos & 31).astype(np.uint32))
    return out


def _sorted_pair(raw, valid=None, bits=16):
    """(jax sorted, n_valid, lut), (port sorted, n_valid, lut)."""
    ids = JK.ids_from_bytes(raw)
    js, _, jn = JS.sort_table(jnp.asarray(ids),
                              None if valid is None else jnp.asarray(valid))
    ts, _, tn = TS.sort_table(_keys(ids), None if valid is None
                              else torch.from_numpy(valid))
    return ((js, jn, JS.build_prefix_lut(js, jn, bits=bits)),
            (ts, tn, TS.build_prefix_lut(ts, tn, bits=bits)))


def _out_eq(jout, tout, what=""):
    """(dist, idx, cert) equality where dist may be None or a tuple of
    fast2 planes."""
    jd, td = jout[0], tout[0]
    if jd is None:
        assert td is None, what
    elif isinstance(jd, tuple):
        assert isinstance(td, tuple) and len(td) == len(jd), what
        for a, b in zip(jd, td):
            _eq(a, b, f"{what} dist plane")
    else:
        _eq(jd, td, f"{what} dist")
    _eq(jout[1], tout[1], f"{what} idx")
    _eq(jout[2], tout[2], f"{what} cert")


def _fast2_cases():
    """Uniform with an invalid mask, a prefix cluster, rows sharing their
    top 64 bits (fast2's tie check), a tiny n_valid."""
    raw = _rand_raw(4096, 70)
    valid = np.ones(4096, bool)
    valid[::6] = False
    raw_t = _rand_raw(1024, 72)
    raw_t[:64, :8] = raw_t[0, :8]
    valid_s = np.zeros(512, bool)
    valid_s[:5] = True
    return [(raw, valid), (_rand_raw(2048, 71, cluster=8), None),
            (raw_t, None), (_rand_raw(512, 73), valid_s)]


@pytest.mark.parametrize("stride", [16, 32, 64])
def test_expand_table_limbs_matches_jax(stride):
    valid = np.ones(1000, bool)
    valid[::9] = False
    (js, _, _), (ts, _, _) = _sorted_pair(_rand_raw(1000, 60 + stride), valid)
    for limbs in (2, 5):
        _eq(JS.expand_table(js, stride=stride, limbs=limbs),
            TS.expand_table(ts, stride=stride, limbs=limbs), (stride, limbs))


@pytest.mark.parametrize("n,chunks", [(4096, 8), (4099, 4), (1000, 3)])
def test_expand_table_chunked_matches_jax(n, chunks):
    (js, _, _), (ts, _, _) = _sorted_pair(_rand_raw(n, 57 + n))
    for limbs, stride in ((5, 64), (2, 32)):
        got = TS.expand_table_chunked(ts, stride=stride, chunks=chunks,
                                      limbs=limbs)
        _eq(JS.expand_table_chunked(js, stride=stride, chunks=chunks,
                                    limbs=limbs), got, (n, chunks, limbs))
        one = TS.expand_table(ts, stride=stride, limbs=limbs)
        assert torch.equal(got[:one.shape[0]], one)


@pytest.mark.parametrize("planes,stride", [(2, 32), (2, 64), (5, 64),
                                           (2, 16)])
def test_expanded_topk_fast2_matches_jax(planes, stride):
    for ci, (raw, valid) in enumerate(_fast2_cases()):
        (js, jn, jl), (ts, tn, tl) = _sorted_pair(raw, valid)
        je = JS.expand_table(js, stride=stride, limbs=planes)
        te = TS.expand_table(ts, stride=stride, limbs=planes)
        q = JK.ids_from_bytes(np.concatenate([_rand_raw(64, 74), raw[:16]]))
        for steps in (None, 0):
            for limbs_out in (False, True):
                kw = dict(k=8, select="fast2", lut_steps=steps,
                          planes=planes, fast2_limbs=limbs_out)
                jout = JS.expanded_topk(js, je, jn, jnp.asarray(q), lut=jl,
                                        **kw)
                _out_eq(jout, TS.expanded_topk(ts, te, tn, _keys(q), lut=tl,
                                               **kw),
                        (ci, steps, limbs_out))
        if ci == 2:                       # the top-64 tie table decertifies
            assert not np.asarray(jout[2]).all()


def _tomb_table(seed):
    """A 4096-id table, ~15 % tombstoned with every row of one region
    dead, and queries: random, hits, and ids inside the dead region."""
    rng = np.random.default_rng(seed)
    raw = _rand_raw(4096, seed)
    ids = JK.ids_from_bytes(raw)
    (js, jn, jl), (ts, tn, tl) = _sorted_pair(raw)
    dead = rng.random(4096) < 0.15
    dead[1000:1400] = True
    q_raw = np.concatenate([_rand_raw(48, seed + 1), raw[:8]])
    sorted_np = np.asarray(js)
    q = np.concatenate([JK.ids_from_bytes(q_raw), sorted_np[1100:1108]])
    return (js, jn, jl), (ts, tn, tl), _pack_bits(dead), q, ids


def _all_ones_case(stride):
    """One window covers the whole 80-row table; every row but a few is
    tombstoned, and a live row's top 64 distance bits to the query are
    all ones — it sits late in the window, after dead lanes."""
    rng = np.random.default_rng(90 + stride)
    q = rng.integers(0, 2**32, size=(1, 5), dtype=np.uint32)
    q[0, 0] = 0x10000000
    ids = rng.integers(0, 2**32, size=(80, 5), dtype=np.uint32)
    ids[0, :2] = ~q[0, :2]                      # top 64 distance bits all ones
    js, _, jn = JS.sort_table(jnp.asarray(ids))
    ts, _, tn = TS.sort_table(_keys(ids))
    sorted_np = np.asarray(js)
    y = int(np.nonzero((sorted_np == ids[0]).all(axis=1))[0][0])
    dead = np.ones(80, bool)
    dead[y] = False
    dead[[3, 40]] = False                       # two more live rows
    assert dead[:y].sum() > 8                   # dead lanes before it
    return (js, jn), (ts, tn), _pack_bits(dead), q, y


@pytest.mark.parametrize("select,planes", [("sort", 5), ("fast3", 5),
                                           ("fast2", 5), ("fast2", 2)])
@pytest.mark.parametrize("stride", [32, 64])
def test_expanded_topk_tomb_bits_matches_jax(select, planes, stride):
    (js, jn, jl), (ts, tn, tl), tomb, q, _ = _tomb_table(31 + stride)
    kw = dict(k=8, select=select, planes=planes, fast2_limbs=True)
    je = JS.expand_table(js, stride=stride, limbs=planes)
    te = TS.expand_table(ts, stride=stride, limbs=planes)
    jout = JS.expanded_topk(js, je, jn, jnp.asarray(q), lut=jl,
                            tomb_bits=jnp.asarray(tomb), **kw)
    _out_eq(jout, TS.expanded_topk(ts, te, tn, _keys(q), lut=tl,
                                   tomb_bits=TS.tomb_tensor(tomb, "cpu"),
                                   **kw), "random tombstones")
    assert not np.asarray(jout[2]).all()        # the dead region decertifies
    # the all-ones-top-64 live lane beside tombstoned lanes
    (js, jn), (ts, tn), tomb, q, y = _all_ones_case(stride)
    je = JS.expand_table(js, stride=stride, limbs=planes)
    te = TS.expand_table(ts, stride=stride, limbs=planes)
    jout = JS.expanded_topk(js, je, jn, jnp.asarray(q),
                            tomb_bits=jnp.asarray(tomb), **kw)
    tout = TS.expanded_topk(ts, te, tn, _keys(q),
                            tomb_bits=TS.tomb_tensor(tomb, "cpu"), **kw)
    _out_eq(jout, tout, "all-ones lane")
    assert y in tout[1][0].tolist() and bool(tout[2][0])


def _err_cases():
    """(name, call(mod, sorted, n_valid, queries, pick), message regex);
    ``pick(jax_value, port_value)`` chooses the backend's argument."""
    def exp(mod, s, stride=64, limbs=5):
        return mod.expand_table(s, stride=stride, limbs=limbs)

    def tomb(mod, n):
        words = np.zeros((n + 31) // 32, np.uint32)
        return (jnp.asarray(words) if mod is JS
                else TS.tomb_tensor(words, "cpu"))

    def kern(mod):
        return "pallas" if mod is JS else "kernel"

    return [
        ("planes_needs_fast2", lambda m, s, n, q: m.expanded_topk(
            s, exp(m, s, limbs=2), n, q, select="fast3", planes=2),
         "requires select='fast2'"),
        ("planes_min", lambda m, s, n, q: m.expanded_topk(
            s, exp(m, s, limbs=2), n, q, select="fast2", planes=1),
         "planes must be >= 2"),
        ("width_not_multiple", lambda m, s, n, q: m.expanded_topk(
            s, exp(m, s, limbs=2), n, q, select="fast3", planes=5),
         "not a multiple"),
        ("misparsed_planes", lambda m, s, n, q: m.expanded_topk(
            s, exp(m, s), n, q, select="fast2", planes=2),
         "SUPPORTED_STRIDES"),
        ("tomb_unaligned_stride", lambda m, s, n, q: m.expanded_topk(
            s, exp(m, s, stride=16), n, q, select="fast3",
            tomb_bits=tomb(m, s.shape[0])), "stride % 32"),
        ("tomb_with_kernel", lambda m, s, n, q: m.expanded_topk(
            s, exp(m, s), n, q, select=kern(m),
            tomb_bits=tomb(m, s.shape[0])), "tomb_bits is not supported"),
        ("kernel_stride", lambda m, s, n, q: m.expanded_topk(
            s, exp(m, s, stride=32), n, q, select=kern(m)),
         "default stride"),
        ("expand_stride", lambda m, s, n, q: exp(m, s, stride=20),
         "SUPPORTED_STRIDES"),
        ("chunked_stride", lambda m, s, n, q: m.expand_table_chunked(
            s, stride=20), "SUPPORTED_STRIDES"),
    ]


@pytest.mark.parametrize("name,call,msg", _err_cases(),
                         ids=[c[0] for c in _err_cases()])
def test_expanded_topk_value_errors_match_jax(name, call, msg):
    (js, jn, _), (ts, tn, _) = _sorted_pair(_rand_raw(1024, 104))
    q = JK.ids_from_bytes(_rand_raw(4, 105))
    with pytest.raises(ValueError, match=msg):
        call(JS, js, jn, jnp.asarray(q))
    with pytest.raises(ValueError, match=msg):
        call(TS, ts, tn, _keys(q))


def _cascade_cases():
    t2 = _rand_raw(4096, 34)
    t2[:3500, :10] = 0x5A
    q2 = t2[:400].copy()
    q2[:, 15] ^= 0x0F
    t3 = _rand_raw(3072, 4242)
    t3[:4 * 3072 // 5, :12] = t3[0, :12]        # 80 % share 96 bits
    q3 = t3[np.random.default_rng(1).integers(0, 2400, 64)].copy()
    q3[:, 19] ^= np.random.default_rng(2).integers(1, 255, 64,
                                                   dtype=np.uint8)
    return [
        # uniform: stage 1 stride 42, the rescue at 64, k=16
        ("uniform", _rand_raw(8192, 33), _rand_raw(512, 35), 42, 64, 16, 512,
         5, "fast2"),
        # adversarial cluster overflowing a cap of 64
        ("cluster_cap64", t2, q2, 42, 64, 16, 64, 5, "fast2"),
        # every in-cluster query defeats both stages: cap 8 overflows
        ("cap8_overflow", t3, q3, 24, 64, 8, 8, 5, "fast2"),
        ("two_plane", t3, q3, 32, 64, 8, 64, 2, "fast2"),
        ("fast3", t2, q2, 32, 64, 8, 64, 5, "fast3"),
    ]


@pytest.mark.parametrize("case", _cascade_cases(),
                         ids=[c[0] for c in _cascade_cases()])
def test_cascade_topk_matches_jax(case):
    _, raw, q_raw, s1, s2, k, cap, planes, select = case
    (js, jn, jl), (ts, tn, tl) = _sorted_pair(raw)
    q = JK.ids_from_bytes(q_raw)
    for limbs_out in (False, True):
        kw = dict(k=k, cap=cap, planes=planes, select=select,
                  fast2_limbs=limbs_out)
        jout = JS.cascade_topk(
            js, JS.expand_table(js, stride=s1, limbs=planes),
            JS.expand_table(js, stride=s2, limbs=planes), jn,
            jnp.asarray(q), jl, **kw)
        tout = TS.cascade_topk(
            ts, TS.expand_table(ts, stride=s1, limbs=planes),
            TS.expand_table(ts, stride=s2, limbs=planes), tn, _keys(q), tl,
            **kw)
        _out_eq(jout, tout, (case[0], limbs_out))
    if case[0] == "cap8_overflow":
        assert not np.asarray(jout[2]).all()    # rows stay flagged


@pytest.mark.parametrize("select", ["fast2", "fast3"])
def test_lookup_topk_jax_keywords_match_jax(select):
    raw = _rand_raw(2048, 43, cluster=10)
    (js, jn, jl), (ts, tn, tl) = _sorted_pair(raw)
    q = JK.ids_from_bytes(np.concatenate([raw[:24], _rand_raw(24, 44)]))
    je, te = JS.expand_table(js), TS.expand_table(ts)
    want = JS.lookup_topk(js, jn, jnp.asarray(q), k=8, lut=jl, expanded=je,
                          select=select)
    for kw in ({}, {"host_fallback": True}, {"donate_queries": True}):
        got = TS.lookup_topk(ts, tn, _keys(q), k=8, lut=tl, expanded=te,
                             select=select, **kw)
        _out_eq(want, got, kw)
        assert bool(got[2].all())
    # the fallback did run
    assert not np.asarray(JS.expanded_topk(js, je, jn, jnp.asarray(q), k=8,
                                           select=select, lut=jl)[2]).all()


def test_fallback_tile_matches_jax():
    for n_rows, q in ((100, 4), (10_000_000, 64), (10_000_000, 20_000),
                      (10_000_000, 131_072), (3000, 10**6)):
        assert TS._fallback_tile(n_rows, q) == JS._fallback_tile(n_rows, q)
