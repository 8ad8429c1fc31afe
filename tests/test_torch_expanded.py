"""Parity of the port's expanded-table lookup (``expanded_topk`` with the
sort, fast3 and kernel selects) with the JAX package, bit for bit.

Same method as tests/test_torch_ops.py: numpy-seeded inputs through the
JAX function (Pallas in interpret mode) and the port on CPU tensors,
where ``"kernel"`` runs the plain version of ``window_select``.  Every
output is an integer array: the tolerance is exact equality.
Geometries follow tests/test_topk.py:327-433.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from opendht_tpu.ops import ids as JK
from opendht_tpu.ops import sorted_table as JS
from opendht_tpu_torch.ops import sorted_table as TS

from test_torch_ops import _keys, _rand_raw, _tables, _triple_eq


_EXP_SELECTS = [("sort", "sort"), ("fast3", "fast3"), ("kernel", "pallas")]


@pytest.mark.parametrize("select,jselect", _EXP_SELECTS)
@pytest.mark.parametrize("bits", [16, 20])
def test_expanded_topk_matches_jax(select, jselect, bits):
    table_raw = _rand_raw(4096, 41)
    table_raw[100] = table_raw[50]            # duplicate id
    q_raw = _rand_raw(64, 42)
    q_raw[1] = table_raw[5]                   # distance-0 case
    valid = np.ones(4096, bool)
    valid[::7] = False
    (js, jn, jl, je), (ts, tn, tl, te) = _tables(table_raw, valid, bits)
    q = JK.ids_from_bytes(q_raw)
    _triple_eq(JS.expanded_topk(js, je, jn, jnp.asarray(q), k=8,
                                select=jselect, lut=jl),
               TS.expanded_topk(ts, te, tn, _keys(q), k=8, select=select,
                                lut=tl), select)


@pytest.mark.parametrize("select,jselect", _EXP_SELECTS)
def test_expanded_topk_clustered_and_ties_match_jax(select, jselect):
    # shared 10-byte prefixes overflow windows; ids sharing their top 64
    # bits exercise fast3's tie check
    table_raw = _rand_raw(2048, 43, cluster=10)
    table_raw[1500:1516, :8] = table_raw[1500, :8]
    table_raw[1600:1900] = table_raw[1600]    # 300 duplicates > one window
    q_raw = np.concatenate([table_raw[:24], table_raw[1500:1508],
                            table_raw[1600:1604]])
    q_raw[:24, 19] ^= 0xFF
    q_raw[24:32, 12] ^= 0x55
    q_raw[33:, 19] ^= 0x01
    (js, jn, jl, je), (ts, tn, tl, te) = _tables(table_raw)
    q = JK.ids_from_bytes(q_raw)
    jout = JS.expanded_topk(js, je, jn, jnp.asarray(q), k=8, select=jselect,
                            lut=jl)
    _triple_eq(jout, TS.expanded_topk(ts, te, tn, _keys(q), k=8,
                                      select=select, lut=tl), select)
    assert not np.asarray(jout[2]).all()


@pytest.mark.parametrize("select,jselect", _EXP_SELECTS)
def test_expanded_topk_small_tables_match_jax(select, jselect):
    for n, nv in [(8, 5), (70, 66), (200, 1)]:
        valid = np.arange(n) < nv
        (js, jn, jl, je), (ts, tn, tl, te) = _tables(_rand_raw(n, 45 + n),
                                                     valid)
        q = JK.ids_from_bytes(_rand_raw(33, 46 + n))
        _triple_eq(JS.expanded_topk(js, je, jn, jnp.asarray(q), k=8,
                                    select=jselect, lut=jl),
                   TS.expanded_topk(ts, te, tn, _keys(q), k=8,
                                    select=select, lut=tl), (n, nv))


@pytest.mark.parametrize("k", [1, 21])
def test_expanded_kernel_select_k_range_matches_jax(k):
    table_raw = _rand_raw(1000, 47)
    (js, jn, _, je), (ts, tn, _, te) = _tables(table_raw)
    q = JK.ids_from_bytes(_rand_raw(40, 48))
    _triple_eq(JS.expanded_topk(js, je, jn, jnp.asarray(q), k=k,
                                select="pallas"),
               TS.expanded_topk(ts, te, tn, _keys(q), k=k, select="kernel"),
               k)
