"""The fused window_select contract (``row_index``) and the expanded
route that feeds it, against the JAX package, bit for bit.

``window_select_plain(expanded, …, row_index=j)`` is held to JAX's
``window_select(expanded[j], …, interpret=True)``; ``expanded_topk`` with
``select="kernel"`` on CPU tensors (which reaches the plain version) to
JAX's ``expanded_topk(select="pallas")`` with the same certificate at the
``tests/test_topk.py:327-433`` geometries; the 10-column certificate
neighbour gather to the lanes of the gathered rows.  Outputs are
integers: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opendht_tpu.ops import ids as JK
from opendht_tpu.ops import sorted_table as JS
from opendht_tpu.ops.pallas_window_topk import window_select as jax_ws
from opendht_tpu_torch.ops import ids as TK
from opendht_tpu_torch.ops import sorted_table as TS
from opendht_tpu_torch.ops.window_select import (window_select,
                                                  window_select_plain)

from test_torch_kernels import _window_inputs
from test_torch_ops import _keys, _rand_raw, _tables, _triple_eq

NB, Q = 48, 96


def _row_index(kind, rng):
    if kind == "random":
        return rng.integers(0, NB, size=Q).astype(np.int32)
    if kind == "repeated":                  # most queries on a few rows
        ri = rng.integers(0, NB, size=Q).astype(np.int32)
        ri[:64] = 5                         # a full-tie row
        ri[64:80] = 13
        return ri
    return np.where(np.arange(Q) % 2 == 0, 0, NB - 1).astype(np.int32)


def _query_inputs(rng):
    q8 = rng.integers(0, 2**32, size=(Q, 8), dtype=np.uint32)
    b = rng.integers(0, 193, size=Q).astype(np.int32)
    b[:4] = (0, 1, 191, 192)
    return q8, np.repeat(b[:, None], 8, axis=1)


@pytest.mark.parametrize("kind", ["random", "repeated", "first_last"])
@pytest.mark.parametrize("k", [1, 8, 16, 21])
def test_window_select_plain_with_row_index_matches_pallas(kind, k):
    rng = np.random.default_rng(k * 10 + len(kind))
    expanded, q8_rows, _ = _window_inputs(NB, k)
    ri = _row_index(kind, rng)
    q8, bounds = _query_inputs(rng)
    q8[80:88] = q8_rows[ri[80:88]]          # rows' own queries: all-ones
    want = np.asarray(jax_ws(jnp.asarray(expanded[ri]), jnp.asarray(q8),
                             jnp.asarray(bounds), k=k, interpret=True))
    got = window_select_plain(TK.to_keys(expanded, "cpu"),
                              TK.to_keys(q8, "cpu"), torch.from_numpy(bounds),
                              k=k, row_index=torch.from_numpy(ri))
    np.testing.assert_array_equal(TK.from_keys(got[:, :5 * k]),
                                  want[:, :5 * k])
    np.testing.assert_array_equal(got[:, 5 * k:].numpy().view(np.uint32),
                                  want[:, 5 * k:])


@pytest.mark.parametrize("stride", [8, 16, 64, 128])
def test_certificate_neighbours_are_the_rows_edge_lanes(stride):
    ids = JK.ids_from_bytes(_rand_raw(1000, stride))
    ts, _, _ = TS.sort_table(_keys(ids))
    expanded = TS.expand_table(ts, stride=stride)
    erow = 3 * stride + 2
    j = torch.from_numpy(np.random.default_rng(stride).integers(
        0, expanded.shape[0], size=200).astype(np.int32))
    j[:2] = torch.tensor([0, expanded.shape[0] - 1], dtype=torch.int32)
    left, right = TS.certificate_neighbours(expanded, j)
    rows = expanded[j.long()]
    assert torch.equal(left, rows[:, 0::erow])
    assert torch.equal(right, rows[:, erow - 1::erow])


@pytest.mark.parametrize("k", [14, 16])
@pytest.mark.parametrize("bits", [16, 20])
def test_expanded_topk_kernel_matches_pallas(k, bits):
    table_raw = _rand_raw(4096, 41)
    table_raw[100] = table_raw[50]            # duplicate id
    q_raw = _rand_raw(64, 42)
    q_raw[1] = table_raw[5]                   # distance-0 case
    valid = np.ones(4096, bool)
    valid[::7] = False
    (js, jn, jl, je), (ts, tn, tl, te) = _tables(table_raw, valid, bits)
    q = JK.ids_from_bytes(q_raw)
    _triple_eq(JS.expanded_topk(js, je, jn, jnp.asarray(q), k=k,
                                select="pallas", lut=jl),
               TS.expanded_topk(ts, te, tn, _keys(q), k=k, select="kernel",
                                lut=tl), (k, bits))


@pytest.mark.parametrize("k", [14, 16])
def test_expanded_topk_kernel_clustered_matches_pallas(k):
    table_raw = _rand_raw(2048, 43, cluster=10)
    table_raw[1500:1516, :8] = table_raw[1500, :8]
    table_raw[1600:1900] = table_raw[1600]    # 300 duplicates > one window
    q_raw = np.concatenate([table_raw[:24], table_raw[1500:1508],
                            table_raw[1600:1604]])
    q_raw[:24, 19] ^= 0xFF
    q_raw[24:32, 12] ^= 0x55
    (js, jn, jl, je), (ts, tn, tl, te) = _tables(table_raw)
    q = JK.ids_from_bytes(q_raw)
    jout = JS.expanded_topk(js, je, jn, jnp.asarray(q), k=k, select="pallas",
                            lut=jl)
    _triple_eq(jout, TS.expanded_topk(ts, te, tn, _keys(q), k=k,
                                      select="kernel", lut=tl), k)
    assert not np.asarray(jout[2]).all()


def test_expanded_topk_kernel_small_tables_match_pallas():
    for n, nv in [(8, 5), (64, 64), (70, 66), (200, 1)]:
        valid = np.arange(n) < nv
        (js, jn, jl, je), (ts, tn, tl, te) = _tables(_rand_raw(n, 45 + n),
                                                     valid)
        q = JK.ids_from_bytes(_rand_raw(33, 46 + n))
        _triple_eq(JS.expanded_topk(js, je, jn, jnp.asarray(q), k=16,
                                    select="pallas", lut=jl),
                   TS.expanded_topk(ts, te, tn, _keys(q), k=16,
                                    select="kernel", lut=tl), (n, nv))


def test_kernel_route_hands_the_table_and_rows_to_window_select(monkeypatch):
    """The kernel select gets the expanded table itself and each query's
    row index, never gathered rows."""
    (_, _, _, _), (ts, tn, tl, te) = _tables(_rand_raw(3000, 49))
    q = _keys(JK.ids_from_bytes(_rand_raw(40, 50)))
    seen = []

    def spy(expanded, queries8, bounds, *, k, row_index=None):
        seen.append((expanded, row_index))
        return window_select(expanded, queries8, bounds, k=k,
                             row_index=row_index)

    monkeypatch.setattr(TS, "window_select", spy)
    TS.expanded_topk(ts, te, tn, q, k=8, select="kernel", lut=tl)
    j, start = TS.expanded_window(ts, te, tn, q, lut=tl)
    (expanded, ri), = seen
    assert expanded is te
    assert ri.dtype == torch.int32 and torch.equal(ri, j)
    assert torch.equal(start, j * TS.EXPAND_STRIDE)


def test_cpu_wrapper_with_row_index_runs_the_plain_version_uncounted():
    rng = np.random.default_rng(51)
    expanded, _, _ = _window_inputs(NB, 51)
    q8, bounds = _query_inputs(rng)
    args = (TK.to_keys(expanded, "cpu"), TK.to_keys(q8, "cpu"),
            torch.from_numpy(bounds))
    ri = torch.from_numpy(_row_index("repeated", rng))
    n = window_select.launches
    assert torch.equal(window_select(*args, k=8, row_index=ri),
                       window_select_plain(*args, k=8, row_index=ri))
    assert window_select.launches == n


def test_window_select_rejects_a_bad_row_index():
    expanded, _, _ = _window_inputs(NB, 52)
    q8, bounds = _query_inputs(np.random.default_rng(52))
    args = (TK.to_keys(expanded, "cpu"), TK.to_keys(q8, "cpu"),
            torch.from_numpy(bounds))
    ri = np.zeros(Q, np.int32)
    with pytest.raises(ValueError, match="row_index"):
        window_select(*args, k=8, row_index=torch.from_numpy(ri[:-1]))
    with pytest.raises(ValueError, match="row_index"):
        window_select(*args, k=8, row_index=torch.from_numpy(ri).long())
    with pytest.raises(ValueError, match="expanded rows"):
        window_select(args[0][:, :900], *args[1:], k=8,
                      row_index=torch.from_numpy(ri))
