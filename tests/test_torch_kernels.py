"""The plain torch versions of the port's two CUDA select kernels against
the JAX package's Pallas kernels in interpret mode, bit for bit.

``window_select_plain`` ↔ ``opendht_tpu.ops.pallas_window_topk.window_select``
and ``lex_topk_select_plain`` ↔ ``opendht_tpu.ops.pallas_select.lex_topk_select``
on the same numpy-seeded inputs: every k, bound, exhaustion and
duplicate-id case that chip_smoke.py holds the CUDA kernels to against
these plain versions on the card.  Outputs are integers: the tolerance
is exact equality.  The kernels themselves build and run only on the
card (chip_smoke.py); here the wrappers are checked to take the plain
path for CPU tensors without counting a launch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opendht_tpu.ops.pallas_select import lex_topk_select as jax_lex
from opendht_tpu.ops.pallas_window_topk import window_select as jax_ws
from opendht_tpu_torch.ops import ids as TK
from opendht_tpu_torch.ops.lex_select import (lex_topk_select,
                                               lex_topk_select_plain)
from opendht_tpu_torch.ops.window_select import (window_select,
                                                  window_select_plain)


def _window_inputs(Q, seed):
    """Random window rows with bounds 0, 1, 191, 192 and random, full
    160-bit ties (one id repeated over a query's window) and valid lanes
    whose distance is all-ones."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2**32, size=(Q, 5 * 194), dtype=np.uint32)
    q8 = rng.integers(0, 2**32, size=(Q, 8), dtype=np.uint32)
    b = rng.integers(0, 193, size=Q).astype(np.int32)
    b[:4] = (0, 1, 191, 192)
    planes = rows.reshape(Q, 5, 194)
    planes[4:8] = planes[4:8, :, :1]                 # every lane one id
    planes[8:12, :, 1:40] = planes[8:12, :, 1:2]     # 39-way tie
    b[4:12] = 192
    planes[12:14, :, 1:4] = ~q8[12:14, :5, None]     # all-ones distances
    b[12:14] = (3, 192)
    bounds = np.repeat(b[:, None], 8, axis=1)
    return rows, q8, bounds


@pytest.mark.parametrize("k", [1, 8, 14, 16, 21])
def test_window_select_plain_matches_pallas(k):
    rows, q8, bounds = _window_inputs(96, k)
    want = np.asarray(jax_ws(jnp.asarray(rows), jnp.asarray(q8),
                             jnp.asarray(bounds), k=k, interpret=True))
    got = window_select_plain(TK.to_keys(rows, "cpu"), TK.to_keys(q8, "cpu"),
                              torch.from_numpy(bounds), k=k)
    np.testing.assert_array_equal(TK.from_keys(got[:, :5 * k]),
                                  want[:, :5 * k])
    np.testing.assert_array_equal(got[:, 5 * k:].numpy().view(np.uint32),
                                  want[:, 5 * k:])
    lanes = got[:, 5 * k:6 * k].numpy()
    assert (lanes[0] == 192).all()                   # bound 0: exhausted
    if k > 1:
        assert (lanes[4:8] == np.arange(k)).all()    # ties → smallest lane


def _lex_inputs(Q, W, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 2**32, size=(Q, 5), dtype=np.uint32)
    t = rng.integers(0, 2**32, size=(Q, W, 5), dtype=np.uint32)
    t[:4] = t[:4, :1]                                # duplicate ids
    dist = q[:, None, :] ^ t
    inv = np.zeros((Q, W), np.int32)
    inv[4:8, 5:] = 1                                 # 5 valid, then -1
    inv[8] = 1                                       # nothing valid
    inv[9:12] = rng.integers(0, 2, size=(3, W))
    return dist, inv


@pytest.mark.parametrize("w", [32, 128, 256])
@pytest.mark.parametrize("k", [8, 16])
def test_lex_topk_select_plain_matches_pallas(w, k):
    dist, inv = _lex_inputs(40, w, k * 1000 + w)
    want = np.asarray(jax_lex(jnp.asarray(dist), jnp.asarray(inv), k=k,
                              interpret=True))
    got = lex_topk_select_plain(TK.to_keys(dist, "cpu"),
                                torch.from_numpy(inv), k=k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:4] == np.arange(k)).all()           # ties → smallest position
    assert (got[4:8, 5:] == -1).all() and (got[8] == -1).all()


def test_cpu_wrappers_take_the_plain_path_without_counting():
    rows, q8, bounds = _window_inputs(16, 1)
    args = (TK.to_keys(rows, "cpu"), TK.to_keys(q8, "cpu"),
            torch.from_numpy(bounds))
    n_ws, n_lex = window_select.launches, lex_topk_select.launches
    assert torch.equal(window_select(*args, k=8),
                       window_select_plain(*args, k=8))
    dist, inv = _lex_inputs(16, 64, 2)
    d = TK.to_keys(dist, "cpu")
    i = torch.from_numpy(inv).bool()
    assert torch.equal(lex_topk_select(d, i, k=8),
                       lex_topk_select_plain(d, i, k=8))
    assert (window_select.launches, lex_topk_select.launches) == (n_ws, n_lex)


def test_wrappers_reject_what_the_kernels_do_not_take():
    rows, q8, bounds = _window_inputs(16, 3)
    r, q, b = (TK.to_keys(rows, "cpu"), TK.to_keys(q8, "cpu"),
               torch.from_numpy(bounds))
    with pytest.raises(ValueError, match="128-lane"):
        window_select(r, q, b, k=22)
    with pytest.raises(ValueError, match="rows"):
        window_select(r[:, :900], q, b, k=8)
    with pytest.raises(ValueError, match="bounds"):
        window_select(r, q, b.to(torch.int64), k=8)
    dist, inv = _lex_inputs(16, 32, 4)
    with pytest.raises(ValueError, match="invalid"):
        lex_topk_select(TK.to_keys(dist, "cpu"), torch.zeros(16, 31), k=8)
    with pytest.raises(ValueError, match="W <="):
        lex_topk_select(torch.zeros(2, 1025, 5, dtype=torch.int32),
                        torch.zeros(2, 1025), k=8)
