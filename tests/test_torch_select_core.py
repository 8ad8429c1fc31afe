"""A numpy model of the CUDA select core (``csrc/select_kernels.cu``
``select_round``), held bit for bit to the plain torch versions of both
kernels on the edge inputs ``chip_smoke.py`` gives the kernels on the
card.

The model runs the warp algorithm step by step: 32 lanes, each with its
candidates (position lane + 32·i) as (limb 0, position) keys sorted once,
so a lane's head is its local best on limb 0; per round one minimum over
the heads and two ballots (the lanes whose head holds it, and those
whose next candidate holds it too); with one such lane and no second
candidate the lane wins and pops its head.  Otherwise (ties on limb 0)
each tied lane finds its exact best among its candidates at that limb 0,
the lanes narrow through limbs 1..4 and then the position, and the
winner moves its candidate to its head before the pop.  No live
candidate is a count, not an all-ones distance.  Outputs are integers:
the tolerance is exact equality.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from opendht_tpu_torch.ops import ids as TK
from opendht_tpu_torch.ops.lex_select import lex_topk_select_plain
from opendht_tpu_torch.ops.window_select import window_select_plain

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LANES = 32
NONE = np.uint32(0xFFFFFFFF)
SIGN = np.uint32(0x80000000)
NO_POS = np.int64(2**32 - 1)


def _rare_round(dist, d0, pos, n, q, m0):
    """Ties on limb 0 in query q: the exact winner lane, with its
    candidate moved to slot 0."""
    tied = [lane for lane in range(LANES) if n[q, lane] > 0
            and d0[q, lane, 0] == m0]
    best = {}
    for lane in tied:                      # each lane's own exact best
        slots = [i for i in range(n[q, lane]) if d0[q, lane, i] == m0]
        best[lane] = min(slots, key=lambda i: (
            tuple(dist[q, pos[q, lane, i], 1:]), pos[q, lane, i]))
    for l in range(1, 5):                  # narrow across the lanes
        if len(tied) == 1:
            break
        m = min(dist[q, pos[q, lane, best[lane]], l] for lane in tied)
        tied = [lane for lane in tied
                if dist[q, pos[q, lane, best[lane]], l] == m]
    w = min(tied, key=lambda lane: pos[q, lane, best[lane]])
    i = best[w]
    d0[q, w, [0, i]] = d0[q, w, [i, 0]]
    pos[q, w, [0, i]] = pos[q, w, [i, 0]]
    return w


def warp_select(dist, live, k):
    """dist [Q, P, 5] uint32 raw distances by position (P = 32·NPT),
    live [Q, P] bool.  Returns (pos [Q,k] winners' positions or -1,
    rare = rounds that tied on limb 0)."""
    Q, P, _ = dist.shape
    npt = P // LANES
    # slot i of lane holds position lane + 32·i, then each lane sorts
    p = np.arange(P).reshape(npt, LANES).T[None].repeat(Q, 0)   # [Q,32,NPT]
    lv = live[np.arange(Q)[:, None, None], p]
    d0 = np.where(lv, dist[np.arange(Q)[:, None, None], p, 0], NONE)
    pos = np.where(lv, p, NO_POS)
    order = np.lexsort((pos, d0), axis=-1)
    d0 = np.take_along_axis(d0, order, -1)
    pos = np.take_along_axis(pos, order, -1)
    n = lv.sum(-1)
    out = np.full((Q, k), -1, np.int64)
    rare = 0
    for r in range(k):
        has = n > 0
        h0 = np.where(has, d0[..., 0], NONE)
        m0 = h0.min(1)                                  # __reduce_min_sync
        inn = has & (h0 == m0[:, None])                 # __ballot_sync
        dup = inn & (n > 1) & (d0[..., min(1, npt - 1)] == m0[:, None])
        w = inn.argmax(1)
        for q in np.nonzero((inn.sum(1) > 1) | dup.any(1))[0]:
            w[q] = _rare_round(dist, d0, pos, n, q, m0[q])
            rare += 1
        q = np.nonzero(inn.any(1))[0]
        wq = w[q]
        out[q, r] = pos[q, wq, 0]
        d0[q, wq] = np.concatenate([d0[q, wq, 1:],
                                    np.full((len(q), 1), NONE)], -1)
        pos[q, wq] = np.concatenate([pos[q, wq, 1:],
                                     np.full((len(q), 1), NO_POS)], -1)
        n[q, wq] -= 1                                   # the winner pops
    return out, rare


def model_window_select(rows, q8, bounds, k):
    """The model on window rows (uint32 numpy), in window_select's packed
    key layout (int32 [Q, 128]); the winners' limbs are read back from
    the rows, as the kernel does."""
    Q = rows.shape[0]
    win = rows.reshape(Q, 5, 194)[:, :, 1:193].transpose(0, 2, 1)
    dist = win ^ q8[:, None, :5]                     # [Q, 192, 5]
    live = np.arange(192)[None, :] < bounds[:, :1]
    pos, rare = warp_select(dist, live, k)
    limbs = np.where(pos[..., None] >= 0,
                     np.take_along_axis(dist, pos.clip(0)[..., None], 1),
                     NONE)                           # [Q, k, 5]
    out = np.zeros((Q, 128), np.uint32)
    out[:, :5 * k] = (limbs ^ SIGN).transpose(0, 2, 1).reshape(Q, 5 * k)
    out[:, 5 * k:6 * k] = np.where(pos < 0, 192, pos)
    return out.view(np.int32), rare


def model_lex_select(dist, inv, k):
    """The model on [Q, W, 5] uint32 distances and an invalid mask."""
    Q, W, _ = dist.shape
    pad = -W % LANES
    d = np.concatenate([dist, np.full((Q, pad, 5), NONE, np.uint32)], 1)
    live = np.concatenate([inv == 0, np.zeros((Q, pad), bool)], 1)
    pos, rare = warp_select(d, live, k)
    return pos.astype(np.int32), rare


def _plain_window(rows, q8, bounds, k, row_index=None):
    ri = None if row_index is None else torch.from_numpy(row_index)
    return window_select_plain(TK.to_keys(rows, "cpu"),
                               TK.to_keys(q8, "cpu"),
                               torch.from_numpy(bounds), k=k,
                               row_index=ri).numpy()


@pytest.mark.parametrize("k", [1, 8, 14, 16, 21])
def test_model_matches_window_select_plain_on_edge_rows(k):
    rows, q8, bounds = chip_smoke.edge_window_inputs(
        np.random.default_rng(k), 512)
    got, rare = model_window_select(rows, q8, bounds, k)
    np.testing.assert_array_equal(got, _plain_window(rows, q8, bounds, k))
    if k > 1:
        assert rare > 0          # the full-tie rows take the rare path


@pytest.mark.parametrize("k", [1, 8, 16, 21])
def test_model_matches_window_select_plain_with_a_row_index(k):
    rng = np.random.default_rng(100 + k)
    rows, q8_rows, b_rows = chip_smoke.edge_window_inputs(rng, 512)
    ri, q8, bounds = chip_smoke.row_index_inputs(rng, q8_rows, b_rows, 1024)
    got, _ = model_window_select(rows[ri], q8, bounds, k)
    np.testing.assert_array_equal(
        got, _plain_window(rows, q8, bounds, k, row_index=ri))


@pytest.mark.parametrize("w", [32, 128, 256, 1024])
@pytest.mark.parametrize("k", [8, 16])
def test_model_matches_lex_topk_select_plain_on_edge_windows(w, k):
    dist, inv = chip_smoke.edge_lex_inputs(np.random.default_rng(w + k),
                                           384, w)
    got, rare = model_lex_select(dist, inv, k)
    want = lex_topk_select_plain(TK.to_keys(dist, "cpu"),
                                 torch.from_numpy(inv), k=k).numpy()
    np.testing.assert_array_equal(got, want)
    assert rare > 0              # duplicate ids tie on every limb
    assert (got[128:160] == -1).all()          # nothing valid
    assert (got[64:128, 5:] == -1).all()       # exhaustion after 5


def test_model_exhaustion_is_a_flag_not_an_all_ones_distance():
    """Valid lanes at an all-ones distance beat exhausted lanes, and an
    exhausted warp reports lane 192 with all-ones limbs."""
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 2**32, size=(3, 5 * 194), dtype=np.uint32)
    q8 = rng.integers(0, 2**32, size=(3, 8), dtype=np.uint32)
    planes = rows.reshape(3, 5, 194)
    planes[:, :, 1:4] = ~q8[:, :5, None]            # lanes 0..2 all-ones
    bounds = np.repeat(np.array([[3], [0], [1]], np.int32), 8, axis=1)
    got, _ = model_window_select(rows, q8, bounds, 4)
    np.testing.assert_array_equal(got, _plain_window(rows, q8, bounds, 4))
    lanes = got[:, 20:24]
    assert lanes[0].tolist() == [0, 1, 2, 192]
    assert lanes[1].tolist() == [192] * 4
    assert lanes[2].tolist() == [0, 192, 192, 192]
    assert (got[0, :3] == np.int32(0x7FFFFFFF)).all()


def test_model_rarely_narrows_on_uniform_ids():
    """On uniform random distances no two lanes share a limb 0, so every
    round is one minimum and one ballot."""
    rng = np.random.default_rng(8)
    rows = rng.integers(0, 2**32, size=(256, 5 * 194), dtype=np.uint32)
    q8 = rng.integers(0, 2**32, size=(256, 8), dtype=np.uint32)
    bounds = np.full((256, 8), 192, np.int32)
    got, rare = model_window_select(rows, q8, bounds, 16)
    np.testing.assert_array_equal(got, _plain_window(rows, q8, bounds, 16))
    assert rare == 0
