"""Fused window top-k select over the expanded table — the main path's
kernel.

Hand port of the JAX package's Pallas kernel
``opendht_tpu/ops/pallas_window_topk.py`` ``window_select`` (``_kernel``)
as CUDA for Hopper (``csrc/select_kernels.cu`` ``window_select_kernel``,
one warp per query, built by ``ops/_build.py``).  Query q reads row
``row_index[q]`` of the limb-planar stride-64 expanded table where it
lies, XORs the 192 window lanes with the query, leaves lanes at or past
the query's bound out, and extracts the k lexicographically smallest
distances in the order (limb 0, …, limb 4, lane).  An exhausted slot
reports lane 192, which the caller turns into -1
(``sorted_table.expanded_select``).

Contract (the JAX kernel's packed layout, in the port's key domain):

  expanded  int32 [NB, 970] id keys (``ops/ids.py``), limb-planar rows
  queries8  int32 [Q, 8]   query keys in cols 0..4 (cols 5..7 ignored)
  bounds    int32 [Q, 8]   col 0 = valid window lanes, in [0, 192]
  row_index int32 [Q]      row of ``expanded`` each query reads, in
            [0, NB); None = row q (then NB == Q, the JAX kernel's
            contract on gathered rows)
  → int32 [Q, 128]: cols [l·k, (l+1)·k) = key of distance limb l of the
    winners, cols [5k, 6k) = their local lane (192 = none), the rest 0.

k ≤ 21 (six k-wide column groups fit 128 lanes); stride 64 only.

What bounds it on the card: its byte bound is the expanded table read
once plus 580 B per query, but at k=16 the k rounds are bound by
instruction issue (``PERF.md``).  The TPU kernel needed the rows
gathered first (Mosaic's aligned-slice rule,
``opendht_tpu/ops/sorted_table.py:32-42``); here the warp reads the row
in place, so no [Q, 970] temporary is written and read back.  Each lane
sorts its six candidates once by limb 0, and a round costs one warp
reduction, two ballots and a register shift (the select core in the
source); limbs 1..4 are read only on ties and for the k winners.
"""

from __future__ import annotations

import torch

from . import _build
from .ids import FLIP, KEY_MAX, N_LIMBS

EROW = 194          # lanes per limb plane (left nbr + 192 window + right nbr)
WIN = 192
OUT_LANES = 128


def _check(expanded, queries8, bounds, k, row_index):
    if k < 1 or k * (N_LIMBS + 1) > OUT_LANES:
        raise ValueError(f"k={k} does not fit the packed 128-lane output")
    Q = queries8.shape[0]
    NB = expanded.shape[0] if row_index is not None else Q
    for name, t, shape in (("expanded rows", expanded,
                            (NB, N_LIMBS * EROW)),
                           ("queries8", queries8, (Q, 8)),
                           ("bounds", bounds, (Q, 8)),
                           ("row_index", row_index, (Q,))):
        if t is None:
            continue
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want int32 {list(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != expanded.device:
            raise ValueError(f"{name} is on {t.device}, expanded on "
                             f"{expanded.device}")


def window_select(expanded, queries8, bounds, *, k: int = 16,
                  row_index=None) -> torch.Tensor:
    """Exact top-k over window rows of ``expanded`` (contract above).  On
    a CPU tensor it runs :func:`window_select_plain`; on a CUDA tensor it
    launches the kernel or raises."""
    _check(expanded, queries8, bounds, k, row_index)
    if expanded.device.type == "cpu":
        return window_select_plain(expanded, queries8, bounds, k=k,
                                   row_index=row_index)
    if expanded.device.type != "cuda":
        raise ValueError(f"window_select: unsupported device "
                         f"{expanded.device}")
    expanded, queries8, bounds = (t.contiguous()
                                  for t in (expanded, queries8, bounds))
    if row_index is not None:
        row_index = row_index.contiguous()   # held until the launch
    Q = queries8.shape[0]
    out = torch.empty((Q, OUT_LANES), dtype=torch.int32,
                      device=expanded.device)
    fn = _build.function("select_kernels", "window_select_launch", 5, 2)
    with torch.cuda.device(expanded.device):
        err = fn(expanded.data_ptr(),
                 0 if row_index is None else row_index.data_ptr(),
                 queries8.data_ptr(), bounds.data_ptr(), out.data_ptr(), Q, k,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "window_select")
    window_select.launches += 1
    return out


window_select.launches = 0


def window_select_plain(expanded, queries8, bounds, *, k: int = 16,
                        row_index=None):
    """The same function in torch ops on gathered rows
    ``expanded[row_index]`` (the CPU path, and the reference the kernel is
    held to on the card)."""
    _check(expanded, queries8, bounds, k, row_index)
    rows = expanded if row_index is None else expanded[row_index.long()]
    Q = rows.shape[0]
    iota = torch.arange(WIN, dtype=torch.int32, device=rows.device)[None, :]
    valid = iota < bounds[:, 0:1]
    d = []
    for l in range(N_LIMBS):
        w = rows[:, l * EROW + 1: l * EROW + 1 + WIN]
        d.append(torch.where(valid, w ^ queries8[:, l:l + 1] ^ FLIP, KEY_MAX))
    out = torch.zeros((Q, OUT_LANES), dtype=torch.int32, device=rows.device)
    if Q == 0:
        return out
    rem = valid
    for r in range(k):
        t = rem
        for l in range(N_LIMBS):
            m = torch.where(t, d[l], KEY_MAX).amin(dim=1, keepdim=True)
            t = t & (d[l] == m)
            out[:, l * k + r] = m[:, 0]
        wl = torch.where(t, iota, WIN).amin(dim=1, keepdim=True)
        out[:, N_LIMBS * k + r] = wl[:, 0]
        rem = rem & (iota != wl)
    return out
