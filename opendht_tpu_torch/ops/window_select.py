"""Fused window top-k select over expanded-table rows — the main path's
kernel.

Hand port of the JAX package's Pallas kernel
``opendht_tpu/ops/pallas_window_topk.py`` ``window_select`` (``_kernel``)
as CUDA for Hopper (``csrc/select_kernels.cu`` ``window_select_kernel``,
one warp per query, built by ``ops/_build.py``).  Given the limb-planar
[Q, 5·194] row each query fetched from the stride-64 expanded table, it
XORs the 192 window lanes with the query, sets lanes at or past the
query's bound to all-ones, and extracts the k lexicographically smallest
distances by progressive-mask min-extraction: the minimum of limb 0 over
the remaining lanes, then limbs 1..4 over the lanes still tied, then the
smallest lane among full 160-bit ties.  A ``rem`` mask keeps an extracted
winner from coming back; an exhausted slot reports lane 192, which the
caller turns into -1 (``sorted_table.expanded_select``).

Contract (the JAX kernel's packed layout, in the port's key domain):

  rows     int32 [Q, 970] id keys (``ops/ids.py``), limb-planar
  queries8 int32 [Q, 8]   query keys in cols 0..4 (cols 5..7 ignored)
  bounds   int32 [Q, 8]   col 0 = valid window lanes, in [0, 192]
  → int32 [Q, 128]: cols [l·k, (l+1)·k) = key of distance limb l of the
    winners, cols [5k, 6k) = their local lane (192 = none), the rest 0.

k ≤ 21 (six k-wide column groups fit 128 lanes); stride 64 only.

What bounds it on the card: it reads 3.9 KB per query and writes 512 B;
the compare/min work is about k·6·192 operations per query, so it is
meant to be bound by memory traffic.  Its design keeps every candidate
in registers (6 lanes per thread) and every cross-lane minimum is one
warp reduction, so the window is read once from device memory.
"""

from __future__ import annotations

import torch

from . import _build
from .ids import FLIP, KEY_MAX, N_LIMBS

EROW = 194          # lanes per limb plane (left nbr + 192 window + right nbr)
WIN = 192
OUT_LANES = 128


def _check(rows, queries8, bounds, k):
    if k < 1 or k * (N_LIMBS + 1) > OUT_LANES:
        raise ValueError(f"k={k} does not fit the packed 128-lane output")
    Q = rows.shape[0]
    for name, t, cols in (("rows", rows, N_LIMBS * EROW),
                          ("queries8", queries8, 8), ("bounds", bounds, 8)):
        if t.dtype != torch.int32 or tuple(t.shape) != (Q, cols):
            raise ValueError(f"{name}: want int32 [{Q}, {cols}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != rows.device:
            raise ValueError(f"{name} is on {t.device}, rows on {rows.device}")


def window_select(rows, queries8, bounds, *, k: int = 16) -> torch.Tensor:
    """Exact top-k over limb-planar window rows (contract above).  On a
    CPU tensor it runs :func:`window_select_plain`; on a CUDA tensor it
    launches the kernel or raises."""
    _check(rows, queries8, bounds, k)
    if rows.device.type == "cpu":
        return window_select_plain(rows, queries8, bounds, k=k)
    if rows.device.type != "cuda":
        raise ValueError(f"window_select: unsupported device {rows.device}")
    rows, queries8, bounds = (t.contiguous() for t in (rows, queries8, bounds))
    out = torch.empty((rows.shape[0], OUT_LANES), dtype=torch.int32,
                      device=rows.device)
    fn = _build.function("select_kernels", "window_select_launch", 4, 2)
    with torch.cuda.device(rows.device):
        err = fn(rows.data_ptr(), queries8.data_ptr(), bounds.data_ptr(),
                 out.data_ptr(), rows.shape[0], k,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "window_select")
    window_select.launches += 1
    return out


window_select.launches = 0


def window_select_plain(rows, queries8, bounds, *, k: int = 16):
    """The same function in torch ops (the CPU path, and the reference the
    kernel is held to on the card)."""
    _check(rows, queries8, bounds, k)
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
