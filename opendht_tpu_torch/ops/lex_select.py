"""Exact lexicographic top-k select over window distances — the select of
the unexpanded ``window_topk`` route.

Hand port of the JAX package's Pallas kernel
``opendht_tpu/ops/pallas_select.py`` ``lex_topk_select``
(``_select_kernel``) as CUDA for Hopper (``csrc/select_kernels.cu``
``lex_select_kernel``, one warp per query, ``W ≤ 1024``).  Per rank it
takes the live candidate smallest in the order (limb 0, …, limb 4,
window position) and retires it.  Exact by construction, so it needs no
certificate of its own.

Contract:

  dist    int32 [Q, W, 5] keys of the XOR distances (``ops/ids.py``)
  invalid bool or int [Q, W]; nonzero positions are never selected
  → int32 [Q, k] window positions, -1 once the valid positions run out.

What bounds it on the card: device memory.  It reads 24 B per candidate
(five limbs and the invalid flag) once and writes 4·k B per query.  Each
warp reads its query's W·5 contiguous words with coalesced loads through
a small shared-memory stage, keeps W/32 candidates per thread in
registers as sorted (limb 0, position) keys, and takes each rank with
the select core shared with ``window_select``: one warp reduction, two
ballots and a register shift per rank.
"""

from __future__ import annotations

import torch

from . import _build
from .ids import KEY_MAX, N_LIMBS

MAX_W = 1024


def _check(dist, invalid, k):
    if dist.dtype != torch.int32 or dist.dim() != 3 \
            or dist.shape[2] != N_LIMBS:
        raise ValueError(f"dist: want int32 [Q, W, {N_LIMBS}], got "
                         f"{dist.dtype} {tuple(dist.shape)}")
    if tuple(invalid.shape) != tuple(dist.shape[:2]):
        raise ValueError(f"invalid: want {tuple(dist.shape[:2])}, got "
                         f"{tuple(invalid.shape)}")
    if invalid.device != dist.device:
        raise ValueError(f"invalid is on {invalid.device}, dist on "
                         f"{dist.device}")
    if not 1 <= dist.shape[1] <= MAX_W or k < 1:
        raise ValueError(f"need 1 <= W <= {MAX_W} and k >= 1, got "
                         f"W={dist.shape[1]} k={k}")


def lex_topk_select(dist, invalid, *, k: int = 8) -> torch.Tensor:
    """Exact lexicographic top-k window positions per query (contract
    above).  On a CPU tensor it runs :func:`lex_topk_select_plain`; on a
    CUDA tensor it launches the kernel or raises."""
    _check(dist, invalid, k)
    if dist.device.type == "cpu":
        return lex_topk_select_plain(dist, invalid, k=k)
    if dist.device.type != "cuda":
        raise ValueError(f"lex_topk_select: unsupported device {dist.device}")
    Q, W, _ = dist.shape
    dist = dist.contiguous()
    inv = invalid.to(torch.int32).contiguous()
    out = torch.empty((Q, k), dtype=torch.int32, device=dist.device)
    fn = _build.function("select_kernels", "lex_topk_select_launch", 3, 3)
    with torch.cuda.device(dist.device):
        err = fn(dist.data_ptr(), inv.data_ptr(), out.data_ptr(), Q, W, k,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lex_topk_select")
    lex_topk_select.launches += 1
    return out


lex_topk_select.launches = 0


def lex_topk_select_plain(dist, invalid, *, k: int = 8) -> torch.Tensor:
    """The same function in torch ops (the CPU path, and the reference the
    kernel is held to on the card)."""
    _check(dist, invalid, k)
    Q, W, _ = dist.shape
    pos = torch.arange(W, dtype=torch.int32, device=dist.device)[None, :]
    alive = invalid == 0
    out = torch.full((Q, k), -1, dtype=torch.int32, device=dist.device)
    if Q == 0:
        return out
    for kk in range(k):
        cand = alive
        for i in range(N_LIMBS):
            di = dist[:, :, i]
            m = torch.where(cand, di, KEY_MAX).amin(dim=1, keepdim=True)
            cand = cand & (di == m)
        j = torch.where(cand, pos, W).amin(dim=1)
        out[:, kk] = torch.where(j < W, j, -1)
        alive = alive & (pos != j[:, None])
    return out
