"""The plain exact k XOR-closest ids: what every closest-node answer of
the node table is held to.

:func:`exact_topk_np` is a copy of ``chip_smoke.py``'s
``exact_topk_np``.  :func:`exact_topk` is the same algorithm in plain
torch, over blocks of targets, so that whole batches of 131,072 targets
over a million ids can be checked on the card once the window has
closed.  The algorithm: sort the ids once; for each target take the
longest prefix p of its limb 0 whose id range (contiguous in sorted
order) still holds at least k ids -- every id outside that range differs
from the target within the first p bits, so it is farther than every id
inside -- then order that range by the full 160-bit distance.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def exact_topk_np(ids: np.ndarray, targets: np.ndarray, k: int) -> np.ndarray:
    """Exact XOR top-k of ``ids`` (uint32 [N,5]) for each target ([Q,5]),
    in numpy.  Returns the ids [Q, min(k, N), 5]."""
    s = ids[np.lexsort(ids.T[::-1])]
    s0 = s[:, 0]
    t0 = targets[:, 0].astype(np.uint64)
    kk = min(k, len(s))
    lo = np.zeros(len(targets), np.int64)
    hi = np.full(len(targets), len(s), np.int64)
    for p in range(1, 33):
        mask = np.uint64((0xFFFFFFFF << (32 - p)) & 0xFFFFFFFF)
        base = (t0 & mask).astype(np.uint32)
        top = (t0 | (~mask & np.uint64(0xFFFFFFFF))).astype(np.uint32)
        plo = np.searchsorted(s0, base, side="left")
        phi = np.searchsorted(s0, top, side="right")
        ok = (phi - plo) >= kk
        lo = np.where(ok, plo, lo)
        hi = np.where(ok, phi, hi)
    out = np.empty((len(targets), kk, 5), np.uint32)
    for i, t in enumerate(targets):
        c = s[lo[i]:hi[i]]
        d = c ^ t
        out[i] = c[np.lexsort((d[:, 4], d[:, 3], d[:, 2], d[:, 1],
                               d[:, 0]))[:kk]]
    return out


def lexsort_rows(x: torch.Tensor) -> torch.Tensor:
    """Permutation that sorts the rows of ``x`` ([n, L] int64)
    lexicographically, column 0 first; equal rows keep their order."""
    perm = torch.arange(x.shape[0], device=x.device)
    for col in range(x.shape[1] - 1, -1, -1):
        perm = perm[torch.sort(x[perm, col], stable=True).indices]
    return perm


def exact_topk(ids_u32: np.ndarray, targets_u32: np.ndarray, k: int,
               device, *, limbs: int = 5,
               block_elems: int = 1 << 24) -> np.ndarray:
    """:func:`exact_topk_np` in torch on ``device``.  ``ids_u32`` must
    hold at least ``k`` ids.  Returns the ids [Q, k, 5] as uint32.
    ``limbs`` below 5 ranks by the top ``limbs`` limbs of the distance
    only, ties in sorted order: the controls' lower precision."""
    ids = torch.from_numpy(ids_u32.astype(np.int64)).to(device)
    s = ids[lexsort_rows(ids)]
    del ids
    n = s.shape[0]
    s0 = s[:, 0].contiguous()
    t = torch.from_numpy(targets_u32.astype(np.int64)).to(device)
    t0 = t[:, 0].contiguous()
    lo = torch.zeros_like(t0)
    hi = torch.full_like(t0, n)
    for p in range(1, 33):
        mask = (M32 << (32 - p)) & M32
        base = t0 & mask
        top = base | (~mask & M32)
        plo = torch.searchsorted(s0, base, side="left")
        phi = torch.searchsorted(s0, top, side="right")
        ok = (phi - plo) >= k
        lo = torch.where(ok, plo, lo)
        hi = torch.where(ok, phi, hi)
    width = hi - lo
    w = int(width.max())
    lanes = torch.arange(w, device=device)
    out = torch.empty((t.shape[0], k, 5), dtype=torch.int64, device=device)
    step = max(1, block_elems // (w * 5))
    for a in range(0, t.shape[0], step):
        b = min(a + step, t.shape[0])
        inside = lanes[None, :] < width[a:b, None]
        pos = torch.clamp(lo[a:b, None] + lanes[None, :], max=n - 1)
        cand = s[pos]                                        # [B, w, 5]
        # distances; lanes outside the range sort after every distance
        d = torch.where(inside[..., None], cand ^ t[a:b, None, :], 1 << 32)
        order = torch.arange(w, device=device).expand(b - a, w)
        for col in range(limbs - 1, -1, -1):
            key = torch.gather(d[..., col], 1, order)
            order = torch.gather(order, 1,
                                 torch.sort(key, dim=1, stable=True).indices)
        out[a:b] = torch.gather(cand, 1, order[:, :k, None].expand(-1, -1, 5))
    return out.cpu().numpy().astype(np.uint32)
