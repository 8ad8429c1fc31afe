"""Exact batched XOR-distance top-k over key tensors — the oracle and the
exact fallback of the sorted-window lookup.

Same algorithm and ordering as the JAX package's ``ops/xor_topk.py``: the
table is streamed in tiles and a running top-k buffer [Q, k] is merged
with each tile by one lexicographic sort whose keys are, in order, the
invalid flag (valid first), the five distance limbs (closest first) and
the table index (deterministic tie-break for duplicate ids).  That is the
reference's bytewise distance order (``InfoHash::xorCmp``,
include/opendht/infohash.h:179-194).

torch has no multi-key sort, so :func:`lexsort` reproduces the stable
``lax.sort(num_keys=n)`` with one stable ``torch.sort`` pass per key,
from the least to the most significant.  Ties keep their position order,
exactly as the JAX sort does.
"""

from __future__ import annotations

import torch

from .ids import KEY_MAX, N_LIMBS, xor_ids


def lexsort(keys, dim: int = -1) -> torch.Tensor:
    """Permutation that stably sorts along ``dim`` by ``keys`` (same-shape
    tensors, most significant first); ties keep position order."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else torch.gather(key, dim, perm)
        _, p = torch.sort(k, dim=dim, stable=True)
        perm = p if perm is None else torch.gather(perm, dim, p)
    return perm


def gather_rows(table, rows):
    """Row-materializing oracle of ``sorted_table.fused_gather_planar``:
    ``rows`` [...] int → key tensor [..., 5] of table rows, with rows out
    of range (the engine's -1 "absent" included) as the all-ones
    sentinel :func:`mask_invalid` uses."""
    N = table.shape[0]
    ok = (rows >= 0) & (rows < N)
    g = table[rows.clamp(0, N - 1).reshape(-1).long()].reshape(
        tuple(rows.shape) + (N_LIMBS,))
    return torch.where(ok[..., None], g, KEY_MAX)


def select_topk(dist, idx, inv, k: int):
    """Top-k rows of [Q, C] candidates via one lexicographic sort.

    ``dist`` [Q, C, 5] keys, ``idx`` [Q, C] int32, ``inv`` [Q, C] int32.
    Sort keys: invalid flag, 5 distance limbs, table index.  Returns
    (dist [Q,k,5], idx [Q,k], inv [Q,k]), unmasked — apply
    :func:`mask_invalid` at the output boundary.
    """
    limbs = [dist[..., l] for l in range(N_LIMBS)]
    perm = lexsort([inv] + limbs + [idx], dim=1)[:, :k]
    new_dist = torch.stack([torch.gather(d, 1, perm) for d in limbs], dim=-1)
    return new_dist, torch.gather(idx, 1, perm), torch.gather(inv, 1, perm)


def mask_invalid(dist, idx, inv):
    """Canonical sentinels on invalid rows: idx → -1, dist → all-ones."""
    ok = inv == 0
    idx = torch.where(ok, idx, -1)
    dist = torch.where(ok[..., None], dist, KEY_MAX)
    return dist, idx


def xor_topk(queries, table, *, k: int = 8, tile: int = 4096, valid=None):
    """Exact k XOR-closest table rows for each query.

    Args:
      queries: key tensor [Q, 5].
      table:   key tensor [N, 5] (combine with ``valid`` to exclude
               padding/tombstones).
      k:       how many closest to return.
      tile:    table tile size per merge step (results do not depend on it).
      valid:   optional bool [N]; False rows are never returned.

    Returns:
      dist [Q, k, 5] keys of the XOR distances (all-ones where no valid
      entry), idx [Q, k] int32 table rows (-1 where no valid entry).
    """
    dev = queries.device
    Q = queries.shape[0]
    N = table.shape[0]
    if valid is None:
        valid = torch.ones(N, dtype=torch.bool, device=dev)
    tile = max(1, min(tile, N))
    best_dist = torch.full((Q, k, N_LIMBS), KEY_MAX, dtype=torch.int32,
                           device=dev)
    best_idx = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    best_inv = torch.ones((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return best_dist, best_idx
    for t0 in range(0, N, tile):
        t1 = min(N, t0 + tile)
        cand_dist = xor_ids(queries[:, None, :], table[None, t0:t1, :])
        cand_idx = torch.arange(t0, t1, dtype=torch.int32,
                                device=dev).expand(Q, -1)
        cand_inv = (~valid[t0:t1]).to(torch.int32).expand(Q, -1)
        best_dist, best_idx, best_inv = select_topk(
            torch.cat([best_dist, cand_dist], dim=1),
            torch.cat([best_idx, cand_idx], dim=1),
            torch.cat([best_inv, cand_inv], dim=1), k)
    return mask_invalid(best_dist, best_idx, best_inv)


def xor_topk_chunked(queries, table, *, k: int = 8, tile: int = 4096,
                     q_chunk: int = 1024, valid=None):
    """Query-chunked form bounding memory; same result as :func:`xor_topk`."""
    outs = [xor_topk(queries[s:s + q_chunk], table, k=k, tile=tile,
                     valid=valid)
            for s in range(0, max(queries.shape[0], 1), q_chunk)]
    return (torch.cat([o[0] for o in outs], dim=0),
            torch.cat([o[1] for o in outs], dim=0))
