"""The plain iterative-lookup model: what every lookup of a search wave is
held to.

Written from the model that ``core/search.py`` documents, in plain torch
over int64 values of the unsigned 32-bit limbs; it imports nothing of the
program.  The counter hash (:func:`mix32`, :func:`mul32`) is a frozen
copy of the program's arithmetic, since the replies are defined by it.

The model, for a wave of Q lookups over n sorted ids (a node is its
sorted row):

- Every lookup keeps at most ``search_nodes`` candidates, ordered by
  (the top ``rank_limbs`` limbs of the XOR distance to its target, row),
  each marked queried or not.  A node appears once; merged copies keep
  "queried" if any copy has it.
- Round 0 asks one bootstrap node, ``mix32(qidx ^ seed) % n``.  Each
  later round asks the first ``alpha`` unqueried candidates of every
  lookup that is not done.  A lookup is done once its first
  min(k, #candidates) candidates are all queried, or nothing is left to
  ask; a round in which it asks someone costs it a hop.  The wave stops
  after ``max_hops`` rounds.
- Node x, asked in round r as the a-th request of lookup q, answers with
  k rows.  With b the common leading bits of x and the target in limb 0
  (32 when equal), the block is the sorted rows sharing the target's top
  min(b + 1, lut_bits) bits.  Reply j is ``lo + mix32(counter) % size``
  for a block of at least k rows, where counter =
  ((((r * Q + q) * alpha + a) * k + j) mod 2^32) ^ seed; a smaller block
  gives row ``clamp(clamp(pos - alpha*k/2, 0, n - alpha*k) + a*k + j, 0,
  n - 1)``, pos being the target's lower bound.
- The answer of a lookup: its first k candidates' rows (-1 when absent),
  their full distances (all ones when absent), its hops, and whether it
  converged (the done rule's first clause at the end).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32), in 16-bit halves of c so
    that no product leaves the int64 range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = x & M32
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zero bits of 32-bit values in int64 (32 for 0)."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        top = x < (1 << (32 - s))
        n = n + torch.where(top, s, 0)
        x = torch.where(top, x << s, x)
    return torch.where(x == 0, 32, n)


def lower_bound(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """First row of the sorted ids ``s`` [n, 5] not less than each target
    of ``t`` [Q, 5] (a binary search on whole ids)."""
    n = s.shape[0]
    lo = torch.zeros(t.shape[0], dtype=torch.int64, device=t.device)
    hi = torch.full_like(lo, n)
    for _ in range(max(1, n).bit_length() + 1):
        mid = (lo + hi) // 2
        row = s[mid.clamp(max=n - 1)]
        less = torch.zeros_like(lo, dtype=torch.bool)
        eq = torch.ones_like(less)
        for col in range(5):
            less = less | (eq & (row[:, col] < t[:, col]))
            eq = eq & (row[:, col] == t[:, col])
        active = lo < hi
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


def prefix_table(s: torch.Tensor, bits: int) -> torch.Tensor:
    """[2^bits + 1]: entry p counts the ids whose top ``bits`` bits are
    below p."""
    counts = torch.bincount(s[:, 0] >> (32 - bits), minlength=1 << bits)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])


def _stable_order(keys, width: int, rows: int, device) -> torch.Tensor:
    """Column order that sorts each row by ``keys`` (most significant
    first), ties kept in column order."""
    order = torch.arange(width, device=device).expand(rows, width)
    for key in reversed(keys):
        k = torch.gather(key, 1, order)
        order = torch.gather(order, 1,
                             torch.sort(k, dim=1, stable=True).indices)
    return order


def lookups(s: torch.Tensor, table: torch.Tensor, lut_bits: int,
            targets: torch.Tensor, seed: int, *, alpha: int, k: int,
            search_nodes: int, max_hops: int, rank_limbs: int) -> dict:
    """Run a wave of the model.  ``s``: sorted ids [n, 5] int64;
    ``table``: :func:`prefix_table` of ``s``; ``targets`` [Q, 5] int64,
    lookup q being the wave's q-th.  Returns int64 ``nodes`` [Q, k],
    ``dist`` [Q, k, 5], ``hops`` [Q] and bool ``converged`` [Q]."""
    dev = targets.device
    n, Q, S, R = s.shape[0], targets.shape[0], search_nodes, alpha * k
    seed &= M32
    qidx = torch.arange(Q, dtype=torch.int64, device=dev)
    t0 = targets[:, 0]
    pos = lower_bound(s, targets)
    a_ix = torch.arange(alpha, device=dev)[None, :, None]
    j_ix = torch.arange(k, device=dev)[None, None, :]
    base = (pos - R // 2).clamp(min=0).clamp(max=max(n - R, 0))
    fallback = (base[:, None, None] + a_ix * k + j_ix).clamp(0, n - 1)

    def answers(asked: torch.Tensor, rnd: int) -> torch.Tensor:
        """Rows [Q, R] that the nodes ``asked`` [Q, alpha] (-1: none)
        send back in round ``rnd``."""
        b = clz32(s[asked.clamp(min=0), 0] ^ t0[:, None])
        shift = lut_bits - (b + 1).clamp(max=lut_bits)
        prefix = ((t0[:, None] >> (32 - lut_bits)) >> shift) << shift
        lo = table[prefix]
        size = (table[prefix + (1 << shift)] - lo).clamp(min=0)
        c = (((rnd * Q) & M32) + qidx) & M32
        c = (mul32(c, alpha)[:, None, None] + a_ix) & M32
        c = (mul32(c, k) + j_ix) & M32
        h = mix32(c ^ seed)
        block = lo[..., None] + h % size.clamp(min=1)[..., None]
        rows = torch.where(size[..., None] >= k, block, fallback)
        return torch.where(asked[..., None] >= 0, rows, -1).reshape(Q, R)

    def merge(node, queried, new):
        node = torch.cat([node, new], 1)
        absent = node < 0
        ids = s[node.clamp(min=0)]
        dist = torch.where(absent[..., None], M32,
                           ids[..., :rank_limbs] ^ targets[:, None,
                                                           :rank_limbs])
        queried = torch.cat([queried, torch.zeros_like(new, dtype=torch.bool)],
                            1)
        keys = ([absent.to(torch.int64)]
                + [dist[..., c] for c in range(rank_limbs)]
                + [node, (~queried).to(torch.int64)])
        order = _stable_order(keys, node.shape[1], Q, dev)
        node = torch.gather(node, 1, order)
        queried = torch.gather(queried, 1, order)
        dup = torch.cat([torch.zeros_like(node[:, :1], dtype=torch.bool),
                         (node[:, 1:] == node[:, :-1]) & (node[:, 1:] >= 0)],
                        1)
        gone = (node < 0) | dup
        keep = torch.sort(gone.to(torch.int64), dim=1, stable=True).indices[
            :, :S]
        present = ~torch.gather(gone, 1, keep)
        node = torch.where(present, torch.gather(node, 1, keep), -1)
        return node, present & torch.gather(queried, 1, keep)

    def synced(node, queried):
        first = node[:, :k] >= 0
        return (~first | queried[:, :k]).all(1) & first.any(1)

    node = torch.full((Q, S), -1, dtype=torch.int64, device=dev)
    queried = torch.zeros((Q, S), dtype=torch.bool, device=dev)
    boot = torch.full((Q, alpha), -1, dtype=torch.int64, device=dev)
    boot[:, 0] = mix32(qidx ^ seed) % n
    node, queried = merge(node, queried, answers(boot, 0))
    hops = torch.zeros(Q, dtype=torch.int64, device=dev)
    done = synced(node, queried)
    rnd = 0
    while rnd < max_hops and not bool(done.all()):
        can = (node >= 0) & ~queried & ~done[:, None]
        rank = torch.cumsum(can.to(torch.int64), 1)
        asked = torch.stack([torch.where(can & (rank == a + 1), node, -1)
                             .amax(1) for a in range(alpha)], 1)
        sent = can & (rank <= alpha)
        queried = queried | sent
        node, queried = merge(node, queried, answers(asked, rnd + 1))
        stalled = ~((node >= 0) & ~queried).any(1)
        hops = hops + (~done & sent.any(1)).to(torch.int64)
        done = done | synced(node, queried) | stalled
        rnd += 1
    nodes = node[:, :k]
    full = torch.where((nodes >= 0)[..., None],
                       s[nodes.clamp(min=0)] ^ targets[:, None, :], M32)
    return {"nodes": nodes, "dist": full, "hops": hops,
            "converged": synced(node, queried)}
