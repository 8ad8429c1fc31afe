"""Sorted-table XOR nearest-neighbour lookup — the static half of the JAX
package's ``ops/sorted_table.py`` in torch.

In lexicographic order the common-prefix length with a query is unimodal
around the query's insertion position, so the k XOR-closest nodes lie in
a small window of the sorted table around that position, and a
certificate proves it per query:

  cb(q, kth result) > cb(q, nearest excluded neighbour) on each side that
  has excluded nodes.

Two routes, as in the JAX package:

- ``window_topk``: binary-search the position, gather a ``window``-wide
  slice element by element, select the top k (``sort`` = stable 7-key
  lexsort, ``kernel`` = the CUDA ``lex_topk_select``).
- ``expanded_topk``: the table is pre-expanded into overlapping stride-64
  rows (``expand_table``), so one row of it holds a query's 192-lane
  window plus the certificate neighbours; the select is ``sort``,
  ``fast3`` (3-key sort with a tie check folded into the certificate) or
  ``kernel`` (the CUDA ``window_select``, which reads the row in place;
  the other selects gather the rows first).

``select="kernel"`` is the counterpart of the JAX package's ``"pallas"``.
``"auto"`` resolves per device: on CUDA tensors both routes take
``"kernel"``; on CPU tensors ``window_topk`` takes ``"sort"`` and
``expanded_topk`` ``"fast3"``, as the JAX package does off the TPU, and a
``"kernel"`` asked for on the CPU runs the kernels' plain versions.
Every select is exact on certified rows, so after the fallback the output
does not depend on the select.

**Fallback.**  The JAX package resolves uncertified rows on the device
with ``lax.cond``.  The port uses the host-fallback form instead:
:func:`lookup_topk` reads the certificate once (one device→host sync) and
:func:`resolve_uncertified` rescans only the uncertified rows with the
exact ``xor_topk``.  ``core/table.py`` launches the lookup without the
check and defers it into ``PendingLookup.consume()``, where the host
waits anyway, so a launch stays asynchronous.

``fused_gather_planar`` is the search engine's table access
(core/search.py).

All ids and distances are key tensors (``ops/ids.py``).  Not ported
yet: fast2, ``planes=2``, ``tomb_bits``, ``cascade_topk``, the churn
half and ``expand_table_chunked``.
"""

from __future__ import annotations

import math

import torch

from .ids import FLIP, KEY_MAX, N_LIMBS, xor_ids, common_bits, clz32
from .lex_select import lex_topk_select
from .window_select import window_select
from .xor_topk import lexsort, xor_topk

_I32 = torch.int32


def sort_table(ids, valid=None):
    """Sort id rows lexicographically; invalid rows sink to the end.

    Returns (sorted_ids [N,5], perm [N] int32 original row of each sorted
    row, n_valid 0-d int32).  ``perm`` is -1 on rows that were invalid.
    Ties (duplicate ids) keep their original row order.
    """
    N = ids.shape[0]
    if valid is None:
        valid = torch.ones(N, dtype=torch.bool, device=ids.device)
    inv = (~valid).to(_I32)
    perm = lexsort([inv] + [ids[:, l] for l in range(N_LIMBS)], dim=0)
    sorted_ids = ids[perm]
    perm_out = torch.where(inv[perm] == 0, perm.to(_I32), -1)
    return sorted_ids, perm_out, valid.sum(dtype=_I32)


LUT_BITS = 16
LUT_BUCKET_STEPS = 13


def default_lut_bits(n_rows: int) -> int:
    """Prefix width for :func:`build_prefix_lut` sized to the table
    (~1-row buckets, clamped to [16, 24])."""
    return min(24, max(16, math.ceil(math.log2(max(n_rows, 2)))))


def build_prefix_lut(sorted_ids, n_valid, *, bits: int = LUT_BITS):
    """Top-``bits`` prefix → first sorted row with that prefix or greater.

    int32 [2^bits + 1]; entry [p+1] bounds bucket p.  Invalid rows get
    the sentinel prefix 2^bits.  Built as a histogram plus exclusive
    cumulative sum, like the JAX version.
    """
    N = sorted_ids.shape[0]
    nb = 1 << bits
    dev = sorted_ids.device
    # top bits of the unsigned limb: key + 2^31 is the uint32 value
    keys = (sorted_ids[:, 0].to(torch.int64) + (1 << 31)) >> (32 - bits)
    keys = torch.where(torch.arange(N, device=dev) < n_valid, keys, nb)
    counts = torch.bincount(keys, minlength=nb + 1)
    return torch.cat([torch.zeros(1, dtype=_I32, device=dev),
                      torch.cumsum(counts[:nb], 0).to(_I32)])


def _lut_bits(lut) -> int:
    """Recover the prefix width from a build_prefix_lut result shape."""
    return (lut.shape[0] - 1).bit_length() - 1


def lut_budget_steps(n_rows: int, bits: int) -> int:
    """In-bucket binary-search depth used when ``lut_steps=None``."""
    return max(6, math.ceil(math.log2(max(n_rows, 2))) - bits + 6)


def fused_gather_planar(table, rows, limbs: int = N_LIMBS):
    """ONE gather of the top ``limbs`` limbs of arbitrary-shaped row
    indices — the table access of every search round (core/search.py).
    Returns ``limbs`` planes shaped like ``rows``.  Rows out of range
    (the engine's -1 "absent") are clipped, so their lanes hold some
    row's limbs and every caller masks them (``xor_topk.gather_rows``
    is the oracle that writes all-ones there instead).

    ``table`` is the row-major [N, 5] key table, not the JAX package's
    transposed [5, N]: that layout avoided the TPU's 5→128 lane padding
    of a [M, 5] gather.  On the H100 a row's 2 or 5 limbs (8 or 20 B)
    lie in one 32-byte sector, so the row-major gather reads one sector
    per row where the planar one reads one per limb.
    """
    N = table.shape[0]
    cl = rows.clamp(0, N - 1).reshape(-1).long()
    g = table[:, :limbs][cl]                                  # [M, limbs]
    return [g[:, l].reshape(rows.shape) for l in range(limbs)]


def _lex_lt(g, q_l, limbs: int):
    """Planar lexicographic row < query: ``g`` list of [M] gathered limbs,
    ``q_l`` list of [M] query limbs."""
    lt = g[limbs - 1] < q_l[limbs - 1]
    for l in range(limbs - 2, -1, -1):
        lt = (g[l] < q_l[l]) | ((g[l] == q_l[l]) & lt)
    return lt


def _lower_bound(sorted_ids, queries, n_valid, lut=None,
                 lut_steps: int = LUT_BUCKET_STEPS, limbs: int = N_LIMBS):
    """First index i in [0, n_valid] with sorted_ids[i] >= q, batched:
    a fixed-depth binary search (ceil(log2 N)+1 steps, or ``lut_steps``
    inside the query's LUT bucket)."""
    N = sorted_ids.shape[0]
    Q = queries.shape[0]
    dev = queries.device
    if lut is not None:
        bits = _lut_bits(lut)
        p = (queries[:, 0].to(torch.int64) + (1 << 31)) >> (32 - bits)
        lo = lut[p]
        hi = lut[p + 1]
        steps = lut_budget_steps(N, bits) if lut_steps is None else lut_steps
    else:
        steps = max(1, math.ceil(math.log2(max(N, 2))) + 1)
        lo = torch.zeros(Q, dtype=_I32, device=dev)
        hi = torch.as_tensor(n_valid, dtype=_I32).to(dev).expand(Q)
    q_l = [queries[:, l] for l in range(limbs)]
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        g = sorted_ids[mid.clamp(0, N - 1)]
        go_right = _lex_lt([g[:, l] for l in range(limbs)], q_l, limbs) \
            & (lo < hi)
        lo, hi = (torch.where(go_right, mid + 1, lo),
                  torch.where(go_right | (lo >= hi), hi, mid))
    return lo


def _resolve_select(select: str, queries, default_cpu: str) -> str:
    if select == "auto":
        return "kernel" if queries.is_cuda else default_cpu
    return select


def window_candidates(sorted_ids, n_valid, queries, *, window: int = 128,
                      lut=None, lut_steps: int = LUT_BUCKET_STEPS):
    """Position each query and gather its ``window``-wide slice, slid to
    stay inside [0, n_valid).  Returns (dist [Q,W,5] distance keys, inv
    [Q,W] int32, raw [Q,W] int32 sorted rows, start [Q] int32) — the
    input of :func:`window_topk`'s select."""
    N = sorted_ids.shape[0]
    Q = queries.shape[0]
    dev = queries.device
    nv = torch.as_tensor(n_valid, dtype=_I32).to(dev)
    pos = _lower_bound(sorted_ids, queries, nv, lut=lut, lut_steps=lut_steps)
    start = torch.minimum(torch.clamp(pos - window // 2, min=0),
                          torch.clamp(nv - window, min=0))
    offs = torch.arange(window, dtype=_I32, device=dev)
    raw = start[:, None] + offs[None, :]                     # [Q, W]
    inv = (raw >= nv).to(_I32)
    win_ids = sorted_ids[raw.clamp(0, N - 1).reshape(-1)].reshape(
        Q, window, N_LIMBS)
    return xor_ids(queries[:, None, :], win_ids), inv, raw, start


def window_topk(sorted_ids, n_valid, queries, *, k: int = 8,
                window: int = 128, select: str = "auto", lut=None,
                lut_steps: int = LUT_BUCKET_STEPS):
    """k XOR-closest among the first n_valid rows of a sorted table,
    searched within a ``window``-wide slice around each query's sorted
    position, plus a per-query exactness certificate.

    ``select``: ``"sort"`` (stable 7-key lexsort), ``"kernel"`` (the
    ``lex_topk_select`` CUDA kernel — the JAX ``"pallas"`` select; its
    plain version on CPU tensors), ``"auto"`` (kernel on CUDA, sort on
    the CPU).

    Returns dist [Q,k,5] keys (all-ones beyond n_valid results), idx
    [Q,k] int32 sorted-table rows (-1 = none), certified [Q] bool.
    """
    if window < k:
        raise ValueError(f"window ({window}) must be >= k ({k})")
    select = _resolve_select(select, queries, "sort")
    if select not in ("sort", "kernel"):
        raise ValueError(f"window_topk: unknown select {select!r}")
    N = sorted_ids.shape[0]
    nv = torch.as_tensor(n_valid, dtype=_I32).to(queries.device)
    dist, inv, raw, start = window_candidates(
        sorted_ids, nv, queries, window=window, lut=lut, lut_steps=lut_steps)
    if select == "kernel":
        sel = lex_topk_select(dist, inv, k=k)
        found = sel >= 0
        selc = sel.clamp(0, window - 1).long()
        top_inv = (~found).to(_I32)
        top_idx = torch.where(found, torch.gather(raw, 1, selc), -1)
        top_dist = torch.where(
            found[..., None],
            torch.gather(dist, 1, selc[..., None].expand(-1, -1, N_LIMBS)),
            KEY_MAX)
    else:
        # raw rises along the window, so the stable lexsort on
        # (inv, d0..d4) equals the JAX 7-key sort with raw as last key
        perm = lexsort([inv] + [dist[..., l] for l in range(N_LIMBS)],
                       dim=1)[:, :k]
        top_inv = torch.gather(inv, 1, perm)
        ok = top_inv == 0
        top_idx = torch.where(ok, torch.gather(raw, 1, perm), -1)
        top_dist = torch.where(
            ok[..., None],
            torch.gather(dist, 1, perm[..., None].expand(-1, -1, N_LIMBS)),
            KEY_MAX)

    left_ids = sorted_ids[(start - 1).clamp(0, N - 1)]
    right_ids = sorted_ids[(start + window).clamp(0, N - 1)]
    kth_ids = xor_ids(queries, top_dist[:, k - 1])
    certified = _window_certificate(
        queries, common_bits(queries, kth_ids), top_inv[:, k - 1] == 0,
        left_ids, right_ids, start > 0, (start + window) < nv)
    return top_dist, top_idx, certified


def _cb_clamped(queries, ids):
    """Common-prefix bits of ``queries`` [Q,5] vs ``ids`` [Q,L], clamped
    at 32·L when only the top L limbs are available (= common_bits for
    L=5)."""
    L = ids.shape[-1]
    out = torch.full(queries.shape[:-1], 32 * L, dtype=_I32,
                     device=queries.device)
    prev_zero = torch.ones(queries.shape[:-1], dtype=torch.bool,
                           device=queries.device)
    for l in range(L):
        xi = queries[..., l] ^ ids[..., l]
        first = prev_zero & (xi != 0)
        out = torch.where(first, 32 * l + clz32(xi), out)
        prev_zero = prev_zero & (xi == 0)
    return out


def _window_certificate(queries, cp_k, kth_valid, left_ids, right_ids,
                        left_exists, right_exists):
    """Exactness certificate shared by the window and expanded lookups:
    every excluded node on a side is farther than the kth result when
    cp_k exceeds that side's nearest excluded neighbour's common prefix
    (see the JAX package's docstring for the argument)."""
    cbL = _cb_clamped(queries, left_ids)
    cbR = _cb_clamped(queries, right_ids)
    covers_all = (~left_exists) & (~right_exists)
    ok_left = (~left_exists) | (cp_k > cbL)
    ok_right = (~right_exists) | (cp_k > cbR)
    return covers_all | (kth_valid & ok_left & ok_right)


# ---------------------------------------------------------------------------
# Expanded-table route: each query's window is ONE row of the expansion.
#
#   expanded[j] = sorted rows [64·j - 1, 64·j + 193) in limb-planar order
#
# Any 128-wide window [pos-64, pos+64) lies inside row
# j = floor((pos-64)/64); lane 0 and lane 193 of each plane are the left
# and right certificate neighbours.
# ---------------------------------------------------------------------------

EXPAND_STRIDE = 64
EXPAND_LEN = 3 * EXPAND_STRIDE          # candidate window rows per entry
_EROW = EXPAND_LEN + 2                  # + left/right certificate neighbours

# closed set of strides: expanded_topk infers the stride from the row
# width, and validating it against this set keeps a mis-built expansion
# from being misparsed silently (same rule as the JAX package)
SUPPORTED_STRIDES = frozenset({8, 16, 24, 32, 42, 48, 64, 96, 128})


def expand_table(sorted_ids, *, stride: int = EXPAND_STRIDE):
    """[N, 5] sorted keys → [ceil(N/s), 5·(3s+2)] overlapping window rows.

    Row j holds sorted rows [s·j-1, s·j+3s+1) limb-planar: lanes
    [l·(3s+2), (l+1)·(3s+2)) are limb l of those rows.  Lane 0 of each
    plane is the left certificate neighbour (a zero id for j=0), lanes
    1..3s the candidate window, lane 3s+1 the right neighbour.  Rows
    past the end are zero ids.  Bit-identical to the JAX expansion.
    """
    if stride not in SUPPORTED_STRIDES:
        raise ValueError(f"stride {stride} not in SUPPORTED_STRIDES "
                         f"{sorted(SUPPORTED_STRIDES)}")
    N = sorted_ids.shape[0]
    NB = -(-N // stride)
    nblk = NB + 4
    pad = nblk * stride - N - 1
    zero_id = torch.full((1, N_LIMBS), FLIP, dtype=_I32,
                         device=sorted_ids.device)   # key of the 0 limb
    padded = torch.cat([zero_id, sorted_ids, zero_id.expand(pad, -1)])
    planes = []
    for l in range(N_LIMBS):
        Bl = padded[:, l].reshape(nblk, stride)
        planes += [Bl[:NB], Bl[1:NB + 1], Bl[2:NB + 2], Bl[3:NB + 3, :2]]
    return torch.cat(planes, dim=1)


def expanded_select(expanded, j, queries, start, n_valid, *, k: int,
                    select: str):
    """In-window select of :func:`expanded_topk`: query q's window is row
    ``j[q]`` of ``expanded``.

    ``expanded`` [NB, 5·(3s+2)] from :func:`expand_table`, ``j`` [Q]
    int32 rows, ``start`` [Q] int32 window starts.  ``"kernel"`` hands
    ``(expanded, j)`` to ``window_select``, which reads each row in place
    on the card; ``"sort"`` and ``"fast3"`` gather the rows first.
    Returns (top_dist [Q,k,5] keys, top_idx [Q,k] int32 sorted rows,
    valid_k [Q,k] bool, tie [Q] bool or None) — ``tie`` is fast3's
    adjacent (d0, d1) tie flag among the first k+1 valid rows.
    """
    Q = j.shape[0]
    erow = expanded.shape[1] // N_LIMBS
    wlen = erow - 2
    dev = queries.device
    nv = torch.as_tensor(n_valid, dtype=_I32).to(dev)
    if select == "kernel":
        if erow != _EROW:
            raise ValueError("the kernel select supports only the default "
                             f"stride {EXPAND_STRIDE}")
        q8 = torch.nn.functional.pad(queries, (0, 8 - N_LIMBS))
        bounds = torch.clamp(nv - start, 0, wlen)[:, None].expand(Q, 8)
        packed = window_select(expanded, q8, bounds.contiguous(), k=k,
                               row_index=j)
        local = packed[:, N_LIMBS * k:(N_LIMBS + 1) * k]
        gidx = start[:, None] + local
        valid_k = (local < wlen) & (gidx < nv)
        top_dist = torch.where(
            valid_k[..., None],
            packed[:, :N_LIMBS * k].reshape(Q, N_LIMBS, k).transpose(1, 2),
            KEY_MAX)
        return top_dist, torch.where(valid_k, gidx, -1), valid_k, None
    if select not in ("sort", "fast3"):
        raise ValueError(f"expanded_topk: unknown select {select!r}")
    rows = expanded[j]
    d = [rows[:, l * erow + 1:(l + 1) * erow - 1] ^ queries[:, l:l + 1] ^ FLIP
         for l in range(N_LIMBS)]                           # 5 × [Q, 3s]
    gr = start[:, None] + torch.arange(wlen, dtype=_I32, device=dev)[None, :]
    inv = (gr >= nv).to(_I32)
    # gr rises along the window: the stable lexsort on the leading keys
    # is the JAX sort with gr as the last key (sort: 7 keys, fast3: 3 keys
    # with limbs 2..4 riding as payload)
    keys = [inv] + (d if select == "sort" else d[:2])
    perm = lexsort(keys, dim=1)[:, :k + 1]
    pk = perm[:, :k]
    valid_k = torch.gather(inv, 1, pk) == 0
    top_dist = torch.where(
        valid_k[..., None],
        torch.stack([torch.gather(dl, 1, pk) for dl in d], dim=-1), KEY_MAX)
    top_idx = torch.where(valid_k, torch.gather(gr, 1, pk), -1)
    tie = None
    if select == "fast3":
        a0 = torch.gather(d[0], 1, perm)
        a1 = torch.gather(d[1], 1, perm)
        av = torch.gather(inv, 1, perm) == 0
        tie = ((a0[:, 1:] == a0[:, :-1]) & (a1[:, 1:] == a1[:, :-1])
               & av[:, 1:] & av[:, :-1]).any(dim=1)
    return top_dist, top_idx, valid_k, tie


def expanded_topk(sorted_ids, expanded, n_valid, queries, *, k: int = 8,
                  select: str = "auto", lut=None, lut_steps=None):
    """k XOR-closest via the expanded table — one row gather per query.

    ``select``: ``"kernel"`` = the CUDA ``window_select`` (the JAX
    ``"pallas"`` select; its plain version on CPU tensors); ``"sort"`` =
    full 7-key lexsort; ``"fast3"`` = 3-key (invalid, d0, d1) lexsort
    with an adjacent-tie check folded into ``certified``; ``"auto"`` =
    kernel on CUDA tensors, fast3 on the CPU.

    Returns (dist [Q,k,5] keys, idx [Q,k] sorted-table rows, certified
    [Q]) with the :func:`window_topk` contract.
    """
    select = _resolve_select(select, queries, "fast3")
    erow = expanded.shape[1] // N_LIMBS      # lanes per limb plane = 3s+2
    wlen = erow - 2                          # candidate window rows = 3s
    nv = torch.as_tensor(n_valid, dtype=_I32).to(queries.device)
    j, start = expanded_window(sorted_ids, expanded, nv, queries,
                               lut=lut, lut_steps=lut_steps)
    left_ids, right_ids = certificate_neighbours(expanded, j)

    top_dist, top_idx, valid_k, tie = expanded_select(
        expanded, j, queries, start, nv, k=k, select=select)
    kth_ids = xor_ids(queries, top_dist[:, k - 1])
    certified = _window_certificate(
        queries, common_bits(queries, kth_ids), valid_k[:, k - 1],
        left_ids, right_ids, start > 0, (start + wlen) < nv)
    if tie is not None:
        certified = certified & ~tie
    return top_dist, top_idx, certified


def expanded_window(sorted_ids, expanded, n_valid, queries, *, lut=None,
                    lut_steps=None):
    """Position each query on the expanded table.  Returns (j [Q] int32
    row of ``expanded`` holding the query's window, start [Q] int32 window
    starts) — the input of :func:`expanded_select`."""
    if expanded.shape[1] % N_LIMBS:
        raise ValueError(f"expanded width {expanded.shape[1]} is not a "
                         f"multiple of {N_LIMBS} limb planes")
    NB = expanded.shape[0]
    erow = expanded.shape[1] // N_LIMBS      # lanes per limb plane = 3s+2
    wlen = erow - 2                          # candidate window rows = 3s
    stride = wlen // 3
    if wlen != 3 * stride or stride not in SUPPORTED_STRIDES:
        raise ValueError(f"expanded width {expanded.shape[1]} infers stride "
                         f"{wlen / 3:g} not in SUPPORTED_STRIDES "
                         f"{sorted(SUPPORTED_STRIDES)}")
    nv = torch.as_tensor(n_valid, dtype=_I32).to(queries.device)
    pos = _lower_bound(sorted_ids, queries, nv, lut=lut, lut_steps=lut_steps)
    # slide at the table end like window_topk (floor division of a
    # possibly negative numerator, as in the JAX version)
    jmax = torch.clamp(-torch.div(wlen - nv, stride, rounding_mode="floor"),
                       0, NB - 1)
    j = torch.minimum(
        torch.clamp(torch.div(pos - stride, stride, rounding_mode="floor"),
                    min=0), jmax)
    return j, j * stride


def certificate_neighbours(expanded, j):
    """Left and right certificate neighbours of each query's window:
    lanes 0 and 3s+1 of every limb plane of row ``j[q]``, fetched as one
    10-column gather (not the whole row).  Returns (left [Q,5], right
    [Q,5]) id keys."""
    erow = expanded.shape[1] // N_LIMBS
    planes = torch.arange(N_LIMBS, device=j.device) * erow
    cols = torch.cat([planes, planes + erow - 1])
    nbrs = expanded[j.long()[:, None], cols[None, :]]
    return nbrs[:, :N_LIMBS], nbrs[:, N_LIMBS:]


def scan_tile(n_rows: int, q: int) -> int:
    """Table tile of the exact rescan: large, but with the per-step
    candidate buffers (~64 B per query × tile entry) under ~1 GiB."""
    t = 1 << 16
    while t > 512 and q * t * 64 > (1 << 30):
        t //= 2
    return max(1, min(n_rows, t))


def resolve_uncertified(sorted_ids, n_valid, queries, dist, idx, cert,
                        k: int):
    """Host fallback: read the certificate (one device→host sync) and
    rescan only the uncertified rows exactly.  Returns (dist, idx,
    certified=all True)."""
    bad = torch.nonzero(~cert.cpu()).reshape(-1)
    done = torch.ones_like(cert)
    if bad.numel() == 0:
        return dist, idx, done
    bad = bad.to(queries.device)
    N = sorted_ids.shape[0]
    valid_rows = torch.arange(N, device=queries.device) < \
        torch.as_tensor(n_valid).to(queries.device)
    fb_dist, fb_idx = xor_topk(queries[bad], sorted_ids, k=k,
                               tile=scan_tile(N, bad.numel()),
                               valid=valid_rows)
    dist = dist.clone()
    idx = idx.clone()
    dist[bad] = fb_dist
    idx[bad] = fb_idx
    return dist, idx, done


def lookup_topk(sorted_ids, n_valid, queries, *, k: int = 8,
                window: int = 128, fallback: bool = True, lut=None,
                lut_steps=None, expanded=None, select: str = "auto"):
    """Window lookup with the exact fallback: with ``fallback=True`` the
    uncertified rows are rescanned exactly (:func:`resolve_uncertified`)
    and every row is exact; with ``fallback=False`` rows whose returned
    ``certified`` is False may be inexact.

    With ``expanded`` (from :func:`expand_table`) the row-gather route
    :func:`expanded_topk` runs with ``select``; without it
    :func:`window_topk` runs with its ``"auto"`` select.  Returns (dist
    [Q,k,5] keys, idx [Q,k] int32 sorted-table rows, certified [Q]).
    """
    if expanded is not None:
        dist, idx, cert = expanded_topk(sorted_ids, expanded, n_valid,
                                        queries, k=k, select=select,
                                        lut=lut, lut_steps=lut_steps)
    else:
        dist, idx, cert = window_topk(sorted_ids, n_valid, queries, k=k,
                                      window=window, lut=lut,
                                      lut_steps=(LUT_BUCKET_STEPS
                                                 if lut_steps is None
                                                 else lut_steps))
    if not fallback:
        return dist, idx, cert
    return resolve_uncertified(sorted_ids, n_valid, queries, dist, idx,
                               cert, k)
