"""Sorted-table XOR nearest-neighbour lookup — the JAX package's
``ops/sorted_table.py`` in torch: the static lookup and the churn half.

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
  ``fast3`` (3-key sort with a tie check folded into the certificate),
  ``fast2`` (nodes without distances, on a 2-plane expansion) or
  ``kernel`` (the CUDA ``window_select``, which reads the row in place;
  the other selects gather the rows first).  ``cascade_topk`` repairs a
  narrow expansion's uncertified rows against a wide one.

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

**Churn** (``churn_lookup_topk``, the live table of core/table.py): a
base table with tombstone bits over its sorted positions plus a small
delta slab, looked up in one call and merged — bit-identical to a full
re-sort of the live ids.  The JAX package repairs its rare inexact rows
under three ``lax.cond``s; the port launches without a check
(:func:`churn_lookup_launch`) and repairs in :func:`churn_lookup_finish`
after one device→host read of the rows' flags, recomputing only the
flagged rows (see there).

All ids and distances are key tensors (``ops/ids.py``); tombstone words
are raw bits held as int32 (:func:`tomb_tensor`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from .. import telemetry
from .._device import resolve_device
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
    # a scatter-add, not bincount: bincount sizes its output from the
    # input's max, a device→host read
    counts = torch.zeros(nb + 1, dtype=torch.int64, device=dev).index_add_(
        0, keys, torch.ones_like(keys))
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


def _dev_scalar(n, device) -> torch.Tensor:
    """A row count (``n_valid``) as a 0-d int32 tensor on ``device``.  A
    Python int becomes a fill on the device: uploading it would be a
    blocking host→device copy, which synchronises the stream and stalls
    the host behind every launch queued before it."""
    if isinstance(n, torch.Tensor):
        return n.to(device=device, dtype=_I32)
    return torch.full((), int(n), dtype=_I32, device=device)


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
        hi = _dev_scalar(n_valid, dev).expand(Q)
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
    nv = _dev_scalar(n_valid, dev)
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
    nv = _dev_scalar(n_valid, queries.device)
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


def _check_stride(stride: int) -> None:
    if stride not in SUPPORTED_STRIDES:
        raise ValueError(f"stride {stride} not in SUPPORTED_STRIDES "
                         f"{sorted(SUPPORTED_STRIDES)} — register new "
                         "sweep geometries there")


def _window_rows(blocks, nb: int, limbs: int):
    """Limb-planar window rows from per-limb [nb+3, s] blocks of the
    sentinel-padded table (``blocks[l]`` = limb l): row j is blocks j,
    j+1, j+2 and the first two lanes of j+3 of every limb."""
    planes = []
    for l in range(limbs):
        Bl = blocks[l]
        planes += [Bl[:nb], Bl[1:nb + 1], Bl[2:nb + 2], Bl[3:nb + 3, :2]]
    return torch.cat(planes, dim=1)


def expand_table(sorted_ids, *, stride: int = EXPAND_STRIDE,
                 limbs: int = N_LIMBS):
    """[N, 5] sorted keys → [ceil(N/s), limbs·(3s+2)] overlapping window
    rows.

    Row j holds sorted rows [s·j-1, s·j+3s+1) limb-planar: lanes
    [l·(3s+2), (l+1)·(3s+2)) are limb l of those rows.  Lane 0 of each
    plane is the left certificate neighbour (a zero id for j=0), lanes
    1..3s the candidate window, lane 3s+1 the right neighbour.  Rows
    past the end are zero ids.  ``limbs`` < 5 builds only the top limb
    planes: the 2-plane form is all that ``select="fast2"`` reads (its
    sort and its certificate use limbs 0-1), 2/5 of the bytes.
    Bit-identical to the JAX expansion.
    """
    _check_stride(stride)
    N = sorted_ids.shape[0]
    NB = -(-N // stride)
    nblk = NB + 4
    pad = nblk * stride - N - 1
    zero_id = torch.full((1, N_LIMBS), FLIP, dtype=_I32,
                         device=sorted_ids.device)   # key of the 0 limb
    padded = torch.cat([zero_id, sorted_ids, zero_id.expand(pad, -1)])
    return _window_rows([padded[:, l].reshape(nblk, stride)
                         for l in range(limbs)], NB, limbs)


def expand_table_chunked(sorted_ids, *, stride: int = EXPAND_STRIDE,
                         chunks: int = 8, limbs: int = N_LIMBS):
    """Same window rows as :func:`expand_table`, built in ``chunks``
    pieces written in place into one preallocated output, so the peak is
    the output + the input + one piece (the one-shot build holds a
    padded copy and the per-limb planes beside its result).  The JAX
    package updates a donated buffer; here ``out[r0:r1] = piece``.

    The result may carry a few zero-id trailing rows (NB rounded up to a
    multiple of ``chunks``) that lookups never reach (the ``jmax`` clamp
    is bounded by ``n_valid``).  Bit-identical to :func:`expand_table`
    on the common rows.
    """
    _check_stride(stride)
    N = sorted_ids.shape[0]
    dev = sorted_ids.device
    NB = -(-N // stride)
    NBc = -(-NB // chunks)
    erow = 3 * stride + 2
    src_rows = (NBc + 3) * stride          # per-piece source span
    out = torch.empty((chunks * NBc, limbs * erow), dtype=_I32, device=dev)
    offs = torch.arange(src_rows, dtype=torch.int64, device=dev) - 1
    for c in range(chunks):
        # rows [start, start+src_rows) of the sentinel-padded table
        # (padded[i] = sorted[i-1]); out-of-range rows are zero ids
        idx = c * NBc * stride + offs
        ok = (idx >= 0) & (idx < N)
        src = torch.where(ok[:, None], sorted_ids[idx.clamp(0, N - 1)], FLIP)
        out[c * NBc:(c + 1) * NBc] = _window_rows(
            [src[:, l].reshape(NBc + 3, stride) for l in range(limbs)],
            NBc, limbs)
    return out


def tomb_tensor(words_u32, device=None) -> torch.Tensor:
    """Packed uint32 tombstone words (numpy) → the int32 tensor of the
    same bits that :func:`expanded_topk` and :func:`churn_lookup_topk`
    take (None = cuda).  Tombstone words are raw bits, never keys."""
    a = np.ascontiguousarray(np.asarray(words_u32, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(resolve_device(device))


def _shifts(n_words: int, device) -> torch.Tensor:
    """Lane → bit shift (lane % 32) over ``n_words`` words."""
    return torch.arange(32, dtype=_I32, device=device).repeat(n_words)


def unpack_tomb_bits(tomb_bits, n: int):
    """Packed little-endian tombstone words (int32 tensor of raw bits) →
    bool [n] mask.  Word w bit b covers sorted position 32·w + b.  torch
    has no uint32 ``>>``: the int32 arithmetic shift followed by ``& 1``
    still yields bit b exactly."""
    nw = tomb_bits.shape[0]
    words = tomb_bits[:, None].expand(nw, 32).reshape(-1)[:n]
    return ((words >> _shifts(nw, tomb_bits.device)[:n]) & 1) != 0


def _tomb_window(tomb_bits, j, NB: int, stride: int, wlen: int):
    """bool [Q, wlen] tombstones of each query's window (sorted rows
    [s·j, s·j+3s)).  The word array is blocked into per-window rows
    [NB, 3s/32] (the shifted-slice build of :func:`expand_table`) and
    each query fetches its row: window starts land on word boundaries
    because s % 32 == 0, so lane L is word L//32, bit L%32."""
    sw = stride // 32
    nw = wlen // 32                              # = 3·sw
    padw = (NB + 2) * sw - tomb_bits.shape[0]
    Bw = torch.nn.functional.pad(tomb_bits, (0, max(padw, 0)))[
        :(NB + 2) * sw].reshape(NB + 2, sw)
    tomb_rows = torch.cat([Bw[:NB], Bw[1:NB + 1], Bw[2:NB + 2]], dim=1)
    words = tomb_rows[j.long()]                  # [Q, nw] row gather
    Q = words.shape[0]
    bits = words[:, :, None].expand(Q, nw, 32).reshape(Q, nw * 32) \
        >> _shifts(nw, j.device)[None, :]
    return (bits & 1) != 0


def _expanded_geometry(expanded, planes: int):
    """(erow, wlen, stride) of an expansion declared to carry ``planes``
    limb planes, with the JAX package's checks: a width that is not a
    multiple of ``planes``, or one that infers a stride outside
    SUPPORTED_STRIDES (a 5-plane stride-64 row read as planes=2 would
    parse as stride 161 and give wrong windows that pass the
    certificate), raises."""
    if expanded.shape[1] % planes:
        raise ValueError(
            f"expanded width {expanded.shape[1]} is not a multiple of "
            f"planes={planes} — pass the planes= the expansion was "
            "built with (expand_table limbs=)")
    erow = expanded.shape[1] // planes      # lanes per limb plane = 3s+2
    wlen = erow - 2                         # candidate window rows = 3s
    stride = wlen // 3
    if wlen != 3 * stride or stride not in SUPPORTED_STRIDES:
        raise ValueError(
            f"expanded width {expanded.shape[1]} with planes={planes} "
            f"infers stride {wlen / 3:g} not in SUPPORTED_STRIDES "
            f"{sorted(SUPPORTED_STRIDES)} — `planes` does not match the "
            "expand_table(limbs=) the expansion was built with, or the "
            "stride is unregistered")
    return erow, wlen, stride


GR_SENT = 0x7FFFFFFF                    # fast2's invalid-lane row sentinel


def _pair(hi, lo):
    """Two int32 sort keys as one int64 key with the same lexicographic
    order: ``hi`` signed in the top half, ``lo`` + 2^31 (its unsigned
    rank) in the bottom half."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) + (1 << 31))


def _sort_perm(keys, dim: int = 1):
    """Stable lexicographic sort permutation of int32 keys (most
    significant first), with consecutive keys paired into int64 so the
    sort takes half the passes.  The same permutation as
    ``lexsort(keys)``."""
    paired = [_pair(keys[i], keys[i + 1]) for i in range(0, len(keys) - 1, 2)]
    if len(keys) % 2:
        paired.append(keys[-1])
    return lexsort(paired, dim=dim)


def expanded_select(expanded, j, queries, start, n_valid, *, k: int,
                    select: str, planes: int = N_LIMBS, tomb=None):
    """In-window select of :func:`expanded_topk`: query q's window is row
    ``j[q]`` of ``expanded``.

    ``expanded`` [NB, planes·(3s+2)] from :func:`expand_table`, ``j``
    [Q] int32 rows, ``start`` [Q] int32 window starts, ``tomb`` optional
    bool [Q, 3s] dead lanes.  ``"kernel"`` hands ``(expanded, j)`` to
    ``window_select``, which reads each row in place on the card;
    ``"sort"``, ``"fast3"`` and ``"fast2"`` gather the rows first.
    Returns (top_dist, top_idx [Q,k] int32 sorted rows, valid_k [Q,k]
    bool, tie [Q] bool or None).  ``top_dist`` is [Q,k,5] keys, or for
    fast2 a tuple of the two top distance planes [Q,k] (keys).  ``tie``
    is fast3's / fast2's adjacent (d0, d1) tie flag among the first k+1
    valid rows.

    fast2 folds the invalid flag into sentinel values: dead lanes carry
    (d0, d1, gr) = (KEY_MAX, KEY_MAX, GR_SENT) and the sort runs on all
    three keys.  The third key matters: a tombstoned lane early in the
    window ties on (d0, d1) with a live lane whose top 64 distance bits
    are all ones, and ``lax.sort`` puts the live one first (its gr is
    smaller); a sort on (d0, d1) alone would keep window order and put
    the dead lane first.
    """
    Q = j.shape[0]
    erow = expanded.shape[1] // planes
    wlen = erow - 2
    dev = queries.device
    nv = _dev_scalar(n_valid, dev)
    if select == "kernel":
        if tomb is not None:
            raise ValueError("tomb_bits is not supported by the kernel "
                             "select (bounds-based masking only)")
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
    if select not in ("sort", "fast3", "fast2"):
        raise ValueError(f"expanded_topk: unknown select {select!r}")
    nd = 2 if select == "fast2" else N_LIMBS
    rows = expanded[:, :nd * erow][j.long()]             # [Q, nd·(3s+2)]
    d = [rows[:, l * erow + 1:(l + 1) * erow - 1] ^ queries[:, l:l + 1] ^ FLIP
         for l in range(nd)]                             # nd × [Q, 3s] keys
    gr = start[:, None] + torch.arange(wlen, dtype=_I32, device=dev)[None, :]
    inv_b = gr >= nv
    if tomb is not None:
        inv_b = inv_b | tomb
    if select == "fast2":
        d = [torch.where(inv_b, KEY_MAX, dl) for dl in d]
        grm = torch.where(inv_b, GR_SENT, gr)
        perm = _sort_perm([d[0], d[1], grm])[:, :k + 1]
        a0, a1 = (torch.gather(dl, 1, perm) for dl in d)
        ag = torch.gather(grm, 1, perm)
        av = ag != GR_SENT
        valid_k = av[:, :k]
        top_dist = tuple(torch.where(valid_k, a[:, :k], KEY_MAX)
                         for a in (a0, a1))
        top_idx = torch.where(valid_k, ag[:, :k], -1)
    else:
        inv = inv_b.to(_I32)
        # gr rises along the window: the stable sort on the leading keys
        # is the JAX sort with gr as the last key (sort: 7 keys, fast3: 3
        # keys with limbs 2..4 riding as payload)
        perm = _sort_perm([inv] + (d if select == "sort" else d[:2]))[
            :, :k + 1]
        pk = perm[:, :k]
        valid_k = torch.gather(inv, 1, pk) == 0
        top_dist = torch.where(
            valid_k[..., None],
            torch.stack([torch.gather(dl, 1, pk) for dl in d], dim=-1),
            KEY_MAX)
        top_idx = torch.where(valid_k, torch.gather(gr, 1, pk), -1)
        if select == "sort":
            return top_dist, top_idx, valid_k, None
        a0 = torch.gather(d[0], 1, perm)
        a1 = torch.gather(d[1], 1, perm)
        av = torch.gather(inv, 1, perm) == 0
    tie = ((a0[:, 1:] == a0[:, :-1]) & (a1[:, 1:] == a1[:, :-1])
           & av[:, 1:] & av[:, :-1]).any(dim=1)
    return top_dist, top_idx, valid_k, tie


def expanded_topk(sorted_ids, expanded, n_valid, queries, *, k: int = 8,
                  select: str = "auto", lut=None, lut_steps=None,
                  tomb_bits=None, fast2_limbs: bool = False,
                  planes: int = N_LIMBS):
    """k XOR-closest via the expanded table — one row gather per query.

    ``select``: ``"kernel"`` = the CUDA ``window_select`` (the JAX
    ``"pallas"`` select; its plain version on CPU tensors); ``"sort"`` =
    full 7-key lexsort; ``"fast3"`` = 3-key (invalid, d0, d1) lexsort
    with an adjacent-tie check folded into ``certified``; ``"fast2"`` =
    the top 64 distance bits only (nodes, not distances: ``dist`` comes
    back None), its certificate on a lower bound of the kth result's
    common prefix (exact below 64 bits, clamped at 64); ``"auto"`` =
    kernel on CUDA tensors, fast3 on the CPU.

    ``planes`` declares how many limb planes ``expanded`` carries
    (``expand_table(limbs=)``); fewer than 5 only with fast2.
    ``tomb_bits`` (int32 tensor of packed raw bits over sorted
    positions, :func:`tomb_tensor`) folds dead rows into the window's
    invalid lanes; it needs a stride divisible by 32 and a sort select.
    ``fast2_limbs`` returns fast2's two top distance planes as a tuple of
    [Q,k] keys instead of None.  The ValueErrors are the JAX package's.

    Returns (dist [Q,k,5] keys, idx [Q,k] sorted-table rows, certified
    [Q]) with the :func:`window_topk` contract.
    """
    select = _resolve_select(select, queries, "fast3")
    if planes != N_LIMBS and select != "fast2":
        raise ValueError(f"planes={planes} requires select='fast2' "
                         f"(got {select!r}) — only the fast2 sort and "
                         "certificate are sound on partial limb planes")
    if planes < 2:
        raise ValueError("planes must be >= 2 (fast2 sorts on d0, d1)")
    erow, wlen, stride = _expanded_geometry(expanded, planes)
    nv = _dev_scalar(n_valid, queries.device)
    j, start = expanded_window(sorted_ids, expanded, nv, queries,
                               lut=lut, lut_steps=lut_steps, planes=planes)
    tomb = None
    if tomb_bits is not None:
        if stride % 32:
            raise ValueError(
                f"tomb_bits requires stride % 32 == 0 (got {stride})")
        tomb = _tomb_window(tomb_bits, j, expanded.shape[0], stride, wlen)
    left_ids, right_ids = certificate_neighbours(expanded, j, planes)

    top_dist, top_idx, valid_k, tie = expanded_select(
        expanded, j, queries, start, nv, k=k, select=select, planes=planes,
        tomb=tomb)
    if select == "fast2":
        # exact common prefix below 64 bits, clamped above — a lower
        # bound, so a clamp can only decertify.  The distances are keys:
        # un-flip to the raw bits clz32 reads.
        x0 = top_dist[0][:, k - 1] ^ FLIP
        x1 = top_dist[1][:, k - 1] ^ FLIP
        cp_k = torch.where(x0 != 0, clz32(x0), 32 + clz32(x1))
    else:
        cp_k = common_bits(queries, xor_ids(queries, top_dist[:, k - 1]))
    certified = _window_certificate(
        queries, cp_k, valid_k[:, k - 1], left_ids, right_ids, start > 0,
        (start + wlen) < nv)
    if tie is not None:
        certified = certified & ~tie
    if select == "fast2" and not fast2_limbs:
        top_dist = None
    return top_dist, top_idx, certified


def expanded_window(sorted_ids, expanded, n_valid, queries, *, lut=None,
                    lut_steps=None, planes: int = N_LIMBS):
    """Position each query on the expanded table.  Returns (j [Q] int32
    row of ``expanded`` holding the query's window, start [Q] int32 window
    starts) — the input of :func:`expanded_select`."""
    NB = expanded.shape[0]
    _, wlen, stride = _expanded_geometry(expanded, planes)
    nv = _dev_scalar(n_valid, queries.device)
    pos = _lower_bound(sorted_ids, queries, nv, lut=lut, lut_steps=lut_steps)
    # slide at the table end like window_topk (floor division of a
    # possibly negative numerator, as in the JAX version)
    jmax = torch.clamp(-torch.div(wlen - nv, stride, rounding_mode="floor"),
                       0, NB - 1)
    j = torch.minimum(
        torch.clamp(torch.div(pos - stride, stride, rounding_mode="floor"),
                    min=0), jmax)
    return j, j * stride


def certificate_neighbours(expanded, j, planes: int = N_LIMBS):
    """Left and right certificate neighbours of each query's window:
    lanes 0 and 3s+1 of every limb plane of row ``j[q]``, fetched as one
    2·planes-column gather (not the whole row).  Returns (left
    [Q,planes], right [Q,planes]) id keys."""
    erow = expanded.shape[1] // planes
    cols = torch.arange(planes, device=j.device) * erow
    cols = torch.cat([cols, cols + erow - 1])
    nbrs = expanded[j.long()[:, None], cols[None, :]]
    return nbrs[:, :planes], nbrs[:, planes:]


def scan_tile(n_rows: int, q: int) -> int:
    """Table tile of the exact rescan: large, but with the per-step
    candidate buffers (~64 B per query × tile entry) under ~1 GiB."""
    t = 1 << 16
    while t > 512 and q * t * 64 > (1 << 30):
        t //= 2
    return max(1, min(n_rows, t))


def _fallback_tile(n_rows: int, q: int) -> int:
    """The JAX package's tile for an exact-scan ``lax.cond`` branch, whose
    buffers are allocated even when the branch is not taken: ~Q·(tile+k)
    ·7 uint32 sort temps per step, capped at ~1 GiB (tile floor 512).
    The port runs a rescan only when it is needed and only over the rows
    that need it, so its rescans take :func:`scan_tile`; this rule is
    kept for callers that size a rescan of a whole batch."""
    t = 4096
    while t > 512 and q * t * 28 > (1 << 30):
        t //= 2
    return max(1, min(n_rows, t))


def _first_rows(mask, cap: int):
    """Indices of the first ``cap`` True entries of ``mask`` [Q], padded
    with row 0 — ``jnp.nonzero(size=cap, fill_value=0)`` without a host
    sync (a running count places each True row; the rest land in a
    discarded slot)."""
    Q = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (pos < cap), pos, cap)
    out = torch.zeros(cap + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(Q, device=mask.device))
    return out[:cap]


def cascade_topk(sorted_ids, exp_fast, exp_wide, n_valid, queries, lut, *,
                 k: int = 8, select: str = "fast2", cap: int = 512,
                 planes: int = N_LIMBS, fast2_limbs: bool = False):
    """Two-stage certified lookup: :func:`expanded_topk` over the narrow
    ``exp_fast`` with LUT-only positioning, then up to ``cap`` of its
    uncertified rows, picked on the device without a host sync, looked up
    again against the wide ``exp_wide`` (LUT-started budgeted
    positioning) and taken where that certifies.  Rows neither stage
    certifies (more than ``cap`` misses, or adversarial clustering) come
    back with ``certified=False`` for the caller's exact fallback.

    The rescue rows are padded with row 0, so the scatters back write
    row 0 several times; every such write carries row 0's own value
    (its rescue result where row 0 was uncertified, its stage-1 result
    otherwise), so the repeated writes are deterministic.  Returns
    (dist|None, idx, certified) with the :func:`expanded_topk` contract.
    """
    d, idx, cert = expanded_topk(sorted_ids, exp_fast, n_valid, queries,
                                 k=k, select=select, lut=lut, lut_steps=0,
                                 planes=planes, fast2_limbs=fast2_limbs)
    bad = _first_rows(~cert, cap)
    d2, i2, c2 = expanded_topk(sorted_ids, exp_wide, n_valid, queries[bad],
                               k=k, select=select, lut=lut, lut_steps=None,
                               planes=planes, fast2_limbs=fast2_limbs)
    take = (~cert)[bad] & c2
    idx[bad] = torch.where(take[:, None], i2, idx[bad])
    if d is not None and d2 is not None:
        if isinstance(d, tuple):               # fast2_limbs planes
            for dp, d2p in zip(d, d2):
                dp[bad] = torch.where(take[:, None], d2p, dp[bad])
        else:
            d[bad] = torch.where(take[:, None, None], d2, d[bad])
    cert[bad] = cert[bad] | c2
    return d, idx, cert


def resolve_uncertified(sorted_ids, n_valid, queries, dist, idx, cert,
                        k: int):
    """Host fallback: read the certificate (one device→host sync) and
    rescan only the uncertified rows exactly.  ``dist`` may be None
    (fast2).  Returns (dist, idx, certified=all True)."""
    bad = torch.nonzero(~cert.cpu()).reshape(-1)
    done = torch.ones_like(cert)
    if bad.numel() == 0:
        return dist, idx, done
    bad = bad.to(queries.device)
    N = sorted_ids.shape[0]
    valid_rows = torch.arange(N, device=queries.device) < \
        _dev_scalar(n_valid, queries.device)
    fb_dist, fb_idx = xor_topk(queries[bad], sorted_ids, k=k,
                               tile=scan_tile(N, bad.numel()),
                               valid=valid_rows)
    idx = idx.clone()
    idx[bad] = fb_idx
    if dist is not None:
        dist = dist.clone()
        dist[bad] = fb_dist
    return dist, idx, done


def lookup_topk(sorted_ids, n_valid, queries, *, k: int = 8,
                window: int = 128, fallback: bool = True, lut=None,
                lut_steps=None, expanded=None, select: str = "auto",
                host_fallback: bool = False, donate_queries: bool = False):
    """Window lookup with the exact fallback: with ``fallback=True`` the
    uncertified rows are rescanned exactly (:func:`resolve_uncertified`)
    and every row is exact; with ``fallback=False`` rows whose returned
    ``certified`` is False may be inexact.

    With ``expanded`` (from :func:`expand_table`) the row-gather route
    :func:`expanded_topk` runs with ``select``; without it
    :func:`window_topk` runs with its ``"auto"`` select.  Returns (dist
    [Q,k,5] keys, None for fast2, idx [Q,k] int32 sorted-table rows,
    certified [Q]).

    ``host_fallback`` and ``donate_queries`` are the JAX package's
    keywords and change nothing here: the port always takes the host
    fallback form (one certificate read, then a rescan of only the
    uncertified rows), which gives the results the JAX device form
    gives, and torch has no buffer donation.
    """
    del host_fallback, donate_queries
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


# ---------------------------------------------------------------------------
# Churn path: append+tombstone lookups without re-sorting.
#
# The immutable base (sorted + expanded table) absorbs mutations two ways:
#   evictions → one bit in a packed tombstone mask over sorted positions,
#               folded into the window select's invalid lanes
#               (expanded_topk tomb_bits);
#   inserts   → rows of a fixed-capacity delta slab, kept as its own small
#               sorted + expanded table.
# A lookup is a tombstone-masked window top-k over the base, a window
# top-k over the delta and one [Q, 2k] merge.  Correctness never depends
# on churn volume (heavily tombstoned windows decertify into the exact
# fallback), so compaction is a performance policy of core/table.py.
# ---------------------------------------------------------------------------

_ENC_SENT = 0x7FFFFFFF                  # invalid-lane sentinel (sorts last)

# (shapes, select, pack) of every churn lookup launched in this process:
# dht_churn_merge_pack_resolved_total{pack=} counts each once, as the JAX
# package counts each compiled pack path once per trace
_PACK_SEEN: set = set()


def _resolve_merge_pack(pack, k: int) -> int:
    """``merge_pack="auto"`` → 1.  The JAX package packs 128//k queries
    per 128-lane row on the TPU to amortize the minor-dim pad of a [Q, k]
    layout; a CUDA card (like the CPU) pads nothing, so there is nothing
    to amortize.  Any int ≥ 1 is valid and gives bit-identical results
    (1 is the unpacked merge)."""
    if pack == "auto":
        return 1
    p = int(pack)
    if p < 1:
        raise ValueError(f"merge_pack must be >= 1 (got {pack!r})")
    return p


def _plane(x, l):
    return x[l] if isinstance(x, (tuple, list)) else x[..., l]


def packed_churn_merge(m_dist, m_idx, d_dist, d_idx, n_base, *, k: int,
                       nl: int, pack: int = 1):
    """Base ∪ delta candidate merge, ``pack`` queries per sort row.

    ``m_dist``/``d_dist``: carried distance keys, a tuple of nl [Q, k]
    planes (fast2) or an [Q, k, nl] stack; ``m_idx``/``d_idx`` int32
    [Q, k] (-1 invalid, base / delta sorted positions); ``n_base`` the
    base row count (delta encodings come back offset by it).

    Each query's 2k candidates sort on (distance limbs, enc); with
    ``pack`` > 1, P queries share one row behind a leading slot key, so
    each query's segment sorts exactly as it would alone.  ``enc`` is a
    plain int32 (not a key) with ``_ENC_SENT`` on dead lanes, and it is
    unique on live lanes, so any exact sort gives the same values; ragged
    Q pads with sentinel slots that are sliced off.

    Returns ``(enc [Q, w], limbs [nl × [Q, w]])``: the first
    w = min(k+1, 2k) rows of each query's merged order (k results and
    one lookahead row for fast2's tie check), dead lanes all-ones /
    ``_ENC_SENT``.
    """
    Q = m_idx.shape[0]
    w = min(k + 1, 2 * k)
    P = int(pack)
    QB = -(-Q // P)
    Qp = QB * P
    dev = m_idx.device

    def pk(x, fill):
        if Qp != Q:
            x = torch.cat([x, torch.full((Qp - Q, k), fill, dtype=x.dtype,
                                         device=dev)])
        return x.reshape(QB, P * k)

    mi = pk(m_idx, -1)
    di = pk(d_idx, -1)
    mv = mi >= 0
    dv = di >= 0
    enc = torch.cat([torch.where(mv, mi, _ENC_SENT),
                     torch.where(dv, di + n_base, _ENC_SENT)], dim=1)
    limbs = [torch.cat([torch.where(mv, pk(_plane(m_dist, l), KEY_MAX),
                                    KEY_MAX),
                        torch.where(dv, pk(_plane(d_dist, l), KEY_MAX),
                                    KEY_MAX)], dim=1)
             for l in range(nl)]
    keys = limbs + [enc]
    if P > 1:
        slot = torch.arange(P, dtype=_I32, device=dev)[:, None] \
            .expand(P, k).reshape(-1)
        keys = [torch.cat([slot, slot])[None, :].expand(QB, -1)] + keys
    # slot s owns lanes [2k·s, 2k·(s+1)) after the sort; keep w of them
    perm = _sort_perm(keys).reshape(QB, P, 2 * k)[:, :, :w].reshape(QB, P * w)

    def unpk(a):
        return torch.gather(a, 1, perm).reshape(Qp, w)[:Q]

    return unpk(enc), [unpk(a) for a in limbs]


class ChurnLaunch:
    """A launched churn lookup (:func:`churn_lookup_launch`): the merged
    result, the per-row repair flags (bit 0 base uncertified, bit 1 delta
    uncertified, bit 2 fast2 merge tie) and what the repair needs."""

    __slots__ = ("dist", "idx", "flags", "tables", "queries", "cands",
                 "k", "fast2")

    def __init__(self, dist, idx, flags, tables, queries, cands, k, fast2):
        self.dist = dist          # [Q,k,5] keys (fast3 / sort) or None
        self.idx = idx            # [Q,k] int32 encodings
        self.flags = flags        # [Q] uint8 repair flags
        self.tables = tables      # (sorted_ids, n_valid, tomb_bits,
        #                            d_sorted, d_n_valid)
        self.queries = queries
        self.cands = cands        # (m_dist, m_idx, d_dist, d_idx)
        self.k = k
        self.fast2 = fast2


def churn_lookup_launch(sorted_ids, expanded, n_valid, tomb_bits,
                        d_sorted, d_expanded, d_n_valid, queries, lut=None,
                        d_lut=None, d_exp_wide=None, *, k: int = 8,
                        select: str = "fast3", lut_steps=None,
                        d_lut_steps=None, planes: int = N_LIMBS,
                        d_cap: int = 1024,
                        merge_pack="auto") -> ChurnLaunch:
    """Enqueue a churn lookup (the arguments of
    :func:`churn_lookup_topk`) without any host sync.  Rows the base or
    delta certificate rejects, and fast2 rows whose 64-bit merge ties,
    are flagged for :func:`churn_lookup_finish`."""
    N = sorted_ids.shape[0]
    fast2 = select == "fast2"
    nl = 2 if fast2 else N_LIMBS
    P = _resolve_merge_pack(merge_pack, k)
    with record_function("churn.base"):
        m_dist, m_idx, cert = expanded_topk(
            sorted_ids, expanded, n_valid, queries, k=k, select=select,
            lut=lut, lut_steps=lut_steps, tomb_bits=tomb_bits,
            fast2_limbs=True, planes=planes)
    with record_function("churn.delta"):
        if d_exp_wide is not None:
            # narrow delta windows (stride 16) with their rare
            # uncertified rows repaired against the wide expansion
            dd, d_idx, d_cert = cascade_topk(
                d_sorted, d_expanded, d_exp_wide, d_n_valid, queries, d_lut,
                k=k, select=select, cap=d_cap, planes=planes,
                fast2_limbs=True)
        else:
            dd, d_idx, d_cert = expanded_topk(
                d_sorted, d_expanded, d_n_valid, queries, k=k,
                select=select, lut=d_lut, lut_steps=d_lut_steps,
                fast2_limbs=True, planes=planes)
    with record_function("churn.merge"):
        seen = (tuple(sorted_ids.shape), tuple(d_sorted.shape),
                tuple(queries.shape), k, select, planes, P,
                d_exp_wide is not None)
        if seen not in _PACK_SEEN:
            _PACK_SEEN.add(seen)
            telemetry.get_registry().counter(
                "dht_churn_merge_pack_resolved_total", pack=P).inc()
        enc_p, limbs_p = packed_churn_merge(m_dist, m_idx, dd, d_idx, N,
                                            k=k, nl=nl, pack=P)
        enc_k = enc_p[:, :k]
        ok = enc_k != _ENC_SENT
        f_idx = torch.where(ok, enc_k, -1)
        flags = (~cert).to(torch.uint8) | ((~d_cert).to(torch.uint8) << 1)
        f_dist = None
        if fast2:
            # the merge ordered on 64 distance bits: an adjacent tie among
            # the first k+1 merged rows leaves the 160-bit order open
            t0, t1, tv = limbs_p[0], limbs_p[1], enc_p != _ENC_SENT
            tie = ((t0[:, 1:] == t0[:, :-1]) & (t1[:, 1:] == t1[:, :-1])
                   & tv[:, 1:] & tv[:, :-1]).any(dim=1)
            flags = flags | (tie.to(torch.uint8) << 2)
        else:
            f_dist = torch.stack([torch.where(ok, limbs_p[l][:, :k], KEY_MAX)
                                  for l in range(nl)], dim=-1)
    return ChurnLaunch(f_dist, f_idx, flags,
                       (sorted_ids, n_valid, tomb_bits, d_sorted, d_n_valid),
                       queries, (m_dist, m_idx, dd, d_idx), k, fast2)


def _exact_merge(queries, sorted_ids, d_sorted, m_idx, d_idx, k: int):
    """enc [R, k] of the candidates merged on their full 160-bit
    distances (ids gathered by position) — fast2's tie repair."""
    N = sorted_ids.shape[0]
    D = d_sorted.shape[0]
    m_valid = m_idx >= 0
    d_valid = d_idx >= 0
    enc = torch.cat([torch.where(m_valid, m_idx, _ENC_SENT),
                     torch.where(d_valid, d_idx + N, _ENC_SENT)], dim=1)
    fm = xor_ids(queries[:, None, :], sorted_ids[m_idx.clamp(0, N - 1).long()])
    fd = xor_ids(queries[:, None, :], d_sorted[d_idx.clamp(0, D - 1).long()])
    keys = [torch.cat([torch.where(m_valid, fm[..., l], KEY_MAX),
                       torch.where(d_valid, fd[..., l], KEY_MAX)], dim=1)
            for l in range(N_LIMBS)] + [enc]
    return torch.gather(enc, 1, _sort_perm(keys)[:, :k])


def churn_lookup_finish(launch: ChurnLaunch):
    """Repair a launched churn lookup and return (dist, idx, certified
    all True).

    One device→host read of the [Q] flags, then exact recomputation of
    only the flagged rows: an exact rescan of the live base (tombstones
    masked) for base-uncertified rows, of the delta for
    delta-uncertified rows, and a re-merge of every flagged row — on the
    full carried distances for fast3, on full distances from gathered ids
    for fast2.  The JAX package runs the same repairs under ``lax.cond``
    over the whole batch but keeps every row that needed none; a row
    whose base and delta windows certified and that has no adjacent tie
    among its first k+1 merged keys has the same first k under the
    full-distance merge, so the two forms give the same result.
    """
    flags = launch.flags.cpu()                     # the one host read
    dist, idx = launch.dist, launch.idx
    if not bool(flags.any()):
        return dist, idx, torch.ones(idx.shape[0], dtype=torch.bool,
                                     device=idx.device)
    k, fast2 = launch.k, launch.fast2
    q_all = launch.queries
    dev = q_all.device
    sorted_ids, n_valid, tomb_bits, d_sorted, d_n_valid = launch.tables
    m_dist, m_idx, dd, d_idx = launch.cands
    N, D = sorted_ids.shape[0], d_sorted.shape[0]
    nl = 2 if fast2 else N_LIMBS

    def rows_of(bit):
        return torch.nonzero((flags & bit) != 0).reshape(-1).to(dev)

    redo = torch.nonzero(flags != 0).reshape(-1).to(dev)
    with record_function("churn.fallback"):
        # the flagged rows' candidates, as planes [R, k]
        q = q_all[redo]
        cand = {"m_idx": m_idx[redo], "d_idx": d_idx[redo],
                "m": [_plane(m_dist, l)[redo] for l in range(nl)],
                "d": [_plane(dd, l)[redo] for l in range(nl)]}
        where = torch.full((q_all.shape[0],), -1, dtype=torch.int64,
                           device=dev)
        where[redo] = torch.arange(redo.numel(), device=dev)
        for bit, table, nv, side in (
                (1, sorted_ids, n_valid, "m"), (2, d_sorted, d_n_valid, "d")):
            rows = rows_of(bit)
            if rows.numel() == 0:
                continue
            n = table.shape[0]
            valid = torch.arange(n, device=dev) < \
                _dev_scalar(nv, dev)
            if side == "m":
                valid = valid & ~unpack_tomb_bits(tomb_bits, n)
            dx, ix = xor_topk(q_all[rows], table, k=k,
                              tile=scan_tile(n, rows.numel()), valid=valid)
            r = where[rows]
            cand[side + "_idx"][r] = ix
            for l in range(nl):
                cand[side][l][r] = dx[..., l]
        idx = idx.clone()
        if fast2:
            enc = _exact_merge(q, sorted_ids, d_sorted, cand["m_idx"],
                               cand["d_idx"], k)
            idx[redo] = torch.where(enc != _ENC_SENT, enc, -1)
        else:
            enc, limbs = packed_churn_merge(
                tuple(cand["m"]), cand["m_idx"], tuple(cand["d"]),
                cand["d_idx"], N, k=k, nl=nl, pack=1)
            ok = enc[:, :k] != _ENC_SENT
            idx[redo] = torch.where(ok, enc[:, :k], -1)
            dist = dist.clone()
            dist[redo] = torch.stack(
                [torch.where(ok, limbs[l][:, :k], KEY_MAX)
                 for l in range(nl)], dim=-1)
    return dist, idx, torch.ones(idx.shape[0], dtype=torch.bool, device=dev)


def churn_lookup_topk(sorted_ids, expanded, n_valid, tomb_bits,
                      d_sorted, d_expanded, d_n_valid, queries,
                      lut=None, d_lut=None, d_exp_wide=None, *, k: int = 8,
                      select: str = "fast3", lut_steps=None,
                      d_lut_steps=None, planes: int = N_LIMBS,
                      d_cap: int = 1024, merge_pack="auto"):
    """Exact k XOR-closest over (live base rows ∪ delta slab).

    Base table as in :func:`expanded_topk` (its stride divisible by 32),
    ``tomb_bits`` int32 [ceil(N/32)] packed raw bits over base sorted
    positions (1 = dead, :func:`tomb_tensor`); ``d_sorted`` /
    ``d_expanded`` / ``d_n_valid`` the delta slab as its own small
    sorted + expanded table (any stride); optional LUTs and ``*_steps``
    forwarded to :func:`expanded_topk`.  ``d_exp_wide`` turns the delta
    lookup into :func:`cascade_topk` with ``d_cap`` rescue rows.
    ``merge_pack``: :func:`packed_churn_merge`'s width (``"auto"`` = 1
    here).

    Returns (dist, idx [Q,k] int32, certified [Q] all True).  ``idx``
    encodes the source: [0, N) base sorted positions, [N, N+D) ``N`` +
    delta sorted position, -1 = fewer than k live rows.  ``dist`` is
    [Q,k,5] keys for fast3 / sort and None for fast2.  Bit-identical to
    the JAX function; :func:`churn_lookup_launch` +
    :func:`churn_lookup_finish` is the same call split at its one host
    sync.
    """
    return churn_lookup_finish(churn_lookup_launch(
        sorted_ids, expanded, n_valid, tomb_bits, d_sorted, d_expanded,
        d_n_valid, queries, lut, d_lut, d_exp_wide, k=k, select=select,
        lut_steps=lut_steps, d_lut_steps=d_lut_steps, planes=planes,
        d_cap=d_cap, merge_pack=merge_pack))
