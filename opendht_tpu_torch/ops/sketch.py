"""Device-resident count-min sketch over 160-bit id traffic.

The port of the JAX package's ``ops/sketch.py``: a ``[depth, width]``
int32 counter matrix (one hash row each, point estimate = min over the
rows; never an underestimate, overestimate ``<= eps * T`` with
probability ``1 - delta`` for ``eps = e/width``, ``delta = e^-depth``)
and a 256-bin top-8-bit keyspace histogram, both updated by one batched
scatter-add per ingest wave.  The JAX functions are ``jax.jit``
programs; here each is plain torch on the tensors' own device, with the
same columns, counts and decay bit for bit.

**The hash in torch.**  ``hash_columns`` is a murmur-style mix with
uint32 wraparound, and torch has no uint32 ``>>``.  The port's ids are
int32 keys in the sign-flipped domain (``ops/ids.py``), so the limbs are
un-flipped first and the mix runs in int64 with ``& 0xFFFFFFFF`` after
each step, as ``hash_columns_host`` does in numpy.  Every multiply takes
the constant's signed 32-bit representative (``C - 2**32`` when
``C >= 2**31``): the low 32 bits of the product are the same, and
``|x * C| < 2**63`` for ``x < 2**32``, so no int64 product overflows.
The per-limb pre-mix (``k``) does not depend on the row, so it runs once
over ``[Q, 5]``; the row seeds are a ``[depth]`` tensor and the fold runs
over ``[Q, depth]`` — a wave costs a few dozen small launches, not one
chain per row.

The histogram bin is the top 8 bits of the un-flipped limb 0: a key
``x`` is ``u - 2**31``, so ``bin = (x >> 24) + 128``.

The decay is float32 ``floor(x * f)`` with ``f`` rounded to float32 as
in the JAX program (exact for counts below 2**24).

``sketch_update`` adds in place (int32 ``index_add_``: integer atomics
are order-free, so the counts are exact) and returns the same tensors;
the JAX function returns new arrays and its callers swap references,
which works the same here.

``hash_columns_host`` is the JAX package's numpy mirror, copied as is:
the tests' oracle for column placement.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .ids import FLIP, N_LIMBS, as_keys

#: defaults — depth 4 / width 2048 gives eps ~= e/2048 ~= 0.13% of the
#: window total per estimate at delta ~= e^-4 ~= 1.8%, in 32 KB of device
#: memory
SKETCH_DEPTH = 4
SKETCH_WIDTH = 2048
#: the keyspace histogram is always top-8-bit: 256 contiguous ranges
BINS = 256
BIN_BITS = 8

#: per-row seed constants (murmur3/xxhash-style mixing primes); depth
#: is capped by the seed table — 8 rows is already delta ~= 0.03%
_ROW_SEEDS = (0x9747B28C, 0x41C64E6D, 0x6C078965, 0x85EBCA6B,
              0xC2B2AE35, 0x27D4EB2F, 0x165667B1, 0x2545F491)
_MUL1 = 0xCC9E2D51
_MUL2 = 0x1B873593
MAX_DEPTH = len(_ROW_SEEDS)

_M32 = 0xFFFFFFFF


def _s32(c: int) -> int:
    """The signed 32-bit representative of a uint32 constant."""
    return c - (1 << 32) if c >= 1 << 31 else c


def _check_geometry(depth: int, width: int) -> None:
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"sketch depth {depth} outside [1, {MAX_DEPTH}]")
    if width < 2 or width & (width - 1):
        raise ValueError(f"sketch width {width} must be a power of two >= 2")


_CONSTS: dict = {}


def _consts(device: torch.device, depth: int, width: int):
    """The row seeds and flat row offsets, int64 ``[depth]`` each, made
    once per device: a per-call upload of a host list would synchronise
    the stream."""
    key = (str(device), depth, width)
    c = _CONSTS.get(key)
    if c is None:
        c = _CONSTS[key] = (
            torch.tensor(_ROW_SEEDS[:depth], dtype=torch.int64, device=device),
            torch.arange(depth, dtype=torch.int64, device=device) * width)
    return c


def _keys(ids, device=None) -> torch.Tensor:
    """Key tensor of ``ids``: a key tensor stays where it is when
    ``device`` is None; uint32 ids go to ``device`` (None = the card)."""
    if isinstance(ids, torch.Tensor) and device is None:
        return ids
    return as_keys(ids, device)


def hash_columns(ids, depth: int = SKETCH_DEPTH,
                 width: int = SKETCH_WIDTH, device=None) -> torch.Tensor:
    """Per-row column indices for each id: key tensor (or uint32 ids)
    ``[..., 5]`` → int64 ``[..., depth]`` in ``[0, width)``, equal to the
    JAX ``hash_columns`` (which returns them as int32).

    Each row d folds the 5 limbs through a murmur-style mix (xor,
    odd-constant multiply, rotate) seeded per row, then finalizes with
    the murmur3 fmix avalanche."""
    _check_geometry(depth, width)
    keys = _keys(ids, device)
    lead = keys.shape[:-1]
    x = (keys.reshape(-1, N_LIMBS) ^ FLIP).to(torch.int64)   # raw limb bits
    # the per-limb pre-mix, shared by every row: [Q, 5]
    k = (x * _s32(_MUL1)) & _M32
    k = ((k << 15) | (k >> 17)) & _M32
    k = (k * _s32(_MUL2)) & _M32
    h = _consts(keys.device, depth, width)[0].expand(x.shape[0], depth)
    for limb in range(N_LIMBS):
        h = h ^ k[:, limb, None]
        # rotl 13, then * 5 + c: the rotation's high bits fall away
        # under the final mask, so it is left unmasked
        h = (((h << 13) | (h >> 19)) * 5 + 0xE6546B64) & _M32
    h = h ^ (h >> 16)
    h = (h * _s32(0x85EBCA6B)) & _M32
    h = h ^ (h >> 13)
    h = (h * _s32(0xC2B2AE35)) & _M32
    h = h ^ (h >> 16)
    return (h & (width - 1)).reshape(lead + (depth,))


def hash_columns_host(ids, depth: int = SKETCH_DEPTH,
                      width: int = SKETCH_WIDTH) -> np.ndarray:
    """Numpy mirror of :func:`hash_columns` (same constants, same
    wrapping arithmetic) — the tests' oracle for column placement."""
    _check_geometry(depth, width)
    x = np.asarray(ids, np.uint32)
    M = np.uint32(0xFFFFFFFF)
    cols = np.empty(x.shape[:-1] + (depth,), np.int32)
    with np.errstate(over="ignore"):
        for d in range(depth):
            h = np.full(x.shape[:-1], _ROW_SEEDS[d], np.uint64)
            for limb in range(N_LIMBS):
                k = (x[..., limb].astype(np.uint64) * _MUL1) & M
                k = (((k << np.uint64(15)) | (k >> np.uint64(17))) & M
                     ) * _MUL2 & M
                h = h ^ k
                h = ((((h << np.uint64(13)) | (h >> np.uint64(19))) & M)
                     * 5 + 0xE6546B64) & M
            h = h ^ (h >> np.uint64(16))
            h = (h * 0x85EBCA6B) & M
            h = h ^ (h >> np.uint64(13))
            h = (h * 0xC2B2AE35) & M
            h = h ^ (h >> np.uint64(16))
            cols[..., d] = (h & np.uint64(width - 1)).astype(np.int32)
    return cols


def sketch_init(depth: int = SKETCH_DEPTH, width: int = SKETCH_WIDTH,
                device=None):
    """Fresh ``(sketch [depth, width] int32, hist [BINS] int32)`` pair
    on ``device`` (None = the CUDA card)."""
    _check_geometry(depth, width)
    dev = resolve_device(device)
    return (torch.zeros((depth, width), dtype=torch.int32, device=dev),
            torch.zeros((BINS,), dtype=torch.int32, device=dev))


def _flat_cells(sketch: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Flat ``[Q * depth]`` cell indices of ids ``q`` [Q, 5] in a
    ``[depth, width]`` sketch."""
    depth, width = int(sketch.shape[0]), int(sketch.shape[1])
    cols = hash_columns(q, depth, width)                      # [Q, depth]
    return (cols + _consts(q.device, depth, width)[1]).reshape(-1)


def sketch_update(sketch: torch.Tensor, hist: torch.Tensor, ids):
    """One batched scatter-add over a wave's ids: every id increments
    its ``depth`` sketch cells and its top-8-bit histogram bin.  ``ids``:
    key tensor or uint32 ids ``[Q, 5]`` (any leading shape; flattened).
    Adds in place and returns ``(sketch, hist)``.  Nothing here reads the
    device back."""
    q = _keys(ids, sketch.device).reshape(-1, N_LIMBS)
    cells = _flat_cells(sketch, q)
    sketch.view(-1).index_add_(
        0, cells, torch.ones(cells.shape, dtype=torch.int32,
                             device=sketch.device))
    bins = ((q[:, 0] >> (32 - BIN_BITS)) + (1 << (BIN_BITS - 1))).long()
    hist.index_add_(0, bins, torch.ones(bins.shape, dtype=torch.int32,
                                        device=hist.device))
    return sketch, hist


def sketch_query(sketch: torch.Tensor, ids) -> torch.Tensor:
    """Point estimates for a batch of ids: int32 ``[Q]`` = min over the
    ``depth`` rows — the classic CMS read (>= the true count, always)."""
    q = _keys(ids, sketch.device).reshape(-1, N_LIMBS)
    vals = sketch.reshape(-1)[_flat_cells(sketch, q)]
    return vals.reshape(q.shape[0], int(sketch.shape[0])).amin(dim=-1)


def sketch_decay(sketch: torch.Tensor, hist: torch.Tensor, factor: float):
    """Exponential decay: scale every counter by ``factor`` (float32,
    floor) so the sketch holds a window of recent traffic, not a
    lifetime sum; the overestimate invariant is preserved, since floor
    is monotone and applied uniformly.  Exact for counts below 2^24.
    Returns new tensors."""
    if not 0.0 <= factor <= 1.0:
        raise ValueError(f"decay factor {factor} outside [0, 1]")
    f = float(np.float32(factor))      # the JAX program's float32 factor
    return tuple(torch.floor(t.to(torch.float32) * f).to(torch.int32)
                 for t in (sketch, hist))
