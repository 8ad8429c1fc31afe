"""160-bit identifiers as limb tensors.

Ids are five 32-bit limbs in big-endian limb order (limb 0 holds bytes
0..3, the most significant), so lexicographic byte order is
lexicographic limb order.  The numpy codec (``ids_from_bytes`` …) is a
copy of the JAX package's and works on uint32 arrays.

**The key domain.**  torch has uint32 ``^``, sort and indexing, but no
uint32 ``<``, ``min``, ``>>`` or ``searchsorted``.  So every 160-bit
quantity the port holds in a tensor — ids and XOR distances alike — is
int32 in the sign-flipped domain: ``key = u ^ 0x80000000`` viewed as
int32 (numerically ``u - 2**31``).  Signed order on keys is unsigned
order on the ids, and the domain is closed under the XOR metric:
``xor_ids(a, b) = a ^ b ^ FLIP`` is the key of the distance, and
``xor_ids(q, dist)`` gives back the key of the id.  ``a ^ b`` alone is
the *raw* distance bits, which is what ``clz32`` and the CUDA kernels
read.  Bit masks (``get_bit``, ``set_bit``, prefix masks) act on raw
bits too: un-flip, mask, re-flip.  ``to_keys`` / ``from_keys`` convert
at the numpy boundary; public results leave the package as uint32 numpy
identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

HASH_BYTES = 20
N_LIMBS = 5
ID_BITS = 160

FLIP = -(1 << 31)          # int32 bit pattern 0x80000000
KEY_MAX = (1 << 31) - 1    # key of the uint32 all-ones limb


# ---------------------------------------------------------------------------
# host codec (numpy uint32, copied from the JAX package)
# ---------------------------------------------------------------------------

def ids_from_bytes(raw) -> np.ndarray:
    """Pack id bytes into big-endian uint32 limbs.

    `raw`: bytes of length 20*n, or uint8 array [..., 20].
    Returns uint32 [..., 5] (numpy).
    """
    if isinstance(raw, (bytes, bytearray, memoryview)):
        if len(raw) % HASH_BYTES:
            raise ValueError(
                f"id buffer length {len(raw)} is not a multiple of {HASH_BYTES}"
            )
        arr = np.frombuffer(bytes(raw), dtype=np.uint8).reshape(-1, HASH_BYTES)
    else:
        arr = np.asarray(raw, dtype=np.uint8)
    if arr.shape[-1] != HASH_BYTES:
        raise ValueError(f"expected trailing dim {HASH_BYTES}, got {arr.shape}")
    # big-endian: limb = b0<<24 | b1<<16 | b2<<8 | b3
    limbs = arr.reshape(arr.shape[:-1] + (N_LIMBS, 4)).astype(np.uint32)
    return (
        (limbs[..., 0] << 24)
        | (limbs[..., 1] << 16)
        | (limbs[..., 2] << 8)
        | limbs[..., 3]
    )


def ids_to_bytes(ids) -> np.ndarray:
    """Inverse of :func:`ids_from_bytes` → uint8 [..., 20]."""
    ids = np.asarray(ids, dtype=np.uint32)
    out = np.empty(ids.shape[:-1] + (N_LIMBS, 4), dtype=np.uint8)
    out[..., 0] = (ids >> 24) & 0xFF
    out[..., 1] = (ids >> 16) & 0xFF
    out[..., 2] = (ids >> 8) & 0xFF
    out[..., 3] = ids & 0xFF
    return out.reshape(ids.shape[:-1] + (HASH_BYTES,))


def ids_from_hashes(hashes) -> np.ndarray:
    """Pack an iterable of :class:`opendht_tpu_torch.infohash.InfoHash`
    → uint32 [n, 5]."""
    return ids_from_bytes(b"".join(bytes(h) for h in hashes))


def random_ids(generator: torch.Generator, n: int,
               device=None) -> torch.Tensor:
    """Uniformly random ids as an int32 key tensor [n, 5] on ``device``
    (None = cuda), drawn from ``generator`` on its own device
    (↔ InfoHash::getRandom, infohash.h:314-325).  Every int32 is a key,
    so uniform keys are uniform ids."""
    keys = torch.randint(-(1 << 31), 1 << 31, (n, N_LIMBS),
                         dtype=torch.int32, generator=generator,
                         device=generator.device)
    return keys.to(resolve_device(device))


# ---------------------------------------------------------------------------
# numpy uint32 <-> key tensors
# ---------------------------------------------------------------------------

def to_keys(u32, device=None) -> torch.Tensor:
    """uint32 array-like → int32 key tensor on ``device`` (None = cuda)."""
    a = np.ascontiguousarray(np.asarray(u32, dtype=np.uint32)
                             ^ np.uint32(0x80000000))
    return torch.from_numpy(a.view(np.int32)).to(resolve_device(device))


def as_keys(x, device=None) -> torch.Tensor:
    """A key tensor moved to ``device``, or uint32 ids converted with
    :func:`to_keys` (None = cuda)."""
    if isinstance(x, torch.Tensor):
        return x.to(resolve_device(device))
    return to_keys(x, device)


def from_keys(keys: torch.Tensor) -> np.ndarray:
    """int32 key tensor → uint32 numpy (the JAX package's representation)."""
    a = keys.detach().to("cpu", torch.int32).contiguous().numpy()
    return a.view(np.uint32) ^ np.uint32(0x80000000)


# ---------------------------------------------------------------------------
# id math on key tensors
# ---------------------------------------------------------------------------

def xor_ids(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Key of the XOR distance of two key tensors (broadcasts)."""
    return a ^ b ^ FLIP


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of each 32-bit pattern (``x`` int32 holding the raw
    bits, e.g. ``a ^ b`` of two keys); 32 for 0.  int32."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    n = torch.zeros_like(u)
    for s in (16, 8, 4, 2, 1):
        top_zero = u < (1 << (32 - s))
        n = n + torch.where(top_zero, s, 0)
        u = torch.where(top_zero, u << s, u)
    return torch.where(u == 0, 32, n).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit pattern (``x`` int32 holding raw bits).
    int32."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return ((u * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def ctz32(x: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of each 32-bit pattern (``x`` int32 holding raw
    bits); 32 for 0.  int32."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    # the bits below the lowest set bit (all 32 for 0)
    return popcount32(~u & (u - 1))


def common_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Length of the shared bit prefix of two key tensors [..., 5],
    0..160 (↔ Hash::commonBits, infohash.h:154-176).  int32 [...]."""
    x = a ^ b                                   # raw difference bits
    nz = x != 0
    # the first differing limb (argmax returns the first maximum), then
    # ONE clz32 of it: a table sweep runs this over every row
    first = nz.to(torch.uint8).argmax(dim=-1, keepdim=True)
    cb = 32 * first[..., 0].to(torch.int32) \
        + clz32(torch.gather(x, -1, first)[..., 0])
    return torch.where(nz.any(dim=-1), cb, ID_BITS)


def _lex_fold(a: torch.Tensor, b: torch.Tensor):
    """(lt, eq) of the lexicographic limb compare of key tensors
    [..., 5] (broadcasts)."""
    # limb 0 starts the fold: torch.broadcast_shapes imports sympy at
    # its first call (~4 s on the H100 host, PERF.md §6)
    lt, eq = a[..., 0] < b[..., 0], a[..., 0] == b[..., 0]
    for i in range(1, N_LIMBS):
        ai, bi = a[..., i], b[..., i]
        lt = lt | (eq & (ai < bi))
        eq = eq & (ai == bi)
    return lt, eq


def lex_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b in lexicographic limb order, over key tensors [..., 5]."""
    return _lex_fold(a, b)[0]


def lex_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a == b over key tensors [..., 5].  bool [...]."""
    return (a == b).all(dim=-1)


def lex_cmp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """memcmp-style -1/0/1 of key tensors [..., 5] (↔ Hash::cmp,
    infohash.h:149-151).  int32 [...]."""
    lt, eq = _lex_fold(a, b)
    return torch.where(eq, 0, torch.where(lt, -1, 1)).to(torch.int32)


def xor_cmp(self_id: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """-1 if ``a`` is XOR-closer to ``self_id`` than ``b``, 1 farther, 0
    tied (↔ Hash::xorCmp, infohash.h:179-194); key tensors [..., 5],
    broadcasting over batch dims.  int32 [...]."""
    return lex_cmp(xor_ids(a, self_id), xor_ids(b, self_id))


# single-bit masks of a limb, bit 0 = the MSB, as int32 bit patterns (a
# table rather than ``1 << s``, which would shift into the int32 sign bit)
_BIT_MASKS = (np.uint32(1) << np.arange(31, -1, -1, dtype=np.uint32)) \
    .view(np.int32)


def _bit_mask(nbit: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_BIT_MASKS).to(nbit.device)[(nbit % 32).long()]


def lowbit(a: torch.Tensor) -> torch.Tensor:
    """Index (tree depth from the MSB) of the lowest set bit of each key
    tensor [..., 5]; -1 when zero (↔ Hash::lowbit, infohash.h:132-143).
    int32 [...]."""
    raw = (a ^ FLIP).to(torch.int64) & 0xFFFFFFFF
    out = torch.full(a.shape[:-1], -1, dtype=torch.int32, device=a.device)
    later_zero = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for i in range(N_LIMBS - 1, -1, -1):
        ai = raw[..., i]
        last = later_zero & (ai != 0)
        # the isolated lowest bit's leading zeros = 31 - its trailing zeros
        out = torch.where(last, 32 * i + clz32(ai & -ai), out)
        later_zero = later_zero & (ai == 0)
    return out


def get_bit(a: torch.Tensor, nbit) -> torch.Tensor:
    """Bit ``nbit`` of each key tensor [..., 5], counting from the MSB
    (↔ Hash::getBit, infohash.h:196-202).  ``nbit`` broadcasts against
    the batch shape and is clamped to [0, 159] like the JAX package's
    device version.  bool [...]."""
    nbit = torch.as_tensor(nbit, dtype=torch.int64, device=a.device) \
        .expand(a.shape[:-1]).clamp(0, ID_BITS - 1)
    limb = torch.gather(a ^ FLIP, -1, (nbit // 32)[..., None])[..., 0]
    return (limb & _bit_mask(nbit)) != 0


def set_bit(a: torch.Tensor, nbit, value) -> torch.Tensor:
    """Key tensor ``a`` [..., 5] with bit ``nbit`` set to ``value``
    (↔ Hash::setBit).  The mask acts on the raw bits: un-flip, mask,
    re-flip."""
    nbit = torch.as_tensor(nbit, dtype=torch.int64, device=a.device)
    limb_sel = torch.arange(N_LIMBS, device=a.device) \
        == (nbit // 32)[..., None]
    mask = torch.where(limb_sel, _bit_mask(nbit)[..., None], 0)
    v = torch.as_tensor(value, dtype=torch.bool, device=a.device)[..., None]
    raw = a ^ FLIP
    return torch.where(v, raw | mask, raw & ~mask) ^ FLIP
