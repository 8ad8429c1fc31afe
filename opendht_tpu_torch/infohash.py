"""Host-side 160-bit node/key identifiers (the scalar protocol primitive).

This is the host (per-packet, per-node) counterpart of the batched tensor
id math in :mod:`opendht_tpu_torch.ops.ids`, and a copy of the JAX
package's ``infohash`` module with behaviour unchanged (the port imports
nothing of that package).  Semantics match the reference
``Hash<N>`` (reference: include/opendht/infohash.h:61-268):

- ``cmp`` / ``<`` / ``==``  — lexicographic byte order (infohash.h:149-151)
- ``xor_cmp(a, b)``         — which of a, b is XOR-closer to self
  (infohash.h:179-194): first differing byte decides
- ``common_bits(a, b)``     — length of shared bit prefix (infohash.h:154-176)
- ``lowbit``                — index of the lowest set bit, -1 for zero
  (infohash.h:132-143); used for bucket depth computations
- ``get(data)``             — digest of ``data`` sized to the hash length
  (infohash.h:231-236; digest selection by length src/crypto.cpp:208-227:
  20B→SHA1, 32B→SHA256, 64B→SHA512)

The scalar implementations here double as the exactness oracle for the
vectorized id math (tests/test_torch_ops.py).
"""

from __future__ import annotations

import hashlib
import secrets
from functools import total_ordering


def _digest_for_len(data: bytes, n: int) -> bytes:
    """Digest of `data`, truncated/selected by output length like the
    reference's crypto::hash (src/crypto.cpp:208-227)."""
    if n <= 20:
        h = hashlib.sha1(data).digest()
    elif n <= 32:
        h = hashlib.sha256(data).digest()
    else:
        h = hashlib.sha512(data).digest()
    return h[:n]


@total_ordering
class Hash:
    """Fixed-size big-endian identifier. Subclass and set HASH_LEN."""

    HASH_LEN = 20
    __slots__ = ("_b",)

    def __init__(self, value: "bytes | str | Hash | None" = None):
        n = self.HASH_LEN
        if value is None:
            self._b = bytes(n)
        elif isinstance(value, Hash):
            b = value._b
            # converting across hash widths: truncate or treat-as-too-short,
            # same rules as raw bytes below
            self._b = b if len(b) == n else (b[:n] if len(b) > n else bytes(n))
        elif isinstance(value, (bytes, bytearray, memoryview)):
            b = bytes(value)
            # Reference semantics (infohash.h:73-87): too-short input gives a
            # zero hash; too-long input is truncated.
            self._b = b[:n] if len(b) >= n else bytes(n)
        elif isinstance(value, str):
            s = value.strip()
            if len(s) != 2 * n:
                self._b = bytes(n)
            else:
                try:
                    b = bytes.fromhex(s)
                except ValueError:
                    b = b""
                # fromhex skips internal whitespace; enforce exact width
                self._b = b if len(b) == n else bytes(n)
        else:
            raise TypeError(f"cannot build {type(self).__name__} from {type(value)}")

    # -- basic accessors ---------------------------------------------------
    def __bytes__(self) -> bytes:
        return self._b

    @property
    def data(self) -> bytes:
        return self._b

    def __len__(self) -> int:
        return self.HASH_LEN

    def __getitem__(self, i):
        return self._b[i]

    def __bool__(self) -> bool:
        return self._b != bytes(self.HASH_LEN)

    def __hash__(self) -> int:
        return hash(self._b)

    def __eq__(self, other) -> bool:
        return isinstance(other, Hash) and self._b == other._b

    def __lt__(self, other) -> bool:
        return self._b < other._b

    def __repr__(self) -> str:
        return f"{type(self).__name__}('{self.hex()}')"

    def __str__(self) -> str:
        return self.hex()

    def hex(self) -> str:
        return self._b.hex()

    def to_int(self) -> int:
        return int.from_bytes(self._b, "big")

    def to_float(self) -> float:
        """Fractional position of the id in [0, 1) (infohash.h:212-218)."""
        return self.to_int() / (1 << (8 * self.HASH_LEN))

    @classmethod
    def from_int(cls, v: int) -> "Hash":
        return cls(v.to_bytes(cls.HASH_LEN, "big"))

    # -- the XOR metric ----------------------------------------------------
    @staticmethod
    def cmp(a: "Hash", b: "Hash") -> int:
        """Lexicographic compare, memcmp-style (infohash.h:149-151)."""
        return (a._b > b._b) - (a._b < b._b)

    def xor_cmp(self, a: "Hash", b: "Hash") -> int:
        """-1 if `a` is XOR-closer to self than `b`, 1 if farther, 0 if tied
        (infohash.h:179-194)."""
        s = self._b
        for i in range(self.HASH_LEN):
            if a._b[i] == b._b[i]:
                continue
            x1 = a._b[i] ^ s[i]
            x2 = b._b[i] ^ s[i]
            return -1 if x1 < x2 else 1
        return 0

    @staticmethod
    def common_bits(a: "Hash", b: "Hash") -> int:
        """Number of leading bits shared by a and b (infohash.h:154-176)."""
        n = a.HASH_LEN
        for i in range(n):
            if a._b[i] != b._b[i]:
                x = a._b[i] ^ b._b[i]
                j = 0
                while not (x & 0x80):
                    x = (x << 1) & 0xFF
                    j += 1
                return 8 * i + j
        return 8 * n

    def lowbit(self) -> int:
        """Index (from the MSB, i.e. tree depth) of the lowest set bit, or
        -1 when the id is zero (infohash.h:132-143)."""
        b = self._b
        for i in range(self.HASH_LEN - 1, -1, -1):
            if b[i]:
                byte = b[i]
                j = 7
                while not (byte & (0x80 >> j)):
                    j -= 1
                return 8 * i + j
        return -1

    def get_bit(self, nbit: int) -> bool:
        """Bit `nbit` counting from the MSB (infohash.h:196-202)."""
        return bool((self._b[nbit // 8] >> (7 - nbit % 8)) & 1)

    def set_bit(self, nbit: int, value: bool) -> "Hash":
        """Return a copy with bit `nbit` set/cleared (infohash.h:204-210)."""
        arr = bytearray(self._b)
        mask = 1 << (7 - nbit % 8)
        if value:
            arr[nbit // 8] |= mask
        else:
            arr[nbit // 8] &= ~mask
        return type(self)(bytes(arr))

    def xor(self, other: "Hash") -> "Hash":
        if len(other._b) != self.HASH_LEN:
            raise ValueError(
                f"cannot xor {type(self).__name__} with {len(other._b)}-byte hash"
            )
        return type(self)(bytes(x ^ y for x, y in zip(self._b, other._b)))

    # -- constructors ------------------------------------------------------
    @classmethod
    def get(cls, data: "bytes | str") -> "Hash":
        """Hash arbitrary data down to an id (infohash.h:220-236)."""
        if isinstance(data, str):
            data = data.encode()
        return cls(_digest_for_len(bytes(data), cls.HASH_LEN))

    @classmethod
    def get_random(cls) -> "Hash":
        """Uniformly random id (infohash.h:314-325)."""
        return cls(secrets.token_bytes(cls.HASH_LEN))

    @classmethod
    def zero(cls) -> "Hash":
        return cls()


class InfoHash(Hash):
    """160-bit DHT key / node id (infohash.h:267: ``using InfoHash = Hash<20>``)."""

    HASH_LEN = 20


class PkId(Hash):
    """256-bit public-key id (infohash.h:268-270: ``h256 = Hash<32>``)."""

    HASH_LEN = 32


def random_infohash() -> InfoHash:
    return InfoHash.get_random()
