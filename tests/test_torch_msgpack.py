"""The port's pure-Python msgpack codec against the ``msgpack`` wheel.

``opendht_tpu_torch._msgpack.packb`` must emit exactly the bytes of
``msgpack.packb(obj, use_bin_type=True)`` and ``unpackb`` must decode as
``msgpack.unpackb(raw=False, strict_map_key=False)``: on a corpus of
every width boundary, on a hypothesis sweep of nested objects, and on
the wire goldens (written by the independent spec encoder
tests/goldens/mini_msgpack.py)."""

from __future__ import annotations

import glob
import math
import os

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from opendht_tpu_torch import _msgpack as M
from opendht_tpu_torch import utils as port_utils

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def ref_pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def ref_unpack(data: bytes):
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


_INT_EDGES = [0, 1, 31, 32, 127, 128, 255, 256, 65535, 65536,
              2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63,
              2**64 - 1]
INTS = sorted(set(_INT_EDGES + [-n for n in _INT_EDGES[1:]]
                  + [-33, -129, -32768, -32769, -2**31 - 1, -2**63]),
              key=abs)
INTS = [n for n in INTS if -2**63 <= n < 2**64]
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("n", INTS)
def test_int_widths(n):
    assert M.packb(n) == ref_pack(n)
    assert M.unpackb(ref_pack(n)) == n


@pytest.mark.parametrize("n", [2**64, -2**63 - 1, 10**30])
def test_int_out_of_range_raises(n):
    with pytest.raises(OverflowError):
        ref_pack(n)
    with pytest.raises(OverflowError):
        M.packb(n)


@pytest.mark.parametrize("n", LENGTHS)
def test_str_and_bin_lengths(n):
    for obj in ("é" * (n // 2) + "a" * (n % 2), "x" * n, b"\x00" * n,
                bytearray(b"\x01" * n)):
        assert M.packb(obj) == ref_pack(obj), (type(obj), n)
        assert M.unpackb(ref_pack(obj)) == ref_unpack(ref_pack(obj))
    assert M.packb(memoryview(b"\x02" * n)) == ref_pack(b"\x02" * n)


@pytest.mark.parametrize("n", LENGTHS)
def test_array_and_map_sizes(n):
    arr = list(range(n))
    tup = tuple(str(i) for i in range(n))
    mp = {i: b"v" for i in range(n)}
    for obj in (arr, tup, mp):
        assert M.packb(obj) == ref_pack(obj), (type(obj), n)
        assert M.unpackb(ref_pack(obj)) == ref_unpack(ref_pack(obj))


@pytest.mark.parametrize("obj", [
    None, True, False, 0.0, -0.0, 1.5, -2.25e300, math.inf, -math.inf,
    {"a": [1, {"b": b"c", 3: None}], b"k": (True, -1.0)},
    [[[[[]]]], {}, "", b""],
    {"y": "q", "q": "get", "a": {"id": b"\xaa" * 20, "w": [1, 2]},
     "t": b"\x01\x02\x03\x04", "v": "RNG1"},
], ids=lambda o: type(o).__name__)
def test_scalars_and_nesting(obj):
    assert M.packb(obj) == ref_pack(obj)
    assert M.unpackb(ref_pack(obj)) == ref_unpack(ref_pack(obj))


def test_nan_and_float32():
    assert M.packb(math.nan) == ref_pack(math.nan)
    f32 = b"\xca" + bytes.fromhex("3fc00000")
    assert M.unpackb(f32) == ref_unpack(f32) == 1.5


def test_ext_types():
    for code, data in ((5, b"a"), (0, b"ab"), (7, b"abcd"), (1, b"x" * 8),
                       (2, b"y" * 16), (3, b"z" * 3), (4, b"w" * 300),
                       (6, b"v" * 70000)):
        raw = ref_pack(msgpack.ExtType(code, data))
        assert M.packb(M.ExtType(code, data)) == raw
        assert M.unpackb(raw) == M.ExtType(code, data)


def test_unsupported_type_raises():
    with pytest.raises(TypeError):
        M.packb(object())
    with pytest.raises(TypeError):
        M.packb({1, 2})


@pytest.mark.parametrize("data,wheel_exc,port_exc", [
    (b"\x92\x01", ValueError, ValueError),      # array cut short
    (b"\xd9", ValueError, ValueError),          # str8 without its length
    (b"\x01\x02", msgpack.ExtraData, M.ExtraData),     # trailing bytes
    (b"\xc1", msgpack.FormatError, M.FormatError),     # never-used byte
    (b"\xa2\xff\xfe", UnicodeDecodeError, UnicodeDecodeError),
    (b"\x81\x91\x01\x02", TypeError, TypeError),  # list as a map key
])
def test_decode_errors_match_the_wheel(data, wheel_exc, port_exc):
    """The same failure, and a ValueError wherever the wheel's is one."""
    with pytest.raises(wheel_exc) as w:
        ref_unpack(data)
    with pytest.raises(port_exc):
        M.unpackb(data)
    assert isinstance(w.value, ValueError) == issubclass(port_exc,
                                                         ValueError)


def test_unpack_stream_matches_unpacker():
    objs = [1, [1, 2], {"a": b"b"}, "s" * 40, None]
    raw = b"".join(ref_pack(o) for o in objs)
    for cut in (len(raw), len(raw) - 1):
        up = msgpack.Unpacker(raw=False, strict_map_key=False)
        up.feed(raw[:cut])
        assert list(M.unpack_stream(raw[:cut])) == list(up)
    assert list(port_utils.unpack_stream(raw)) == objs


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(GOLDENS,
                                                               "*.bin"))),
                         ids=os.path.basename)
def test_goldens_decode_and_reencode(path):
    """Every golden packet (a stream of maps for the value-parts files)
    decodes as the wheel decodes it and re-encodes to the same bytes."""
    raw = open(path, "rb").read()
    up = msgpack.Unpacker(raw=False, strict_map_key=False)
    up.feed(raw)
    want = list(up)
    got = list(M.unpack_stream(raw))
    assert got == want
    assert b"".join(M.packb(o) for o in got) == raw


_leaf = (st.none() | st.booleans()
         | st.integers(min_value=-2**63, max_value=2**64 - 1)
         | st.floats(allow_nan=False) | st.text(max_size=300)
         | st.binary(max_size=300))
_obj = st.recursive(
    _leaf,
    lambda kids: (st.lists(kids, max_size=20)
                  | st.dictionaries(st.integers(-2**40, 2**40)
                                    | st.text(max_size=40)
                                    | st.binary(max_size=40), kids,
                                    max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_obj)
def test_hypothesis_roundtrip_and_bytes(obj):
    raw = ref_pack(obj)
    assert M.packb(obj) == raw
    assert M.unpackb(raw) == ref_unpack(raw)
    assert port_utils.unpack_msg(port_utils.pack_msg(obj)) == ref_unpack(raw)
