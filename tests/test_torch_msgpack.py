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


# ------------------------------------------------- the incremental Unpacker
# the frames of the subprocess cluster's RPC channel (testing/
# subproc_cluster.py), both ways, for every op
_KEY = bytes(range(20))
RPC_FRAMES = [
    {"op": "launch", "n": 8},
    {"ok": True, "ports": [40001, 40002, 65535], "ids": [_KEY, _KEY[::-1]]},
    {"op": "resize", "n": 0}, {"ok": True, "n": 0},
    {"op": "bootstrap", "host": "127.0.0.1", "port": 4222}, {"ok": True},
    {"op": "put", "key": _KEY, "value": b"v" * 300},
    {"ok": True, "stored": True},
    {"op": "get", "key": _KEY},
    {"ok": True, "values": [b"a", b"b" * 70000, b""]},
    {"op": "ids"}, {"ok": True, "ids": [_KEY] * 32},
    {"op": "stats"}, {"ok": True, "n": 8, "msgs": 2**40},
    {"op": "quit"},
    {"ok": False, "error": "Traceback ...\nRuntimeError: é no CUDA"},
]


def _wheel_objects(data: bytes, cuts, **kw) -> list:
    up = msgpack.Unpacker(**kw)
    return _fed(up, data, cuts)


def _fed(up, data: bytes, cuts) -> list:
    """Feed ``data`` in the pieces ``cuts`` makes, iterating after each;
    the objects, then the first error's type and, for a plain ValueError,
    TypeError or UnicodeDecodeError, its text (the wheel's FormatError
    and StackError carry none; the port's say what they found)."""
    out, last = [], 0
    for c in list(cuts) + [len(data)]:
        up.feed(data[last:c])
        last = c
        try:
            out.extend(up)
        except Exception as e:              # noqa: BLE001 - compared
            text = str(e) if type(e) in (ValueError, TypeError,
                                         UnicodeDecodeError) else ""
            return out + [("error", type(e).__name__, text)]
    return out


def _port_objects(data: bytes, cuts, **kw) -> list:
    """The port's Unpacker takes only ``raw=``.  The wheel's other knobs
    a case sets are the port's module limit (``max_buffer_size``) and
    ``unpack_stream``, whose Unpacker has ``strict_map_key=False``."""
    size = kw.pop("max_buffer_size", M.MAX_BUFFER_SIZE)
    strict = kw.pop("strict_map_key", True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "MAX_BUFFER_SIZE", size)
        up = M.Unpacker(**kw) if strict else M.unpack_stream(b"")
        return _fed(up, data, cuts)


def test_rpc_frames_are_the_wheels_bytes():
    for f in RPC_FRAMES:
        assert M.packb(f) == msgpack.packb(f, use_bin_type=True), f


@pytest.mark.parametrize("raw", [True, False])
def test_rpc_stream_at_every_split_point(raw):
    data = b"".join(M.packb(f) for f in RPC_FRAMES
                    if len(M.packb(f)) < 4096)
    want = _wheel_objects(data, [], raw=raw)
    assert len(want) == len(RPC_FRAMES) - 1
    for cut in range(len(data) + 1):
        assert _port_objects(data, [cut], raw=raw) == want, cut


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("raw", [True, False])
def test_seeded_objects_at_random_chunkings(seed, raw):
    import random
    rng = random.Random(seed)

    def obj(depth=0):
        kind = rng.randrange(10 if depth < 4 else 6)
        if kind == 0:
            return rng.choice([None, True, False])
        if kind == 1:
            return rng.randrange(-2**63, 2**64)
        if kind == 2:
            return rng.random() * 10 ** rng.randrange(-5, 300)
        if kind == 3:
            return "".join(chr(rng.randrange(32, 0x3000))
                           for _ in range(rng.choice([0, 3, 31, 32, 300])))
        if kind == 4:
            return rng.randbytes(rng.choice([0, 1, 255, 256, 70000]))
        if kind == 5:
            return rng.randrange(-32, 128)
        if kind in (6, 7):
            return [obj(depth + 1) for _ in range(rng.choice([0, 2, 16]))]
        return {rng.choice(["k%d" % i, b"b%d" % i]): obj(depth + 1)
                for i in range(rng.choice([0, 3, 16]))}
    objs = [obj() for _ in range(40)]
    data = b"".join(M.packb(o) for o in objs)
    assert data == b"".join(ref_pack(o) for o in objs)
    for trial in range(4):
        cuts = sorted(rng.randrange(len(data) + 1)
                      for _ in range(rng.choice([1, 7, 60])))
        want = _wheel_objects(data, cuts, raw=raw)
        assert len(want) == len(objs)
        assert _port_objects(data, cuts, raw=raw) == want


UNPACKER_CASES = [
    (b"\xc1\x01", {}),                                  # never-used byte
    (b"\x01\x91" + b"\x91" * 1024 + b"\x01", {}),       # 1,025 deep
    (b"\x91" * 1023 + b"\x01\x02", {}),                  # 1,024 deep: fine
    (b"\x91" * 1024 + b"\x90", {}),                      # empty, too deep
    (b"\xa2\xff\xfe\x01", {}),                           # bad UTF-8
    (b"\xa2\xff\xfe\x01", {"raw": True}),                # ... is raw
    (b"\x81\x01\x02", {}),                               # int key, strict
    (b"\x81\x01\x02", {"strict_map_key": False}),
    (b"\x81\xc0\x01", {}),                               # None key
    (b"\x81\x91\x01\x02", {"strict_map_key": False}),    # unhashable key
    (b"\x9b\x01", {"max_buffer_size": 10}),              # 11 > 10
    (b"\x01\xdc\x00\x0b", {"max_buffer_size": 10}),
    (b"\x85\x01", {"max_buffer_size": 10}),              # 5: fits
    (b"\x86\x01", {"max_buffer_size": 10}),              # 6 > 10 // 2
    (b"\xde\x00\x06", {"max_buffer_size": 10}),
    (b"\xc4\x0aabcdefgh", {"max_buffer_size": 10}),      # never whole
    (b"\xdd\xff\xff\xff\xff", {}),                        # 2**32 - 1
    (b"\xc7\x00\x05\xd5\x02ab", {}),                     # ext types
    # past the recursive decoder's depth: the stack decoder's checks
    (b"\x91" * 100 + b"\x81\x01\x02", {}),                # int key, strict
    (b"\x91" * 100 + b"\x81\x91\x01\x02", {"strict_map_key": False}),
    (b"\x91" * 100 + b"\xdd\xff\xff\xff\xff", {}),        # 2**32 - 1
    (b"\x91" * 100 + b"\xa2\xff\xfe", {}),                # bad UTF-8
]


@pytest.mark.parametrize("data,kw", UNPACKER_CASES,
                         ids=[f"{d[:4].hex()}-{len(d)}B-{'-'.join(kw)}"
                              for d, kw in UNPACKER_CASES])
def test_unpacker_errors_and_limits_match_the_wheel(data, kw):
    want = _wheel_objects(data, [], **kw)
    assert _port_objects(data, [], **kw) == want
    for cut in range(len(data) + 1):
        assert _port_objects(data, [cut], **kw) == \
            _wheel_objects(data, [cut], **kw), cut


def test_unpacker_buffer_limit_and_unpack(monkeypatch):
    monkeypatch.setattr(M, "MAX_BUFFER_SIZE", 4)
    for up, mod in ((msgpack.Unpacker(max_buffer_size=4), msgpack),
                    (M.Unpacker(), M)):
        up.feed(b"\x01\x02\x03")
        assert up.unpack() == 1
        up.feed(b"\x04\x05")                 # 2 unread + 2 new: fits
        assert list(up) == [2, 3, 4, 5]
        with pytest.raises(mod.OutOfData):
            up.unpack()
        with pytest.raises(mod.BufferFull):
            up.feed(b"\x00" * 5)
    assert issubclass(M.StackError, ValueError)
    assert issubclass(M.BufferFull, M.UnpackException)


def test_unpackb_decodes_what_the_wheel_decodes_at_depth():
    """Past the recursive decoder's depth an explicit stack takes over:
    every nesting depth the wheel takes decodes, and one deeper fails as
    the wheel fails."""
    for depth in (63, 64, 65, 500, 1024):
        raw = b"\x91" * depth + b"\x01"
        assert M.unpackb(raw) == ref_unpack(raw)
        mixed = b"\x92\x81\xa1k" * (depth // 2) + b"\xc0" + \
            b"\x01" * (depth // 2)
        assert M.unpackb(mixed) == ref_unpack(mixed)
    raw = b"\x91" * 1025 + b"\x01"
    with pytest.raises(msgpack.StackError):
        ref_unpack(raw)
    with pytest.raises(M.StackError):
        M.unpackb(raw)
