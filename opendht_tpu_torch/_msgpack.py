"""The port's own msgpack codec, in pure Python.

The JAX package encodes every packet and value with the ``msgpack``
wheel (``utils.pack_msg`` = ``msgpack.packb(obj, use_bin_type=True)``,
``unpack_msg`` = ``msgpack.unpackb(raw=False, strict_map_key=False)``).
The card's machine has no such wheel, so the port carries this codec
and uses it everywhere, whether or not the wheel happens to be
installed: one codec on every machine, never a silent switch.

Encoding is byte-identical to ``packb(obj, use_bin_type=True)``:

- ``None`` / ``False`` / ``True`` → 0xc0 / 0xc2 / 0xc3;
- ints at their smallest width: non-negative as positive fixint /
  uint8 / uint16 / uint32 / uint64, negative as negative fixint /
  int8 / int16 / int32 / int64; outside [-2^63, 2^64) raises
  OverflowError (bool is tested before int, as the wheel does);
- ``float`` → float64 (0xcb);
- ``str`` → fixstr / str8 / str16 / str32 (UTF-8);
- ``bytes`` / ``bytearray`` / ``memoryview`` → bin8 / bin16 / bin32;
- ``dict`` → fixmap / map16 / map32 in iteration order;
- ``list`` / ``tuple`` → fixarray / array16 / array32;
- :class:`ExtType` → fixext / ext8 / ext16 / ext32;
- anything else raises TypeError.

Decoding equals ``unpackb(raw=False, strict_map_key=False)``: str
decodes as UTF-8 (strict), bin as bytes, arrays as lists, maps as dicts
(any hashable key), float32 and float64 as float.  Errors are
ValueError subclasses as in the wheel: :class:`ExtraData` for trailing
bytes, ValueError for incomplete input, :class:`FormatError` for the
never-used byte 0xc1, UnicodeDecodeError for bad UTF-8; an unhashable
map key raises TypeError.  One difference: every ext type, the
timestamp type -1 included, decodes as :class:`ExtType` (the wheel
turns -1 into its own ``Timestamp``); no packet or value of the
protocol carries an ext type.
"""

from __future__ import annotations

import struct
from collections import namedtuple
from typing import Any, Iterator

__all__ = ["packb", "unpackb", "unpack_stream", "ExtType", "ExtraData",
           "FormatError"]

ExtType = namedtuple("ExtType", "code data")


class ExtraData(ValueError):
    """``unpackb`` found bytes after the first object."""


class FormatError(ValueError):
    """The input holds a byte that no msgpack type starts with."""


class _OutOfData(Exception):
    """The input ended inside an object (internal)."""


_B = struct.Struct(">B").pack
_H = struct.Struct(">H").pack
_I = struct.Struct(">I").pack
_Q = struct.Struct(">Q").pack
_b = struct.Struct(">b").pack
_h = struct.Struct(">h").pack
_i = struct.Struct(">i").pack
_q = struct.Struct(">q").pack
_d = struct.Struct(">d").pack


# ================================================================= encode
def _pack_int(n: int, out: bytearray) -> None:
    if n >= 0:
        if n <= 0x7F:
            out.append(n)
        elif n <= 0xFF:
            out += b"\xcc" + _B(n)
        elif n <= 0xFFFF:
            out += b"\xcd" + _H(n)
        elif n <= 0xFFFFFFFF:
            out += b"\xce" + _I(n)
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + _Q(n)
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -32:
        out += _b(n)
    elif n >= -0x80:
        out += b"\xd0" + _b(n)
    elif n >= -0x8000:
        out += b"\xd1" + _h(n)
    elif n >= -0x80000000:
        out += b"\xd2" + _i(n)
    elif n >= -0x8000000000000000:
        out += b"\xd3" + _q(n)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, c8: int, c16: int, c32: int,
              out: bytearray) -> None:
    """A length header: fixed form below ``fix_max``, else the smallest
    of the 8 / 16 / 32-bit forms (``c8`` < 0: no 8-bit form)."""
    if n < fix_max:
        out.append(fix | n)
    elif c8 >= 0 and n <= 0xFF:
        out.append(c8)
        out.append(n)
    elif n <= 0xFFFF:
        out.append(c16)
        out += _H(n)
    elif n <= 0xFFFFFFFF:
        out.append(c32)
        out += _I(n)
    else:
        raise ValueError("object too large to pack")


def _pack_bin(b, out: bytearray) -> None:
    n = len(b)
    if n <= 0xFF:
        out.append(0xC4)
        out.append(n)
    elif n <= 0xFFFF:
        out.append(0xC5)
        out += _H(n)
    elif n <= 0xFFFFFFFF:
        out.append(0xC6)
        out += _I(n)
    else:
        raise ValueError("bin too large to pack")
    out += b


def _pack(obj: Any, out: bytearray, depth: int) -> None:
    if depth < 0:
        raise ValueError("recursion limit exceeded")
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _d(obj)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_bin(obj, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, 0xD9, 0xDA, 0xDB, out)
        out += b
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, -1, 0xDE, 0xDF, out)
        for k, v in obj.items():
            _pack(k, out, depth - 1)
            _pack(v, out, depth - 1)
    elif isinstance(obj, ExtType):
        _pack_ext(obj, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, -1, 0xDC, 0xDD, out)
        for v in obj:
            _pack(v, out, depth - 1)
    elif isinstance(obj, memoryview):
        _pack_bin(obj.tobytes(), out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack_ext(ext: ExtType, out: bytearray) -> None:
    code, data = int(ext.code), bytes(ext.data)
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += b"\xc7" + _B(n)
    elif n <= 0xFFFF:
        out += b"\xc8" + _H(n)
    else:
        out += b"\xc9" + _I(n)
    out += _b(code)
    out += data


def packb(obj: Any) -> bytes:
    """Encode ``obj`` exactly as ``msgpack.packb(obj, use_bin_type=True)``."""
    out = bytearray()
    _pack(obj, out, 511)
    return bytes(out)


# ================================================================= decode
_u16 = struct.Struct(">H").unpack_from
_u32 = struct.Struct(">I").unpack_from
_u64 = struct.Struct(">Q").unpack_from
_s8 = struct.Struct(">b").unpack_from
_s16 = struct.Struct(">h").unpack_from
_s32 = struct.Struct(">i").unpack_from
_s64 = struct.Struct(">q").unpack_from
_f32 = struct.Struct(">f").unpack_from
_f64 = struct.Struct(">d").unpack_from

# fixed-width scalars: first byte -> (payload size, reader)
_SCALAR = {
    0xCA: (4, _f32), 0xCB: (8, _f64),
    0xCC: (1, lambda b, p: (b[p],)), 0xCD: (2, _u16), 0xCE: (4, _u32),
    0xCF: (8, _u64),
    0xD0: (1, _s8), 0xD1: (2, _s16), 0xD2: (4, _s32), 0xD3: (8, _s64),
}
# (length-field size, kind) of the sized types
_SIZED = {
    0xC4: (1, "bin"), 0xC5: (2, "bin"), 0xC6: (4, "bin"),
    0xC7: (1, "ext"), 0xC8: (2, "ext"), 0xC9: (4, "ext"),
    0xD9: (1, "str"), 0xDA: (2, "str"), 0xDB: (4, "str"),
    0xDC: (2, "array"), 0xDD: (4, "array"),
    0xDE: (2, "map"), 0xDF: (4, "map"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _need(buf, pos: int, n: int) -> None:
    if pos + n > len(buf):
        raise _OutOfData


def _decode(buf, pos: int, depth: int):
    """One object at ``pos`` → (object, next position)."""
    if depth < 0:
        raise ValueError("recursion limit exceeded")
    _need(buf, pos, 1)
    c = buf[pos]
    pos += 1
    if c <= 0x7F:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if 0xA0 <= c <= 0xBF:
        return _str(buf, pos, c & 0x1F)
    if 0x90 <= c <= 0x9F:
        return _array(buf, pos, c & 0x0F, depth)
    if 0x80 <= c <= 0x8F:
        return _map(buf, pos, c & 0x0F, depth)
    if c == 0xC0:
        return None, pos
    if c == 0xC2:
        return False, pos
    if c == 0xC3:
        return True, pos
    sc = _SCALAR.get(c)
    if sc is not None:
        size, read = sc
        _need(buf, pos, size)
        return read(buf, pos)[0], pos + size
    sz = _SIZED.get(c)
    if sz is not None:
        lsize, kind = sz
        _need(buf, pos, lsize)
        n = (buf[pos] if lsize == 1 else
             _u16(buf, pos)[0] if lsize == 2 else _u32(buf, pos)[0])
        pos += lsize
        if kind == "bin":
            _need(buf, pos, n)
            return bytes(buf[pos:pos + n]), pos + n
        if kind == "str":
            return _str(buf, pos, n)
        if kind == "array":
            return _array(buf, pos, n, depth)
        if kind == "map":
            return _map(buf, pos, n, depth)
        return _ext(buf, pos, n)
    n = _FIXEXT.get(c)
    if n is not None:
        return _ext(buf, pos, n)
    raise FormatError(f"unknown msgpack type byte 0x{c:02x}")


def _str(buf, pos: int, n: int):
    _need(buf, pos, n)
    return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n


def _ext(buf, pos: int, n: int):
    _need(buf, pos, 1 + n)
    return ExtType(_s8(buf, pos)[0], bytes(buf[pos + 1:pos + 1 + n])), \
        pos + 1 + n


def _array(buf, pos: int, n: int, depth: int):
    out = []
    for _ in range(n):
        v, pos = _decode(buf, pos, depth - 1)
        out.append(v)
    return out, pos


def _map(buf, pos: int, n: int, depth: int):
    out = {}
    for _ in range(n):
        k, pos = _decode(buf, pos, depth - 1)
        v, pos = _decode(buf, pos, depth - 1)
        out[k] = v
    return out, pos


def unpackb(data) -> Any:
    """Decode exactly one object, as
    ``msgpack.unpackb(data, raw=False, strict_map_key=False)``."""
    buf = bytes(data)
    try:
        obj, pos = _decode(buf, 0, 1023)
    except _OutOfData:
        raise ValueError("Unpack failed: incomplete input") from None
    if pos != len(buf):
        raise ExtraData("unpack(b) received extra data.")
    return obj


def unpack_stream(data) -> Iterator[Any]:
    """Iterate over concatenated objects, as a fed
    ``msgpack.Unpacker(raw=False, strict_map_key=False)``: an object
    cut off by the end of the input ends the iteration silently."""
    buf = bytes(data)
    pos = 0
    while pos < len(buf):
        try:
            obj, pos = _decode(buf, pos, 1023)
        except _OutOfData:
            return
        yield obj
