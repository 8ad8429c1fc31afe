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
never-used byte 0xc1, :class:`StackError` past 1,024 nested containers
(an object nested deeper than recursion allows is decoded on an explicit
stack, so any depth the wheel takes decodes),
UnicodeDecodeError for bad UTF-8; an unhashable map key raises
TypeError.  One difference: every ext type, the timestamp type -1
included, decodes as :class:`ExtType` (the wheel turns -1 into its own
``Timestamp``); no packet or value of the protocol carries an ext type.

:class:`Unpacker` is the wheel's fed ``msgpack.Unpacker(raw=...)``:
``feed`` and iteration, the wheel's default buffer and length limits
and its errors (``BufferFull``, ``OutOfData``).  A stream of frames, as
a subprocess cluster's RPC channel carries, is read with it.
"""

from __future__ import annotations

import struct
from collections import namedtuple
from typing import Any, Iterator

__all__ = ["packb", "unpackb", "unpack_stream", "Unpacker", "ExtType",
           "UnpackException", "ExtraData", "FormatError", "StackError",
           "BufferFull", "OutOfData"]

ExtType = namedtuple("ExtType", "code data")


class UnpackException(Exception):
    """Base of the decoder's own errors, as in the wheel."""


class ExtraData(ValueError, UnpackException):
    """``unpackb`` found bytes after the first object."""


class FormatError(ValueError, UnpackException):
    """The input holds a byte that no msgpack type starts with."""


class StackError(ValueError, UnpackException):
    """The input nests more than MAX_DEPTH containers."""


class BufferFull(UnpackException):
    """``Unpacker.feed`` would hold more than MAX_BUFFER_SIZE bytes."""


class OutOfData(UnpackException):
    """``Unpacker.unpack`` found no complete object."""


class _OutOfData(Exception):
    """The input ended inside an object (internal)."""


_NO_KEY = object()       # a map entry whose key is not read yet


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

#: containers open at once, as the wheel's unpacker stack allows
MAX_DEPTH = 1024
#: an Unpacker's buffer, as the wheel's default ``max_buffer_size``; an
#: array header may declare at most this many entries and a map header
#: half as many (the wheel's ``max_array_len`` / ``max_map_len``)
MAX_BUFFER_SIZE = 100 * 1024 * 1024
#: nesting decoded by recursion; a deeper object is decoded again on an
#: explicit stack (Python's recursion limit is below MAX_DEPTH)
_SHALLOW = 64


class _Deep(Exception):
    """The object nests deeper than _SHALLOW (internal)."""


def _need(buf, pos: int, n: int) -> None:
    if pos + n > len(buf):
        raise _OutOfData


def _check_len(is_map: bool, n: int) -> None:
    limit = MAX_BUFFER_SIZE // 2 if is_map else MAX_BUFFER_SIZE
    if n > limit:
        raise ValueError(f"{n} exceeds max_{'map' if is_map else 'array'}"
                         f"_len({limit})")


def _check_key(key) -> None:
    if type(key) not in (str, bytes):
        raise ValueError(f"{type(key).__name__} is not allowed for map key "
                         "when strict_map_key=True")


# ``strict`` below: None decodes as ``unpackb`` (no limits), False as an
# Unpacker with ``strict_map_key=False`` (length limits), True as the
# wheel's default Unpacker (length limits, str / bytes map keys only).
def _decode(buf, pos: int, depth: int, raw: bool, strict):
    """One object at ``pos`` → (object, next position)."""
    _need(buf, pos, 1)
    c = buf[pos]
    pos += 1
    if c <= 0x7F:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if 0xA0 <= c <= 0xBF:
        return _str(buf, pos, c & 0x1F, raw)
    if 0x90 <= c <= 0x9F:
        return _array(buf, pos, c & 0x0F, depth, raw, strict)
    if 0x80 <= c <= 0x8F:
        return _map(buf, pos, c & 0x0F, depth, raw, strict)
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
            return _str(buf, pos, n, raw)
        if kind == "array":
            return _array(buf, pos, n, depth, raw, strict)
        if kind == "map":
            return _map(buf, pos, n, depth, raw, strict)
        return _ext(buf, pos, n)
    n = _FIXEXT.get(c)
    if n is not None:
        return _ext(buf, pos, n)
    raise FormatError(f"unknown msgpack type byte 0x{c:02x}")


def _str(buf, pos: int, n: int, raw: bool):
    _need(buf, pos, n)
    b = bytes(buf[pos:pos + n])
    return (b if raw else b.decode("utf-8")), pos + n


def _ext(buf, pos: int, n: int):
    _need(buf, pos, 1 + n)
    return ExtType(_s8(buf, pos)[0], bytes(buf[pos + 1:pos + 1 + n])), \
        pos + 1 + n


def _array(buf, pos: int, n: int, depth: int, raw: bool, strict):
    if strict is not None:
        _check_len(False, n)
    if depth >= _SHALLOW:
        raise _Deep
    out = []
    for _ in range(n):
        v, pos = _decode(buf, pos, depth + 1, raw, strict)
        out.append(v)
    return out, pos


def _map(buf, pos: int, n: int, depth: int, raw: bool, strict):
    if strict is not None:
        _check_len(True, n)
    if depth >= _SHALLOW:
        raise _Deep
    out = {}
    for _ in range(n):
        k, pos = _decode(buf, pos, depth + 1, raw, strict)
        v, pos = _decode(buf, pos, depth + 1, raw, strict)
        if strict:
            _check_key(k)
        out[k] = v
    return out, pos


def _header(buf, pos: int):
    """(is_map, entries, next position) of the container header at
    ``pos``, else None."""
    c = buf[pos]
    if 0x90 <= c <= 0x9F:
        return False, c & 0x0F, pos + 1
    if 0x80 <= c <= 0x8F:
        return True, c & 0x0F, pos + 1
    if 0xDC <= c <= 0xDF:
        size = 2 if c in (0xDC, 0xDE) else 4
        _need(buf, pos + 1, size)
        n = (_u16 if size == 2 else _u32)(buf, pos + 1)[0]
        return c >= 0xDE, n, pos + 1 + size
    return None


def _decode_deep(buf, pos: int, raw: bool, strict):
    """``_decode`` on an explicit stack, at most MAX_DEPTH containers
    deep: the same objects and the same errors, in the same order."""
    stack = []                 # [container, entries left, pending key]
    while True:
        _need(buf, pos, 1)
        head = _header(buf, pos)
        if head is None:
            obj, pos = _decode(buf, pos, 0, raw, strict)
        else:
            is_map, n, pos = head
            if strict is not None:
                _check_len(is_map, n)
            if len(stack) >= MAX_DEPTH:
                raise StackError("msgpack: nesting deeper than "
                                 f"{MAX_DEPTH} containers")
            if n:
                stack.append([{} if is_map else [], n, _NO_KEY])
                continue
            obj = {} if is_map else []
        while stack:
            top = stack[-1]
            if type(top[0]) is dict:
                key = top[2]
                if key is _NO_KEY:          # obj is a key: read its value
                    top[2] = obj
                    break
                if strict:
                    _check_key(key)
                top[0][key] = obj
                top[2] = _NO_KEY
            else:
                top[0].append(obj)
            top[1] -= 1
            if top[1]:
                break
            obj = stack.pop()[0]
        else:
            return obj, pos


def _decode_any(buf, pos: int, raw: bool = False, strict=None):
    try:
        return _decode(buf, pos, 0, raw, strict)
    except _Deep:
        return _decode_deep(buf, pos, raw, strict)


def unpackb(data) -> Any:
    """Decode exactly one object, as
    ``msgpack.unpackb(data, raw=False, strict_map_key=False)``."""
    buf = bytes(data)
    try:
        obj, pos = _decode_any(buf, 0)
    except _OutOfData:
        raise ValueError("Unpack failed: incomplete input") from None
    if pos != len(buf):
        raise ExtraData("unpack(b) received extra data.")
    return obj


class Unpacker:
    """An incremental decoder, as the wheel's fed
    ``msgpack.Unpacker(raw=...)``: ``feed(bytes)`` appends input and
    iteration yields every complete object, keeping a partial tail until
    the next ``feed``.  ``raw=True`` returns str-typed data as bytes.

    The rest is the wheel's defaults: map keys must be str or bytes
    (``strict_map_key=True``); ``feed`` raises :class:`BufferFull` when
    the bytes not yet consumed would pass MAX_BUFFER_SIZE; an array
    header may declare at most MAX_BUFFER_SIZE entries and a map header
    half as many, else ValueError ("N exceeds max_array_len(L)").
    Decode errors are the wheel's types (:class:`FormatError`,
    :class:`StackError`, UnicodeDecodeError, TypeError for an unhashable
    key); an object that raised is not consumed, so iterating again
    raises again.  ``unpack()`` returns the next object or raises
    :class:`OutOfData`."""

    def __init__(self, raw: bool = False):
        self._raw = bool(raw)
        self._strict_map_key = True
        self._buf = bytearray()
        self._pos = 0

    def feed(self, next_bytes) -> None:
        view = memoryview(next_bytes)
        if len(self._buf) - self._pos + view.nbytes > MAX_BUFFER_SIZE:
            raise BufferFull
        if self._pos:
            del self._buf[:self._pos]
            self._pos = 0
        self._buf += view

    def unpack(self) -> Any:
        try:
            obj, self._pos = _decode_any(self._buf, self._pos, self._raw,
                                         self._strict_map_key)
        except _OutOfData:
            raise OutOfData("No more data to unpack.") from None
        return obj

    def __iter__(self) -> "Unpacker":
        return self

    def __next__(self) -> Any:
        try:
            return self.unpack()
        except OutOfData:
            raise StopIteration from None


def unpack_stream(data) -> Iterator[Any]:
    """Iterate over concatenated objects, as a fed
    ``msgpack.Unpacker(raw=False, strict_map_key=False)``: an object
    cut off by the end of the input ends the iteration silently."""
    up = Unpacker()
    up._strict_map_key = False
    up.feed(data)
    return up
