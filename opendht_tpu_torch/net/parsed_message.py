"""Wire-format decoder (reference src/parsed_message.h, src/net.h).

A copy of the JAX package's ``net/parsed_message.py`` with its behaviour unchanged.

One msgpack map per UDP packet.  Top-level keys:
``y`` "q"/"r"/"e" (query/reply/error), ``p`` (value-part packet),
``t`` transaction id (4B bin or int), ``v`` agent string, ``n`` network
id, ``q`` query verb ∈ {ping, find, get, listen, put, refresh}, ``a``
(query args) / ``r`` (reply body) / ``e`` [code, msg] / ``u`` (value
update body), and the OPTIONAL ``tr`` distributed-trace context
(strictly bounded decode, ignored by parsers that predate it
— unknown top-level keys are skipped by construction).  Body keys:
id, h, target, sid, token, vid, values, fields, exp, re, n4, n6, sa,
c, w, q(uery).

Fragmentation: a value too large for one packet is announced as an
integer size in the ``values`` array, then streamed as ``y:"v"``
packets carrying ``p: {index: {o: offset, d: chunk}}``; ``append`` +
``complete`` reassemble (parsed_message.h:87-123)."""

from __future__ import annotations

import enum
import socket as _socket
from typing import Dict, List, Optional, Tuple

from ..infohash import InfoHash
from ..sockaddr import SockAddr
from ..tracing import TRACE_WIRE_KEY, decode_wire
from ..utils import unpack_msg
from ..core.value import MAX_VALUE_SIZE, Field, FieldValueIndex, Query, Value


class MessageType(enum.Enum):
    ERROR = "error"
    REPLY = "reply"
    PING = "ping"
    FIND_NODE = "find"
    GET_VALUES = "get"
    ANNOUNCE_VALUE = "put"
    REFRESH = "refresh"
    LISTEN = "listen"
    VALUE_DATA = "value_data"
    VALUE_UPDATE = "value_update"


_QUERY_TYPES = {
    "ping": MessageType.PING,
    "find": MessageType.FIND_NODE,
    "get": MessageType.GET_VALUES,
    "listen": MessageType.LISTEN,
    "put": MessageType.ANNOUNCE_VALUE,
    "refresh": MessageType.REFRESH,
}

#: request types are rate-limited; replies/errors are not
REQUEST_TYPES = frozenset(_QUERY_TYPES.values())


def unpack_tid(o) -> int:
    """tid arrives as a 4-byte big-endian bin or a plain int
    (parsed_message.h:29-36).  Out-of-range int tids are rejected here
    — a hostile 2^63 tid would otherwise crash the engine later when it
    echoes the tid into a reply header (found by tests/test_wire_fuzz.py)."""
    if isinstance(o, int):
        if not 0 <= o < 1 << 32:
            raise ValueError(f"bad tid value {o}")
        return o
    b = bytes(o)
    if len(b) != 4:
        raise ValueError(f"bad tid length {len(b)}")
    return int.from_bytes(b, "big")


def pack_tid(tid: int) -> bytes:
    return int(tid).to_bytes(4, "big")


class ParsedMessage:
    __slots__ = (
        "type", "id", "network", "is_client", "info_hash", "target", "tid",
        "socket_id", "token", "value_id", "created", "nodes4_raw",
        "nodes6_raw", "nodes4", "nodes6", "values", "refreshed_values",
        "expired_values", "fields", "value_parts", "query", "want",
        "error_code", "ua", "addr", "trace_ctx",
    )

    def __init__(self):
        self.type: Optional[MessageType] = None
        self.id = InfoHash()
        self.network = 0
        self.is_client = False
        self.info_hash = InfoHash()
        self.target = InfoHash()
        self.tid = 0
        self.socket_id = 0
        self.token = b""
        self.value_id = 0
        self.created: Optional[float] = None
        self.nodes4_raw = b""
        self.nodes6_raw = b""
        self.nodes4: list = []          # filled by engine.deserialize_nodes
        self.nodes6: list = []
        self.values: List[Value] = []
        self.refreshed_values: List[int] = []
        self.expired_values: List[int] = []
        self.fields: List[FieldValueIndex] = []
        # index -> [expected_total_or_offset, bytearray]
        self.value_parts: Dict[int, Tuple[int, bytearray]] = {}
        self.query = Query()
        self.want = -1
        self.error_code = 0
        self.ua = ""
        self.addr = SockAddr()
        self.trace_ctx = None           # optional wire context

    # -- decoding ----------------------------------------------------------
    @classmethod
    def from_bytes(cls, data: bytes) -> "ParsedMessage":
        return cls.from_obj(unpack_msg(data))

    @classmethod
    def from_obj(cls, msg) -> "ParsedMessage":
        if not isinstance(msg, dict):
            raise ValueError("packet is not a map")
        self = cls()
        y = msg.get("y")
        r = msg.get("r")
        u = msg.get("u")
        e = msg.get("e")
        p = msg.get("p")

        if "t" in msg:
            self.tid = unpack_tid(msg["t"])
        if "v" in msg:
            self.ua = str(msg["v"])
        if "n" in msg:
            self.network = int(msg["n"])
        if "s" in msg:
            self.is_client = bool(msg["s"])
        if TRACE_WIRE_KEY in msg:
            # bounded decode: any malformed / hostile oversized blob is
            # ignored (None), never raised, never echoed — and every
            # OTHER unknown top-level key is skipped by construction
            # (tests/test_wire_fuzz.py proves both directions)
            self.trace_ctx = decode_wire(msg[TRACE_WIRE_KEY])
        q = msg.get("q")

        # type inference (parsed_message.h:153-176)
        if e is not None:
            self.type = MessageType.ERROR
        elif r is not None:
            self.type = MessageType.REPLY
        elif p is not None:
            self.type = MessageType.VALUE_DATA
        elif u is not None:
            self.type = MessageType.VALUE_UPDATE
        elif y is not None and y != "q":
            raise ValueError(f"unknown y: {y!r}")
        elif q in _QUERY_TYPES:
            self.type = _QUERY_TYPES[q]
        else:
            raise ValueError(f"unknown message type (q={q!r})")

        if self.type is MessageType.VALUE_DATA:
            # {index: {o: offset, d: chunk}}
            if not isinstance(p, dict):
                raise ValueError("malformed value-part packet")
            for idx, part in p.items():
                if not isinstance(part, dict) or "o" not in part or "d" not in part:
                    continue
                self.value_parts[int(idx)] = (int(part["o"]),
                                              bytearray(part["d"]))
            return self

        a = msg.get("a")
        if a is None and r is None and e is None and u is None:
            raise ValueError("no message body")
        req = a if a is not None else (r if r is not None else
                                       (u if u is not None else e))

        if e is not None:
            if not isinstance(e, (list, tuple)) or not e:
                raise ValueError("malformed error body")
            self.error_code = int(e[0])
            req = msg.get("r", {})   # optional id map alongside the error

        if not isinstance(req, dict):
            req = {}

        if "sid" in req:
            self.socket_id = unpack_tid(req["sid"])
        if "id" in req:
            self.id = InfoHash(req["id"])
        if "h" in req:
            self.info_hash = InfoHash(req["h"])
        if "target" in req:
            self.target = InfoHash(req["target"])
        if "q" in req:
            self.query = Query.from_wire_obj(req["q"])
        if "token" in req:
            self.token = bytes(req["token"])
        if "vid" in req:
            self.value_id = int(req["vid"])
        if "n4" in req:
            self.nodes4_raw = bytes(req["n4"])
        if "n6" in req:
            self.nodes6_raw = bytes(req["n6"])
        if "sa" in req:
            raw = bytes(req["sa"])
            # address echo carries no port (parsed_message.h:263-281)
            if len(raw) in (4, 16):
                self.addr = SockAddr(raw, 0)
        if "c" in req:
            self.created = float(req["c"])

        if "values" in req:
            vals = req["values"]
            if not isinstance(vals, (list, tuple)):
                raise ValueError("malformed values array")
            for i, packed in enumerate(vals):
                if isinstance(packed, int):
                    # oversized value announced by size; margin for header
                    if packed > MAX_VALUE_SIZE + 32:
                        continue
                    self.value_parts[i] = (packed, bytearray())
                else:
                    try:
                        self.values.append(Value.from_wire_obj(packed))
                    except Exception:
                        pass
        elif "fields" in req:
            raw_fields = req["fields"]
            if not isinstance(raw_fields, dict) or "f" not in raw_fields:
                raise ValueError("malformed fields")
            fset = sorted(Field(f) for f in raw_fields["f"])
            rvalues = raw_fields.get("v")
            if isinstance(rvalues, (list, tuple)) and fset:
                nf = len(fset)
                for i in range(len(rvalues) // nf):
                    try:
                        self.fields.append(FieldValueIndex.unpack_fields(
                            fset, rvalues[i * nf:(i + 1) * nf]))
                    except Exception:
                        pass
        elif "exp" in req:
            self.expired_values = [int(v) for v in req["exp"]]
        elif "re" in req:
            self.refreshed_values = [int(v) for v in req["re"]]

        if "w" in req:
            w = req["w"]
            if not isinstance(w, (list, tuple)):
                raise ValueError("malformed want")
            self.want = 0
            for fam in w:
                if fam == _socket.AF_INET:
                    self.want |= 1      # WANT4
                elif fam == _socket.AF_INET6:
                    self.want |= 2      # WANT6
        else:
            self.want = -1
        return self

    # -- fragment reassembly (parsed_message.h:87-123) ---------------------
    def append(self, block: "ParsedMessage") -> bool:
        """Merge a ValueData block into this header message; True if any
        chunk advanced (in-order only, like the reference)."""
        progressed = False
        for idx, (offset, chunk) in block.value_parts.items():
            slot = self.value_parts.get(idx)
            if slot is None:
                continue
            total, buf = slot
            if len(buf) >= total:
                continue
            if offset != len(buf):
                continue            # out-of-order: dropped, sender retries
            buf.extend(chunk)
            progressed = True
        return progressed

    def complete(self) -> bool:
        """True when all announced parts arrived; decodes them into
        ``values``."""
        for total, buf in self.value_parts.values():
            if len(buf) < total:
                return False
        for _, buf in self.value_parts.values():
            self.values.append(Value.from_packed(bytes(buf)))
        return True
