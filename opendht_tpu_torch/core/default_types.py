"""Registered default value types (reference include/opendht/default_types.h
+ src/default_types.cpp).

Each type is a thin serializable payload class plus a registered
:class:`~opendht_tpu_torch.core.value.ValueType` with the reference's id, name,
expiration and store policy:

  1 DhtMessage      service message, 5 min, store iff service non-empty
  2 IpServiceAnnouncement  peer announce, 15 min, stored address is
                    rewritten to the *sender's* address (anti-spoof)
  3 ImMessage       instant message, 5 min (signed)
  4 TrustRequest    certificate trust request, 7 days (encrypted)
  5 IceCandidates   ICE bootstrap blob, 1 min (encrypted)

A copy of the JAX package's ``core/default_types.py`` with its behaviour
unchanged.
"""

from __future__ import annotations

import enum
from typing import Optional

from ..infohash import InfoHash
from ..sockaddr import SockAddr
from ..utils import pack_msg, unpack_msg
from .value import Filter, Filters, Value, ValueType


# ------------------------------------------------------------------ payloads
class DhtMessage:
    """Generic service message {service, data} (default_types.h:36-59)."""

    def __init__(self, service: str = "", data: bytes = b""):
        self.service = service
        self.data = bytes(data)

    def pack(self) -> bytes:
        return pack_msg([self.service, self.data])    # MSGPACK_DEFINE array

    @classmethod
    def unpack(cls, data: bytes) -> "DhtMessage":
        service, payload = unpack_msg(data)[:2]
        return cls(str(service), bytes(payload))

    @staticmethod
    def store_policy(key, value: Value, from_id, from_addr) -> bool:
        """Store iff the payload names a service (default_types.cpp:29-38)."""
        try:
            if not DhtMessage.unpack(value.data).service:
                return False
        except Exception:
            pass
        return ValueType.default_store_policy(key, value, from_id, from_addr)

    @staticmethod
    def service_filter(service: str) -> Filter:
        """(default_types.cpp:40-53)"""
        def match(v: Value) -> bool:
            try:
                return DhtMessage.unpack(v.data).service == service
            except Exception:
                return False
        return Filters.chain(Filters.value_type(DHT_MESSAGE_TYPE.id), match)

    def to_value(self, value_id: int = 0) -> Value:
        return Value(self.pack(), type_id=DHT_MESSAGE_TYPE.id, value_id=value_id)


class ImStatus(enum.IntEnum):
    NONE = 0
    TYPING = 1
    RECEIVED = 2
    READ = 3


class ImMessage:
    """Signed instant message (default_types.h:105-132)."""

    def __init__(self, msg_id: int = 0, msg: str = "", date: int = 0,
                 datatype: str = ""):
        self.id = msg_id
        self.msg = msg
        self.date = date
        self.datatype = datatype
        self.status = ImStatus.NONE
        self.from_id: Optional[InfoHash] = None     # signer, set on unpack
        self.to: Optional[InfoHash] = None          # recipient, set on unpack

    def pack(self) -> bytes:
        # MSGPACK_DEFINE_MAP(id, msg, date, status, datatype)
        return pack_msg({"id": self.id, "msg": self.msg, "date": self.date,
                         "status": int(self.status), "datatype": self.datatype})

    @classmethod
    def unpack(cls, data: bytes) -> "ImMessage":
        o = unpack_msg(data)
        m = cls(int(o.get("id", 0)), str(o.get("msg", "")),
                int(o.get("date", 0)), str(o.get("datatype", "")))
        m.status = ImStatus(int(o.get("status", 0)))
        return m

    @classmethod
    def from_value(cls, v: Value) -> "ImMessage":
        m = cls.unpack(v.data)
        m.from_id = v.owner.get_id() if v.owner else None
        m.to = v.recipient
        return m

    def to_value(self, value_id: int = 0) -> Value:
        return Value(self.pack(), type_id=IM_MESSAGE_TYPE.id, value_id=value_id)

    @staticmethod
    def get_filter() -> Filter:
        return lambda v: v.is_signed()


class TrustRequest:
    """Encrypted certificate trust request (default_types.h:134-155)."""

    def __init__(self, service: str = "", payload: bytes = b"", confirm: bool = False):
        self.service = service
        self.payload = bytes(payload)
        self.confirm = confirm

    def pack(self) -> bytes:
        return pack_msg({"service": self.service, "payload": self.payload,
                         "confirm": self.confirm})

    @classmethod
    def unpack(cls, data: bytes) -> "TrustRequest":
        o = unpack_msg(data)
        return cls(str(o.get("service", "")), bytes(o.get("payload", b"")),
                   bool(o.get("confirm", False)))

    def to_value(self, value_id: int = 0) -> Value:
        return Value(self.pack(), type_id=TRUST_REQUEST_TYPE.id, value_id=value_id)

    @staticmethod
    def get_filter() -> Filter:
        return lambda v: v.is_signed() and v.recipient is not None


class IceCandidates:
    """Encrypted ICE bootstrap blob [id, bin] (default_types.h:157-195)."""

    def __init__(self, msg_id: int = 0, ice_data: bytes = b""):
        self.id = msg_id
        self.ice_data = bytes(ice_data)

    def pack(self) -> bytes:
        return pack_msg([self.id, self.ice_data])

    @classmethod
    def unpack(cls, data: bytes) -> "IceCandidates":
        o = unpack_msg(data)
        if not isinstance(o, (list, tuple)) or len(o) < 2:
            raise ValueError("malformed IceCandidates")
        return cls(int(o[0]), bytes(o[1]))

    def to_value(self, value_id: int = 0) -> Value:
        return Value(self.pack(), type_id=ICE_CANDIDATES_TYPE.id, value_id=value_id)

    @staticmethod
    def get_filter() -> Filter:
        return lambda v: v.is_signed() and v.recipient is not None


class IpServiceAnnouncement:
    """Service announcement carrying an ip:port (default_types.h:199-252).
    Wire form: bin(compact sockaddr)."""

    def __init__(self, addr: Optional[SockAddr] = None):
        self.addr = addr or SockAddr()

    @property
    def port(self) -> int:
        return self.addr.port

    def pack(self) -> bytes:
        return pack_msg(self.addr.to_compact())

    @classmethod
    def unpack(cls, data: bytes) -> "IpServiceAnnouncement":
        o = unpack_msg(data)
        if not isinstance(o, (bytes, bytearray)):
            raise ValueError("malformed IpServiceAnnouncement")
        return cls(SockAddr.from_compact(bytes(o)))

    def to_value(self, value_id: int = 0) -> Value:
        return Value(self.pack(), type_id=IP_SERVICE_ANNOUNCEMENT_TYPE.id,
                     value_id=value_id)

    @staticmethod
    def store_policy(key, value: Value, from_id, from_addr: SockAddr) -> bool:
        """Anti-spoof: rewrite the announced address to the sender's
        observed source address, keeping only the announced port; reject
        port 0 (default_types.cpp:68-82).  Mutates ``value.data``."""
        try:
            ann = IpServiceAnnouncement.unpack(value.data)
            if ann.port == 0:
                return False
            rewritten = IpServiceAnnouncement(
                SockAddr(from_addr.ip, ann.port) if from_addr else ann.addr)
            value.data = rewritten.pack()
            value.type = IP_SERVICE_ANNOUNCEMENT_TYPE.id
            return ValueType.default_store_policy(key, value, from_id, from_addr)
        except Exception:
            return False


# --------------------------------------------------------------- type tables
DHT_MESSAGE_TYPE = ValueType(1, "DHT message", 5 * 60.0, DhtMessage.store_policy)
IP_SERVICE_ANNOUNCEMENT_TYPE = ValueType(
    2, "Internet Service Announcement", 15 * 60.0, IpServiceAnnouncement.store_policy)
IM_MESSAGE_TYPE = ValueType(3, "IM message", 5 * 60.0)
TRUST_REQUEST_TYPE = ValueType(4, "Certificate trust request", 7 * 24 * 3600.0)
ICE_CANDIDATES_TYPE = ValueType(5, "ICE candidates", 60.0)

#: types registered on every node (default_types.cpp:85-101)
DEFAULT_TYPES = (ValueType.USER_DATA, DHT_MESSAGE_TYPE, IM_MESSAGE_TYPE,
                 ICE_CANDIDATES_TYPE, TRUST_REQUEST_TYPE)

#: types whose store policy trusts the transport address, not signatures
DEFAULT_INSECURE_TYPES = (IP_SERVICE_ANNOUNCEMENT_TYPE,)
