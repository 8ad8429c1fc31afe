"""JSON encoding of DHT values for the REST proxy wire format.

Mirrors the reference's JSON layer key-for-key (reference:
src/value.cpp:176-234 ``Value::Value(Json::Value&)`` / ``Value::toJson``):
``id`` is a decimal string, binary fields (``data``, ``sig``, ``cypher``)
are base64, ``owner`` is the owner public key (base64 DER here), ``to``
the recipient hash in hex, plus ``type``, ``seq`` and ``utype``.

The port's copy of the JAX package's ``proxy/json_codec.py``: the same
JSON for the same ``Value``.  ``crypto`` is imported at call time only
(an ``owner`` field), so the codec runs without the crypto wheels.
"""

from __future__ import annotations

import base64
from typing import Optional

from ..infohash import InfoHash
from ..core.value import Value, RawPublicKey


def _b64(b: bytes) -> str:
    return base64.b64encode(bytes(b)).decode("ascii")


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def value_to_json(v: Value) -> dict:
    """reference: src/value.cpp:211-234."""
    out: dict = {"id": str(v.id)}
    if v.is_encrypted():
        out["cypher"] = _b64(v.cypher)
        return out
    if v.is_signed():
        out["sig"] = _b64(v.signature)
    if v.owner is not None:
        out["seq"] = v.seq
        out["owner"] = _b64(v.owner.export_der())
        if v.recipient:
            out["to"] = v.recipient.hex()
    out["type"] = v.type
    out["data"] = _b64(v.data)
    if v.user_type:
        out["utype"] = v.user_type
    return out


def value_from_json(obj: dict) -> Value:
    """reference: src/value.cpp:176-209."""
    v = Value()
    try:
        v.id = int(obj.get("id", 0))
    except (TypeError, ValueError):
        v.id = 0
    if "cypher" in obj:
        v.cypher = _unb64(obj["cypher"])
        return v
    if "sig" in obj:
        v.signature = _unb64(obj["sig"])
    if "owner" in obj:
        try:
            # parse to a real verifying key right away (the UDP path defers
            # this to SecureDht._parse_owner; REST values may be consumed
            # without a SecureDht in front)
            from .. import crypto
            v.owner = crypto.PublicKey(_unb64(obj["owner"]))
        except Exception:
            try:
                v.owner = RawPublicKey(_unb64(obj["owner"]))
            except Exception:
                v.owner = None
        v.seq = int(obj.get("seq", 0))
        if "to" in obj:
            v.recipient = InfoHash(obj["to"])
    v.type = int(obj.get("type", 0))
    v.data = _unb64(obj.get("data", ""))
    v.user_type = obj.get("utype", "")
    return v


def permanent_deadline(obj: dict, default_timeout: float) -> Optional[float]:
    """Extract the proxy permanent-put flag from a POST body.

    The reference accepts ``permanent: true`` or a nested object carrying
    a push token (src/dht_proxy_server.cpp:505-560).  Returns the relative
    refresh timeout when the put is permanent, else None.
    """
    p = obj.get("permanent")
    if not p:
        return None
    return float(default_timeout)
