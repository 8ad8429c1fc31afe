"""Value & query model — the data plane of the DHT.

A copy of the JAX package's ``core/value.py`` with its behaviour unchanged.

Counterpart of reference ``include/opendht/value.h`` + ``src/value.cpp``:

- :class:`Value` — a stored datum with metadata (value.h:134-591).  Wire
  format is three nested msgpack layers, outermost first:
    pack          {"id": u64, "dat": <to_encrypt>}            (value.h:506-511)
    to_encrypt    bin(cypher)  if encrypted, else
                  {"body": <to_sign>, ["sig": bin]}           (value.h:490-503)
    to_sign       {["seq", "owner", ["to"]], "type", "data", ["utype"]}
                                                              (value.h:470-487)
  (keys emitted in exactly that order; dict insertion order + msgpack
  preserves the reference's byte layout).
- :class:`ValueType` / :class:`TypeStore` — per-type expiration and
  store/edit policies (value.h:78-123).
- filters — composable predicates (value.h:150-199).
- remote query language — :class:`Select` (field projection),
  :class:`Where` (field equality), :class:`Query` with the SQL-ish
  string form ``[SELECT $fields$] [WHERE $field$=$value$,...]``
  (value.h:686-918, src/value.cpp:405-472).
- :class:`FieldValueIndex` — projected value for query replies
  (value.h:927-945, src/value.cpp:293-341).
"""

from __future__ import annotations

import enum
import random
from typing import Callable, Iterable, List, Optional, Sequence

from ..infohash import InfoHash
from ..utils import pack_msg

MAX_VALUE_SIZE = 64 * 1024          # value.h:77
TEN_MINUTES = 600.0

#: predicate over Value
Filter = Callable[["Value"], bool]


# --------------------------------------------------------------------- owner
class RawPublicKey:
    """Placeholder owner: holds the DER-encoded public key from the wire
    without parsing it.  The crypto layer subclasses/replaces this with a
    real key object exposing the same protocol: ``export_der()``,
    ``get_id()``, ``check_signature(data, sig)``."""

    __slots__ = ("der",)

    def __init__(self, der: bytes):
        self.der = bytes(der)

    def export_der(self) -> bytes:
        return self.der

    def get_id(self) -> InfoHash:
        """Key fingerprint = digest of the DER export (crypto.cpp:447-456)."""
        return InfoHash.get(self.der)

    def check_signature(self, data: bytes, signature: bytes) -> bool:
        return False    # can't verify without a parsed key

    def __eq__(self, other):
        return isinstance(other, RawPublicKey) and self.der == other.der

    def __hash__(self):
        return hash(self.der)


def _owner_equal(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return a.export_der() == b.export_der()


# ----------------------------------------------------------------- ValueType
class ValueType:
    """Type metadata + storage/edit policies (value.h:78-110).

    ``store_policy(key, value, from_id, from_addr) -> bool`` gates every
    incoming store; ``edit_policy(key, old_value, new_value, from_id,
    from_addr) -> bool`` gates overwrites of an existing (key, value-id).
    Default: store anything sized, never edit."""

    __slots__ = ("id", "name", "expiration", "store_policy", "edit_policy")

    @staticmethod
    def default_store_policy(key, value: "Value", from_id, from_addr) -> bool:
        return value.size() <= MAX_VALUE_SIZE

    @staticmethod
    def default_edit_policy(key, old_value, new_value, from_id, from_addr) -> bool:
        return False

    def __init__(self, type_id: int, name: str, expiration: float = TEN_MINUTES,
                 store_policy=None, edit_policy=None):
        self.id = int(type_id)
        self.name = name
        self.expiration = float(expiration)
        self.store_policy = store_policy or ValueType.default_store_policy
        self.edit_policy = edit_policy or ValueType.default_edit_policy

    def __eq__(self, other):
        return isinstance(other, ValueType) and self.id == other.id

    def __hash__(self):
        return hash(self.id)

    def __repr__(self):
        return f"ValueType({self.id}, {self.name!r})"


ValueType.USER_DATA = ValueType(0, "USER_DATA")


class TypeStore:
    """Registry of known value types (value.h:112-123); unknown ids fall
    back to USER_DATA."""

    def __init__(self):
        self._types: dict[int, ValueType] = {}

    def register_type(self, vtype: ValueType) -> None:
        self._types[vtype.id] = vtype

    def get_type(self, type_id: int) -> ValueType:
        return self._types.get(type_id, ValueType.USER_DATA)


# --------------------------------------------------------------------- Value
class Value:
    """A datum stored on the DHT (value.h:134-591)."""

    INVALID_ID = 0
    Id = int

    __slots__ = ("id", "owner", "recipient", "type", "data", "user_type",
                 "seq", "signature", "cypher")

    def __init__(self, data: bytes = b"", *, type_id: int = 0,
                 value_id: int = INVALID_ID, user_type: str = ""):
        self.id = value_id
        self.owner = None                       # PublicKey-like or None
        self.recipient: Optional[InfoHash] = None
        self.type = type_id
        self.data = bytes(data)
        self.user_type = user_type
        self.seq = 0
        self.signature = b""
        self.cypher = b""

    # -- predicates --------------------------------------------------------
    def is_encrypted(self) -> bool:
        return len(self.cypher) > 0

    def is_signed(self) -> bool:
        return self.owner is not None and len(self.signature) > 0

    def size(self) -> int:
        """Bytes used by this value (value.cpp:99-102)."""
        return (len(self.cypher) + len(self.data) + len(self.signature)
                + len(self.user_type))

    def check_signature(self) -> bool:
        return (self.is_signed()
                and self.owner.check_signature(self.get_to_sign(), self.signature))

    def sign(self, key) -> None:
        """Sign with a PrivateKey-like object: sets owner to its public key
        and signature over the signed body (value.h:331-336)."""
        if self.is_encrypted():
            raise ValueError("Can't sign encrypted data")
        self.owner = key.public_key()
        self.signature = key.sign(self.get_to_sign())

    def encrypt(self, from_key, to_pk) -> "Value":
        """Sign with ``from_key``, then return a new Value carrying only the
        cypher encrypted to ``to_pk`` (value.h:350-360)."""
        if self.is_encrypted():
            raise ValueError("Data is already encrypted")
        self.recipient = to_pk.get_id()
        self.sign(from_key)
        nv = Value(value_id=self.id)
        nv.cypher = to_pk.encrypt(self.get_to_encrypt())
        return nv

    # -- wire layers (see module docstring) --------------------------------
    def to_sign_obj(self) -> dict:
        """Innermost layer: the signed body (value.h:470-487)."""
        out: dict = {}
        has_owner = self.owner is not None
        if has_owner:
            out["seq"] = self.seq
            out["owner"] = self.owner.export_der()
            if self.recipient:
                out["to"] = bytes(self.recipient)
        out["type"] = self.type
        out["data"] = self.data
        if self.user_type:
            out["utype"] = self.user_type
        return out

    def to_encrypt_obj(self):
        """Middle layer: cypher bin, or {body, [sig]} (value.h:490-503)."""
        if self.is_encrypted():
            return self.cypher
        out: dict = {"body": self.to_sign_obj()}
        if self.is_signed():
            out["sig"] = self.signature
        return out

    def wire_obj(self) -> dict:
        """Outermost layer (value.h:506-511)."""
        return {"id": self.id, "dat": self.to_encrypt_obj()}

    def get_to_sign(self) -> bytes:
        return pack_msg(self.to_sign_obj())

    def get_to_encrypt(self) -> bytes:
        return pack_msg(self.to_encrypt_obj())

    def get_packed(self) -> bytes:
        return pack_msg(self.wire_obj())

    # -- decoding ----------------------------------------------------------
    @classmethod
    def from_wire_obj(cls, obj) -> "Value":
        """Decode the outer layer (src/value.cpp:105-119)."""
        if not isinstance(obj, dict) or "id" not in obj or "dat" not in obj:
            raise ValueError("malformed value: missing id/dat")
        v = cls(value_id=int(obj["id"]))
        v._unpack_body(obj["dat"])
        return v

    def _unpack_body(self, o) -> None:
        """Decode the dat layer (src/value.cpp:122-173)."""
        self.owner = None
        self.recipient = None
        self.cypher = b""
        self.signature = b""
        self.data = b""
        self.type = 0
        if isinstance(o, (bytes, bytearray)):
            self.cypher = bytes(o)
            return
        if not isinstance(o, dict):
            raise ValueError("malformed value body")
        body = o.get("body")
        if not isinstance(body, dict):
            raise ValueError("malformed value: missing body")
        if "data" not in body or "type" not in body:
            raise ValueError("malformed value: missing data/type")
        self.data = bytes(body["data"])
        self.type = int(body["type"])
        self.user_type = str(body.get("utype", ""))
        if "owner" in body:
            if "seq" not in body:
                raise ValueError("signed value missing seq")
            self.seq = int(body["seq"])
            self.owner = RawPublicKey(body["owner"])
            if "to" in body:
                self.recipient = InfoHash(body["to"])
            if "sig" not in o:
                raise ValueError("signed value missing sig")
            self.signature = bytes(o["sig"])

    @classmethod
    def from_packed(cls, data: bytes) -> "Value":
        from ..utils import unpack_msg
        return cls.from_wire_obj(unpack_msg(data))

    # -- field projection (query replies) ----------------------------------
    def pack_fields(self, fields: "Sequence[Field]") -> list:
        """Per-field wire values in the given (sorted) field order
        (value.h:514-539)."""
        out = []
        for f in fields:
            if f == Field.ID:
                out.append(self.id)
            elif f == Field.VALUE_TYPE:
                out.append(self.type)
            elif f == Field.OWNER_PK:
                out.append(self.owner.get_id().data if self.owner else bytes(20))
            elif f == Field.SEQ_NUM:
                out.append(self.seq)
            elif f == Field.USER_TYPE:
                out.append(self.user_type)
        return out

    # -- equality / repr ---------------------------------------------------
    def __eq__(self, other) -> bool:
        """value.h:411-418: id match, then cypher if encrypted else the
        signed tuple."""
        if not isinstance(other, Value):
            return NotImplemented
        if self.id != other.id:
            return False
        if self.is_encrypted() or other.is_encrypted():
            return self.cypher == other.cypher
        return (_owner_equal(self.owner, other.owner)
                and self.seq == other.seq
                and self.signature == other.signature
                and self.data == other.data
                and self.type == other.type
                and self.user_type == other.user_type)

    def __hash__(self):
        return hash((self.id, self.cypher, self.data, self.signature))

    def __repr__(self):
        tag = "encrypted" if self.is_encrypted() else (
            "signed" if self.is_signed() else "plain")
        return (f"Value(id={self.id:016x}, type={self.type}, {tag}, "
                f"{len(self.cypher) or len(self.data)}B)")


def random_value_id(rng: Optional[random.Random] = None) -> int:
    """Non-zero random 64-bit value id (assigned on put when unset,
    dht.cpp:918-922)."""
    r = rng or random
    while True:
        vid = r.getrandbits(64)
        if vid != Value.INVALID_ID:
            return vid


# ------------------------------------------------------------------- filters
class Filters:
    """Composable Value predicates (value.h:150-199).  A falsy/None filter
    means 'accept everything'."""

    @staticmethod
    def all(v: "Value") -> bool:
        return True

    @staticmethod
    def chain(f1: Optional[Filter], f2: Optional[Filter]) -> Optional[Filter]:
        if not f1:
            return f2
        if not f2:
            return f1
        return lambda v: f1(v) and f2(v)

    @staticmethod
    def chain_or(f1: Optional[Filter], f2: Optional[Filter]) -> Filter:
        if not f1 or not f2:
            return Filters.all
        return lambda v: f1(v) or f2(v)

    @staticmethod
    def chain_all(fs: Iterable[Optional[Filter]]) -> Optional[Filter]:
        fset = [f for f in fs if f]
        if not fset:
            return None
        return lambda v: all(f(v) for f in fset)

    @staticmethod
    def apply(f: Optional[Filter], values: Iterable["Value"]) -> List["Value"]:
        return list(values) if not f else [v for v in values if f(v)]

    @staticmethod
    def type_filter(type_id: int) -> Filter:
        """Value::TypeFilter (value.h:187-191)."""
        tid = int(type_id.id) if hasattr(type_id, "id") else int(type_id)
        return lambda v: v.type == tid

    @staticmethod
    def id_filter(vid: int) -> Filter:
        """Value::IdFilter (value.h:181-185)."""
        return lambda v: v.id == vid

    # field filters
    @staticmethod
    def id(vid: int) -> Filter:
        return lambda v: v.id == vid

    @staticmethod
    def value_type(tid: int) -> Filter:
        return lambda v: v.type == tid

    @staticmethod
    def owner(pk_hash: InfoHash) -> Filter:
        return lambda v: v.owner is not None and v.owner.get_id() == pk_hash

    @staticmethod
    def recipient(h: InfoHash) -> Filter:
        return lambda v: v.recipient == h

    @staticmethod
    def seq(s: int) -> Filter:
        return lambda v: v.seq == s

    @staticmethod
    def user_type(ut: str) -> Filter:
        return lambda v: v.user_type == ut


# ------------------------------------------------------------ query language
class Field(enum.IntEnum):
    """Projectable/filterable Value fields (value.h:136-146)."""
    NONE = 0
    ID = 1
    VALUE_TYPE = 2
    OWNER_PK = 3
    SEQ_NUM = 4
    USER_TYPE = 5


_FIELD_NAMES = {
    "id": Field.ID,
    "value_type": Field.VALUE_TYPE,
    "owner_pk": Field.OWNER_PK,
    "seq": Field.SEQ_NUM,
    "user_type": Field.USER_TYPE,
}
_FIELD_STR = {v: k for k, v in _FIELD_NAMES.items()}

QUERY_PARSE_ERROR = "Error parsing query."


class FieldValue:
    """One WHERE restriction: (field, value) where value is an int,
    an InfoHash, or bytes by field kind (value.h:595-677)."""

    __slots__ = ("field", "value")

    def __init__(self, field: Field, value):
        self.field = Field(field)
        if self.field in (Field.ID, Field.VALUE_TYPE, Field.SEQ_NUM):
            self.value = int(value)
        elif self.field == Field.OWNER_PK:
            self.value = value if isinstance(value, InfoHash) else InfoHash(value)
        elif self.field == Field.USER_TYPE:
            self.value = bytes(value) if not isinstance(value, str) else value.encode()
        else:
            self.value = value

    def wire_obj(self) -> dict:
        v = self.value
        if self.field == Field.OWNER_PK:
            v = bytes(v)
        return {"f": int(self.field), "v": v}

    @classmethod
    def from_wire_obj(cls, obj) -> "FieldValue":
        if not isinstance(obj, dict) or "f" not in obj or "v" not in obj:
            raise ValueError("malformed field value")
        return cls(Field(obj["f"]), obj["v"])

    def local_filter(self) -> Filter:
        """The equivalent in-process predicate (src/value.cpp:275-292)."""
        f, v = self.field, self.value
        if f == Field.ID:
            return Filters.id(v)
        if f == Field.VALUE_TYPE:
            return Filters.value_type(v)
        if f == Field.OWNER_PK:
            return Filters.owner(v)
        if f == Field.SEQ_NUM:
            return Filters.seq(v)
        if f == Field.USER_TYPE:
            return Filters.user_type(v.decode() if isinstance(v, bytes) else v)
        return Filters.all

    def __eq__(self, other):
        return (isinstance(other, FieldValue) and self.field == other.field
                and self.value == other.value)

    def __hash__(self):
        return hash((self.field, self.value if not isinstance(self.value, InfoHash)
                     else bytes(self.value)))

    def __repr__(self):
        return f"{_FIELD_STR.get(self.field, '?')}={self.value!r}"


class Select:
    """Field projection of a remote query (value.h:686-730).

    String form: ``SELECT f1,f2,...`` with fields from
    id|value_type|owner_pk|seq|user_type (src/value.cpp:405-428)."""

    def __init__(self, q_str: str = ""):
        self._fields: list[Field] = []
        tokens = q_str.split()
        if tokens and tokens[0].lower() == "select":
            for tok in "".join(tokens[1:]).split(","):
                tok = tok.strip()
                if tok in _FIELD_NAMES:
                    self.field(_FIELD_NAMES[tok])

    def field(self, f: Field) -> "Select":
        if f not in self._fields:
            self._fields.append(Field(f))
        return self

    def get_selection(self) -> list[Field]:
        """Selected fields in canonical (enum) order — matches the
        reference's std::set iteration order used on the wire."""
        return sorted(set(self._fields))

    def empty(self) -> bool:
        return not self._fields

    def wire_obj(self) -> list:
        return [int(f) for f in self._fields]

    @classmethod
    def from_wire_obj(cls, obj) -> "Select":
        s = cls()
        for f in obj:
            s.field(Field(f))
        return s

    def is_satisfied_by(self, other: "Select") -> bool:
        """True if this selection's fields are all explicitly present in
        `other`'s (src/value.cpp:505-511).  Note an *empty* `other`
        (unprojected, full values) does NOT satisfy a non-empty selection:
        projected and full replies have different shapes on the wire, so
        ops are only shared between explicitly-compatible projections —
        same rule as the reference."""
        if not self._fields and other._fields:
            return False
        return all(f in other._fields for f in self._fields)

    def __eq__(self, other):
        return isinstance(other, Select) and self._fields == other._fields

    def __repr__(self):
        if not self._fields:
            return "SELECT *"
        return "SELECT " + ",".join(_FIELD_STR[f] for f in self._fields)


class Where:
    """Conjunction of field-equality restrictions (value.h:738-847).

    String form: ``WHERE f1=v1,f2=v2,...`` (src/value.cpp:430-472)."""

    def __init__(self, q_str: str = ""):
        self.filters: list[FieldValue] = []
        tokens = q_str.split(None, 1)
        if tokens and tokens[0].lower() == "where":
            rest = tokens[1] if len(tokens) > 1 else ""
            for part in rest.split(","):
                part = part.strip()
                if not part:
                    continue
                if "=" not in part:
                    raise ValueError(f"{QUERY_PARSE_ERROR} (WHERE) near: {part}")
                fname, _, vstr = part.partition("=")
                fname, vstr = fname.strip(), vstr.strip()
                if not vstr:
                    continue
                if len(vstr) > 1 and vstr[0] == '"' and vstr[-1] == '"':
                    sval = vstr[1:-1]
                else:
                    sval = vstr

                def as_int() -> int:
                    # Stricter than the reference, which coerces unparsable
                    # numerics to 0 (src/value.cpp:445-452) and so silently
                    # matches id=0; a malformed query should fail loudly.
                    try:
                        return int(sval)
                    except ValueError:
                        raise ValueError(
                            f"{QUERY_PARSE_ERROR} (WHERE) bad number near: {vstr}")

                if fname == "id":
                    self.id(as_int())
                elif fname == "value_type":
                    self.value_type(as_int())
                elif fname == "owner_pk":
                    self.owner(InfoHash(sval))
                elif fname == "seq":
                    self.seq(as_int())
                elif fname == "user_type":
                    self.user_type(sval)
                else:
                    raise ValueError(f"{QUERY_PARSE_ERROR} (WHERE) wrong token near: {fname}")

    def _add(self, fv: FieldValue) -> "Where":
        if fv not in self.filters:
            self.filters.append(fv)
        return self

    def id(self, vid: int) -> "Where":
        return self._add(FieldValue(Field.ID, vid))

    def value_type(self, tid: int) -> "Where":
        return self._add(FieldValue(Field.VALUE_TYPE, tid))

    def owner(self, pk_hash: InfoHash) -> "Where":
        return self._add(FieldValue(Field.OWNER_PK, pk_hash))

    def seq(self, s: int) -> "Where":
        return self._add(FieldValue(Field.SEQ_NUM, s))

    def user_type(self, ut: str) -> "Where":
        return self._add(FieldValue(Field.USER_TYPE, ut))

    def empty(self) -> bool:
        return not self.filters

    def get_filter(self) -> Optional[Filter]:
        if not self.filters:
            return None
        return Filters.chain_all(fv.local_filter() for fv in self.filters)

    def wire_obj(self) -> list:
        return [fv.wire_obj() for fv in self.filters]

    @classmethod
    def from_wire_obj(cls, obj) -> "Where":
        w = cls()
        for o in obj:
            w._add(FieldValue.from_wire_obj(o))
        return w

    def is_satisfied_by(self, other: "Where") -> bool:
        """True if `other`'s restrictions are a subset of this one's —
        i.e. other's (cached) result set is a superset of what this where
        clause selects (src/value.cpp:513-515)."""
        return all(fv in self.filters for fv in other.filters)

    def __eq__(self, o):
        return isinstance(o, Where) and self.filters == o.filters

    def __repr__(self):
        return "WHERE " + ",".join(map(repr, self.filters)) if self.filters else ""


class Query:
    """A remote query: projection + restriction (value.h:851-918).

    String form ``[SELECT $fields$] [WHERE $field$=$value$,...]``; wire
    form ``{"s": <select>, "w": <where>}``."""

    def __init__(self, select: "Select | str | None" = None,
                 where: "Where | None" = None, none: bool = False):
        if isinstance(select, str):
            q_str = select
            lower = q_str.lower()
            pos = lower.find("where")
            if pos < 0:
                pos = len(q_str)
            select = Select(q_str[:pos])
            where = Where(q_str[pos:])
        self.select = select or Select()
        self.where = where or Where()
        self.none = none   # when True, any query satisfies this one

    def is_satisfied_by(self, q: "Query") -> bool:
        """(src/value.cpp:517-519)"""
        return self.none or (self.where.is_satisfied_by(q.where)
                             and self.select.is_satisfied_by(q.select))

    def get_filter(self) -> Optional[Filter]:
        return self.where.get_filter()

    def wire_obj(self) -> dict:
        return {"s": self.select.wire_obj(), "w": self.where.wire_obj()}

    @classmethod
    def from_wire_obj(cls, obj) -> "Query":
        if not isinstance(obj, dict) or "s" not in obj or "w" not in obj:
            raise ValueError("malformed query")
        return cls(Select.from_wire_obj(obj["s"]), Where.from_wire_obj(obj["w"]))

    def __eq__(self, o):
        return (isinstance(o, Query) and self.select == o.select
                and self.where == o.where and self.none == o.none)

    def __hash__(self):
        return hash((tuple(self.select.get_selection()),
                     tuple(self.where.filters and map(repr, self.where.filters) or ()),
                     self.none))

    def __repr__(self):
        return f"Query[{self.select!r} {self.where!r}]"


class FieldValueIndex:
    """Projected view of a Value for a Select — what query replies carry
    instead of whole values (value.h:927-945, src/value.cpp:293-341)."""

    def __init__(self, value: Optional[Value] = None, select: Optional[Select] = None):
        self.index: dict[Field, FieldValue] = {}
        if value is None:
            return
        fields = (select.get_selection() if select and not select.empty()
                  else [Field.ID, Field.VALUE_TYPE, Field.OWNER_PK,
                        Field.SEQ_NUM, Field.USER_TYPE])
        for f in fields:
            if f == Field.ID:
                self.index[f] = FieldValue(f, value.id)
            elif f == Field.VALUE_TYPE:
                self.index[f] = FieldValue(f, value.type)
            elif f == Field.OWNER_PK:
                self.index[f] = FieldValue(
                    f, value.owner.get_id() if value.owner else InfoHash())
            elif f == Field.SEQ_NUM:
                self.index[f] = FieldValue(f, value.seq)
            elif f == Field.USER_TYPE:
                self.index[f] = FieldValue(f, value.user_type)

    def contained_in(self, other: "FieldValueIndex") -> bool:
        """Same fields present with equal values.  Stricter than the
        reference (src/value.cpp:330-341), which checks field presence
        only — value equality is what reply dedup actually needs."""
        if len(self.index) > len(other.index):
            return False
        return all(f in other.index and self.index[f] == other.index[f]
                   for f in self.index)

    def pack_fields(self) -> list:
        """Wire array of field values, canonical field order."""
        out = []
        for f in sorted(self.index):
            fv = self.index[f]
            out.append(bytes(fv.value) if isinstance(fv.value, InfoHash) else fv.value)
        return out

    @classmethod
    def unpack_fields(cls, fields: Sequence[Field], values: Sequence) -> "FieldValueIndex":
        """(src/value.cpp:374-396)"""
        fvi = cls()
        for f, v in zip(sorted(fields), values):
            fvi.index[Field(f)] = FieldValue(Field(f), v)
        return fvi

    def __repr__(self):
        return "Index[" + ",".join(repr(v) for _, v in sorted(self.index.items())) + "]"
