"""SecureDht: crypto overlay over any Dht-like backend.

Behavioral port of the reference SecureDht (reference:
include/opendht/securedht.h:33-371, src/securedht.cpp):

- wraps a ``Dht`` (or any object with the same get/put/listen surface) and
  an :class:`~opendht_tpu_torch.crypto.Identity`;
- ``secure_type`` injects signature checks into store policies and
  owner+seq rules into edit policies (securedht.cpp:67-105);
- ``check_value`` verifies signed values and decrypts encrypted values
  addressed to us, caching sender public keys (securedht.cpp:226-264);
- ``get``/``listen`` wrap user callbacks with that filter
  (securedht.cpp:266-316);
- ``put_signed`` bumps seq past both local announces and network state
  then signs (securedht.cpp:318-354); ``put_encrypted`` resolves the
  recipient key then sign+encrypt (securedht.cpp:356-374);
- our certificate is published as a permanent CERTIFICATE_TYPE value at
  the public-key id (securedht.cpp:48-61);
- node id for the underlying Dht = H("node:" + cert-id-hex)
  (securedht.h:40-46).

A copy of the JAX package's ``runtime/secure_dht.py`` with its
behaviour unchanged.  Its crypto is the port's own copy of
``crypto.py``, reached only through ``lazy_module``, so an
identity-less SecureDht never imports ``cryptography`` or ``argon2``.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional

from ..infohash import InfoHash
from ..core.default_types import DEFAULT_INSECURE_TYPES, DEFAULT_TYPES
from ..core.value import Filters, Value, ValueType, random_value_id
from ..utils import lazy_module, unpack_msg
from .config import Config, SecureDhtConfig

# call-time dependency only: every crypto touch happens per-value or
# per-identity, so the module imports (and an identity-less SecureDht
# runs) without the `cryptography` wheel — certificate policies then
# reject stores via their existing except-paths instead of crashing
crypto = lazy_module("opendht_tpu_torch.crypto")

log = logging.getLogger("opendht_tpu_torch.secure")

WEEK = 7 * 24 * 3600.0


def _certificate_store_policy(key, value, from_id, from_addr) -> bool:
    """A certificate can only be stored at its public-key id
    (securedht.h:352-361)."""
    try:
        return crypto.Certificate(value.data).get_id() == key
    except Exception:
        return False


def _certificate_edit_policy(key, old, new, from_id, from_addr) -> bool:
    """(securedht.h:362-369)"""
    try:
        return (crypto.Certificate(old.data).get_id()
                == crypto.Certificate(new.data).get_id())
    except Exception:
        return False


CERTIFICATE_TYPE = ValueType(8, "Certificate", WEEK,
                             _certificate_store_policy,
                             _certificate_edit_policy)


def secure_node_id(cert: crypto.Certificate) -> InfoHash:
    """Dht node id derived from the certificate (securedht.h:40-46)."""
    return InfoHash.get("node:" + str(cert.get_id()))


def secure_config(conf: SecureDhtConfig) -> Config:
    """SecureDht::getConfig: fill node_id from the identity."""
    c = conf.node_config
    if not c.node_id and conf.identity and conf.identity[1] is not None:
        c.node_id = secure_node_id(conf.identity[1])
    return c


class SecureDht:
    """Crypto wrapper; forwards the full DhtInterface surface to the inner
    Dht and layers signature/encryption semantics on top."""

    def __init__(self, dht, identity: "crypto.Identity | tuple | None" = None):
        self._dht = dht
        key, cert = (identity if identity else (None, None))
        self.key: Optional[crypto.PrivateKey] = key
        self.certificate: Optional[crypto.Certificate] = cert
        #: InfoHash → Certificate
        self.node_certificates: Dict[InfoHash, crypto.Certificate] = {}
        #: InfoHash → PublicKey
        self.node_pubkeys: Dict[InfoHash, object] = {}
        #: optional local certificate store query (securedht.h:309-311)
        self.local_query_method: Optional[Callable] = None
        #: proxy-server mode: forward encrypted values unopened
        self.forward_all = False

        for vt in DEFAULT_TYPES:
            self.register_type(vt)
        for vt in DEFAULT_INSECURE_TYPES:
            self.register_insecure_type(vt)
        self.register_insecure_type(CERTIFICATE_TYPE)

        if cert is not None:
            cert_id = cert.get_id()
            if key is not None and cert_id != key.public_key().get_id():
                raise crypto.CryptoException(
                    "SecureDht: provided certificate doesn't match private key")
            v = Value(cert.pack())
            v.type = CERTIFICATE_TYPE.id
            v.id = 1
            self._dht.put(cert_id, v,
                          lambda ok, ns: ok and log.debug(
                              "public key announced successfully"),
                          permanent=True)

    # ------------------------------------------------------------- identity
    def get_id(self) -> InfoHash:
        """Our crypto-layer id = public key fingerprint (securedht.h:60-62)."""
        return (self.key.public_key().get_id() if self.key is not None
                else InfoHash())

    def get_long_id(self):
        return (self.key.public_key().get_long_id() if self.key is not None
                else None)

    # ---------------------------------------------------------------- types
    def secure_type(self, vt: ValueType) -> ValueType:
        """Wrap policies with signature enforcement (securedht.cpp:67-105)."""
        base_store, base_edit = vt.store_policy, vt.edit_policy

        def store_policy(key, v, nid, addr):
            if v.is_signed():
                # wire values carry an unparsed RawPublicKey owner; upgrade
                # it so the signature can actually be checked
                self._parse_owner(v)
                if v.owner is None or not v.check_signature():
                    log.warning("signature verification failed for %s", key,
                                extra={"dht_hash": bytes(key)})
                    return False
            return base_store(key, v, nid, addr)

        def edit_policy(key, o, n, nid, addr):
            if not o.is_signed():
                return base_edit(key, o, n, nid, addr)
            self._parse_owner(o)
            self._parse_owner(n)
            if o.owner is None or n.owner is None \
                    or o.owner.export_der() != n.owner.export_der():
                log.warning("edition forbidden: owner changed",
                            extra={"dht_hash": bytes(key)})
                return False
            if not o.owner.check_signature(n.get_to_sign(), n.signature):
                log.warning("edition forbidden: signature verification failed",
                            extra={"dht_hash": bytes(key)})
                return False
            if o.seq == n.seq:
                # identical data may be re-announced, possibly by others
                return o.get_to_sign() == n.get_to_sign()
            return n.seq > o.seq

        return ValueType(vt.id, vt.name, vt.expiration,
                         store_policy, edit_policy)

    def register_type(self, vt: ValueType) -> None:
        self._dht.register_type(self.secure_type(vt))

    def register_insecure_type(self, vt: ValueType) -> None:
        self._dht.register_type(vt)

    # ----------------------------------------------------- certificate ops
    def get_certificate(self, node: InfoHash):
        if node == self.get_id():
            return self.certificate
        return self.node_certificates.get(node)

    def get_public_key(self, node: InfoHash):
        if node == self.get_id() and self.key is not None:
            return self.key.public_key()
        return self.node_pubkeys.get(node)

    def register_certificate(self, cert_or_node, data: Optional[bytes] = None):
        """Cache a certificate; with (node, blob) form, check the id
        matches (securedht.cpp:131-160)."""
        if data is None:
            cert = cert_or_node
            if cert is not None:
                self.node_certificates[cert.get_id()] = cert
            return cert
        try:
            crt = crypto.Certificate(data)
        except Exception:
            return None
        if crt.get_id() != cert_or_node:
            log.debug("certificate %s does not match node id %s",
                      crt.get_id(), cert_or_node,
                      extra={"dht_hash": bytes(InfoHash(cert_or_node))})
            return None
        self.node_certificates[crt.get_id()] = crt
        return crt

    def find_certificate(self, node: InfoHash, cb) -> None:
        """Cache → local store → DHT get (securedht.cpp:163-203)."""
        cached = self.get_certificate(node)
        if cached is not None:
            if cb:
                cb(cached)
            return
        if self.local_query_method is not None:
            res = self.local_query_method(node)
            if res:
                self.node_certificates[node] = res[0]
                if cb:
                    cb(res[0])
                return
        state = {"found": False}

        def get_cb(values: List[Value]) -> bool:
            if state["found"]:
                return False
            for v in values:
                cert = self.register_certificate(node, v.data)
                if cert is not None:
                    state["found"] = True
                    if cb:
                        cb(cert)
                    return False
            return True

        def done_cb(ok, nodes):
            if not state["found"] and cb:
                cb(None)

        self._dht.get(node, get_cb, done_cb,
                      Filters.type_filter(CERTIFICATE_TYPE))

    def find_public_key(self, node: InfoHash, cb) -> None:
        """(securedht.cpp:205-224)"""
        pk = self.get_public_key(node)
        if pk is not None:
            if cb:
                cb(pk)
            return

        def on_cert(cert):
            if cert is not None:
                pk = cert.get_public_key()
                self.node_pubkeys[pk.get_id()] = pk
                if cb:
                    cb(pk)
                return
            if cb:
                cb(None)

        self.find_certificate(node, on_cert)

    # ------------------------------------------------------ value checking
    def check_value(self, v: Value) -> Optional[Value]:
        """Verify/decrypt one incoming value (securedht.cpp:226-264).
        Returns the value to surface, or None to drop it."""
        if v.is_encrypted():
            if self.key is None:
                return v if self.forward_all else None
            try:
                dv = self.decrypt(v)
            except Exception as e:
                log.warning("could not decrypt value %s: %s", v.id, e)
                return None
            if dv.owner is not None:
                self.node_pubkeys[dv.owner.get_id()] = dv.owner
            return dv
        if v.is_signed():
            v = self._parse_owner(v)
            if v.owner is not None and v.check_signature():
                self.node_pubkeys[v.owner.get_id()] = v.owner
                return v
            log.warning("signature verification failed for value %s", v.id)
            return None
        return v

    @staticmethod
    def _parse_owner(v: Value) -> Value:
        """Upgrade a wire RawPublicKey owner to a real PublicKey so the
        signature can actually be verified."""
        if v.owner is not None and not isinstance(v.owner, crypto.PublicKey):
            try:
                v.owner = crypto.PublicKey(v.owner.export_der())
            except Exception:
                pass
        return v

    def _filtered_get_cb(self, cb, f=None):
        """(securedht.cpp:286-303)"""
        def wrapped(values: List[Value]) -> bool:
            out = []
            for v in values:
                nv = self.check_value(v)
                if nv is not None and (not f or f(nv)):
                    out.append(nv)
            if cb and out:
                return cb(out)
            return True
        return wrapped

    def _filtered_value_cb(self, cb, f=None):
        """(securedht.cpp:266-283): listen callbacks take (values, expired)."""
        def wrapped(values: List[Value], expired: bool) -> bool:
            out = []
            for v in values:
                nv = self.check_value(v)
                if nv is not None and (not f or f(nv)):
                    out.append(nv)
            if cb and out:
                return cb(out, expired)
            return True
        return wrapped

    # ------------------------------------------------------------- ops
    def get(self, key: InfoHash, get_cb=None, done_cb=None, f=None,
            where=None) -> None:
        self._dht.get(key, self._filtered_get_cb(get_cb, f), done_cb,
                      None, where)

    def query(self, key: InfoHash, query_cb, done_cb=None, q=None) -> None:
        self._dht.query(key, query_cb, done_cb, q)

    def listen(self, key: InfoHash, cb, f=None, where=None) -> int:
        return self._dht.listen(key, self._filtered_value_cb(cb, f),
                                None, where)

    def put(self, key: InfoHash, value: Value, done_cb=None,
            created: Optional[float] = None, permanent: bool = False) -> None:
        self._dht.put(key, value, done_cb, created, permanent)

    def put_signed(self, key: InfoHash, value: Value, done_cb=None,
                   permanent: bool = False) -> None:
        """Bump seq beyond local + network state, sign, put
        (securedht.cpp:318-354)."""
        if self.key is None:
            if done_cb:
                done_cb(False, [])
            return
        if value.id == Value.INVALID_ID:
            value.id = random_value_id()

        prev = self._dht.get_put(key, value.id)
        if prev is not None and value.seq <= prev.seq:
            value.seq = prev.seq + 1

        def get_cb(values: List[Value]) -> bool:
            for v in values:
                if not v.is_signed():
                    log.error("existing non-signed value at this location")
                elif v.owner is None or v.owner.get_id() != self.get_id():
                    log.error("existing signed value belongs to someone else")
                elif value.seq <= v.seq:
                    value.seq = v.seq + 1
            return True

        def done(ok, nodes):
            self.sign(value)
            self._dht.put(key, value, done_cb, None, permanent)

        self.get(key, get_cb, done, Filters.id_filter(value.id))

    def put_encrypted(self, key: InfoHash, to: InfoHash, value: Value,
                      done_cb=None, permanent: bool = False) -> None:
        """Resolve recipient key, sign + encrypt, put
        (securedht.cpp:356-374)."""
        def on_pk(pk):
            if pk is None:
                if done_cb:
                    done_cb(False, [])
                return
            try:
                ev = self.encrypt(value, pk)
            except Exception as e:
                log.error("error putting encrypted data: %s", e)
                if done_cb:
                    done_cb(False, [])
                return
            self._dht.put(key, ev, done_cb, None, permanent)

        self.find_public_key(to, on_pk)

    # ------------------------------------------------------ crypto helpers
    def sign(self, v: Value) -> None:
        if self.key is None:
            raise crypto.CryptoException("no private key")
        v.sign(self.key)

    def encrypt(self, v: Value, to) -> Value:
        if self.key is None:
            raise crypto.CryptoException("no private key")
        return v.encrypt(self.key, to)

    def decrypt(self, v: Value) -> Value:
        """(securedht.cpp:390-408)"""
        if not v.is_encrypted():
            raise crypto.CryptoException("data is not encrypted")
        plain = self.key.decrypt(v.cypher)
        ret = Value(value_id=v.id)
        ret._unpack_body(unpack_msg(plain))
        if ret.recipient != self.get_id():
            raise crypto.DecryptError("recipient mismatch")
        ret = self._parse_owner(ret)
        if ret.owner is None or not ret.check_signature():
            raise crypto.DecryptError("signature mismatch")
        return ret

    # ------------------------------------------------------ forwarding
    def __getattr__(self, name):
        # everything else (periodic, insert_node, stats, export/import,
        # cancel_*, shutdown, ...) passes straight to the wrapped Dht
        return getattr(self._dht, name)
