"""The port's crypto layer and ``SecureDht`` against the JAX package's.

- Keys and certificates exported by one package load in the other to
  the same DER, for RSA and EC keys, both ways.
- A signature made by one package verifies in the other, data encrypted
  by one decrypts in the other (the plain-RSA and the hybrid AES-GCM
  layouts), a value signed by one checks in the other, and a
  password-sealed blob opens in the other.
- The policies of tests/test_secure_dht.py run on twin virtual clusters,
  one of JAX nodes and one of port nodes (``device="cpu"``), over the
  same identities (the port's carried by ``convert.identity_from_jax``),
  with the same results.
- ``convert.identity_from_jax`` for RSA, EC and CA-signed identities.
- Every case of tests/test_crypto.py (the reference's cryptotester.cpp
  suite and the serialization / KDF helpers), each parametrized value
  apart, on both packages: as the JAX file is written and with its
  imports read as the port's, each with identities of its own package.
  Both pass the case's assertions and make the same calls into
  ``crypto.py`` in the same order.  Keys, signatures, ciphertexts, salts
  and serial numbers come from OpenSSL's random source, which neither
  package seeds, so a call's result is compared whole where no random
  draw reaches it (booleans, None, numbers, ``hash_data``, names) and
  by its type elsewhere (:func:`crypto_view`).
"""

from __future__ import annotations

import heapq
import importlib
import inspect
import itertools
import random

import pytest

from opendht_tpu import crypto as jcrypto
from opendht_tpu_torch import convert
from opendht_tpu_torch import crypto as pcrypto
from test_torch_storage import case_calls, case_params, jax_case_namespace

PORT, JAX = "opendht_tpu_torch", "opendht_tpu"
CRYPTO = {JAX: jcrypto, PORT: pcrypto}
DIRECTIONS = [(JAX, PORT), (PORT, JAX)]
DIR_IDS = ["jax_to_port", "port_to_jax"]


@pytest.fixture(scope="module")
def jax_identities():
    # module-scoped: RSA keygen is the slow part
    return [jcrypto.generate_identity(f"node{i}", key_length=1024)
            for i in range(3)]


@pytest.fixture(scope="module")
def keys():
    """One identity of each kind made by each package."""
    return {(pkg, kind): (CRYPTO[pkg].generate_identity(
        f"{pkg}-{kind}", key_length=1024) if kind == "rsa"
        else CRYPTO[pkg].generate_ec_identity(f"{pkg}-{kind}"))
        for pkg in (JAX, PORT) for kind in ("rsa", "ec")}


# -------------------------------------------- keys and certificates
@pytest.mark.parametrize("kind", ["rsa", "ec"])
@pytest.mark.parametrize("src,dst", DIRECTIONS, ids=DIR_IDS)
def test_keys_and_certificates_load_across_to_the_same_der(keys, kind,
                                                           src, dst):
    key, cert = keys[(src, kind)]
    D = CRYPTO[dst]
    k2 = D.PrivateKey(key.serialize())
    c2 = D.Certificate(cert.pack())
    assert k2.serialize() == key.serialize()
    assert k2.public_key().export_der() == key.public_key().export_der()
    assert c2.pack() == cert.pack()
    assert bytes(c2.get_id()) == bytes(cert.get_id())
    assert bytes(k2.public_key().get_id()) == \
        bytes(key.public_key().get_id())
    assert bytes(c2.get_long_id()) == bytes(cert.get_long_id())
    assert c2.get_name() == cert.get_name() and c2.is_ca() == cert.is_ca()
    assert D.PublicKey(key.public_key().export_der()).export_der() == \
        key.public_key().export_der()


@pytest.mark.parametrize("kind", ["rsa", "ec"])
@pytest.mark.parametrize("src,dst", DIRECTIONS, ids=DIR_IDS)
def test_a_signature_verifies_across(keys, kind, src, dst):
    key, _ = keys[(src, kind)]
    pk = CRYPTO[dst].PublicKey(key.public_key().export_der())
    data = b"signed by one package" * 7
    sig = key.sign(data)
    assert pk.check_signature(data, sig)
    assert not pk.check_signature(data + b"!", sig)


@pytest.mark.parametrize("size", [40, 3000], ids=["rsa_block", "hybrid"])
@pytest.mark.parametrize("src,dst", DIRECTIONS, ids=DIR_IDS)
def test_data_encrypted_by_one_decrypts_in_the_other(keys, size, src, dst):
    """``src`` encrypts to ``dst``'s public key; ``dst`` decrypts."""
    key, _ = keys[(dst, "rsa")]
    pk = CRYPTO[src].PublicKey(key.public_key().export_der())
    data = bytes(range(256)) * (size // 256) + bytes(range(size % 256))
    assert key.decrypt(pk.encrypt(data)) == data


@pytest.mark.parametrize("src,dst", DIRECTIONS, ids=DIR_IDS)
def test_a_signed_value_checks_across(keys, src, dst):
    V = {p: importlib.import_module(f"{p}.core.value").Value
         for p in (JAX, PORT)}
    key, _ = keys[(src, "rsa")]
    v = V[src](b"payload", value_id=9)
    v.seq = 3
    v.sign(key)
    w = V[dst].from_packed(v.get_packed())
    w.owner = CRYPTO[dst].PublicKey(w.owner.export_der())
    assert w.check_signature() and w.get_packed() == v.get_packed()
    w.data = b"tampered"
    assert not w.check_signature()


@pytest.mark.parametrize("src,dst", DIRECTIONS, ids=DIR_IDS)
def test_a_password_sealed_blob_opens_across(src, dst):
    blob = CRYPTO[src].aes_encrypt_password(b"local secret", "hunter2")
    assert CRYPTO[dst].aes_decrypt_password(blob, "hunter2") == \
        b"local secret"
    with pytest.raises(CRYPTO[dst].CryptoException):
        CRYPTO[dst].aes_decrypt_password(blob, "wrong")


# ------------------------------------------------------ identity_from_jax
@pytest.mark.parametrize("kind", ["rsa", "ec", "ca_signed"])
def test_identity_from_jax(kind):
    if kind == "ec":
        src = jcrypto.generate_ec_identity("ec-node")
    elif kind == "rsa":
        src = jcrypto.generate_identity("rsa-node", key_length=1024)
    else:
        ca = jcrypto.generate_identity("ca", key_length=1024)
        src = jcrypto.generate_identity("leaf", ca, key_length=1024)
    dst = convert.identity_from_jax(src)
    assert isinstance(dst, pcrypto.Identity) and dst
    assert isinstance(dst.first, pcrypto.PrivateKey)
    assert dst.first.serialize() == src.first.serialize()
    assert dst.second.pack() == src.second.pack()
    assert bytes(dst.second.get_id()) == bytes(src.second.get_id())
    if kind == "ca_signed":
        assert dst.second.issuer is not None
        assert dst.second.signed_by(dst.second.issuer)
        assert not dst.second.is_ca()
    sig = dst.first.sign(b"carried")
    assert src.first.public_key().check_signature(b"carried", sig)
    empty = convert.identity_from_jax(None)
    assert empty.first is None and empty.second is None and not empty


# -------------------------------------- tests/test_secure_dht.py, twinned
def _mods(pkg):
    m = {k: importlib.import_module(f"{pkg}.{k}")
         for k in ("infohash", "sockaddr", "scheduler", "runtime",
                   "core.value", "runtime.secure_dht")}
    return {"InfoHash": m["infohash"].InfoHash,
            "SockAddr": m["sockaddr"].SockAddr,
            "Scheduler": m["scheduler"].Scheduler,
            "Config": m["runtime"].Config, "Dht": m["runtime"].Dht,
            "Value": m["core.value"].Value,
            "Filters": m["core.value"].Filters,
            "SecureDht": m["runtime.secure_dht"].SecureDht,
            "secure_node_id": m["runtime.secure_dht"].secure_node_id,
            "CERTIFICATE_TYPE": m["runtime.secure_dht"].CERTIFICATE_TYPE}


class Net:
    """Dht nodes of one package on a virtual clock: datagrams queue on
    one event heap and the clock jumps to the next arrival or job."""

    def __init__(self, pkg: str):
        self.pkg, self.M = pkg, _mods(pkg)
        self.clock = 0.0
        self.nodes: dict = {}
        self._q: list = []
        self._seq = itertools.count()

    def add(self, node_id) -> object:
        key = ("127.0.0.1", 20000 + len(self.nodes))

        def send(data, dest, _src=key):
            heapq.heappush(self._q, (self.clock + 0.01, next(self._seq),
                                     bytes(data), _src,
                                     (dest.host, dest.port)))
            return 0
        kw = {"device": "cpu"} if self.pkg == PORT else {}
        d = self.M["Dht"](send, self.M["Config"](node_id=node_id),
                          self.M["Scheduler"](clock=lambda: self.clock),
                          has_v6=False, **kw)
        d.key = key
        self.nodes[key] = d
        return d

    def bootstrap(self, seed) -> None:
        for d in self.nodes.values():
            if d is not seed:
                d.insert_node(seed.myid, self.M["SockAddr"](*seed.key))
                d.ping_node(self.M["SockAddr"](*seed.key))

    def run(self, max_time: float, until=None) -> bool:
        end = self.clock + max_time
        while True:
            if until is not None and until():
                return True
            t = min([d.scheduler.next_job_time()
                     for d in self.nodes.values()]
                    + [self._q[0][0] if self._q else float("inf")])
            if t > end:
                self.clock = end
                return until() if until is not None else False
            self.clock = max(self.clock, t)
            while self._q and self._q[0][0] <= self.clock:
                _, _, data, src, dst = heapq.heappop(self._q)
                d = self.nodes.get(dst)
                if d is not None:
                    d.periodic(data, self.M["SockAddr"](*src))
            for d in self.nodes.values():
                if d.scheduler.next_job_time() <= self.clock:
                    d.periodic(None, None)

    def all_connected(self) -> bool:
        return all(d.get_status().name == "CONNECTED"
                   for d in self.nodes.values())


def _identities(pkg, jax_identities):
    if pkg == JAX:
        return jax_identities
    return [convert.identity_from_jax(i) for i in jax_identities]


def make_secure_net(pkg, jax_identities, n_plain: int = 4):
    """`n_plain` plain nodes + one SecureDht per identity, connected."""
    random.seed(11)
    net = Net(pkg)
    M = net.M
    seed = net.add(M["InfoHash"].get("plain-0"))
    for i in range(1, n_plain):
        net.add(M["InfoHash"].get(f"plain-{i}"))
    secured = []
    for ident in _identities(pkg, jax_identities):
        d = net.add(M["secure_node_id"](ident.second))
        secured.append(M["SecureDht"](d, ident))
    net.bootstrap(seed)
    assert net.run(90, net.all_connected), "virtual net never connected"
    return net, secured


def case_put_signed_get_verified(pkg, ids):
    net, (a, b, _) = make_secure_net(pkg, ids)
    M = net.M
    key = M["InfoHash"].get("signed-key")
    v = M["Value"](b"signed payload")
    done = {}
    a.put_signed(key, v, lambda ok, ns: done.update(ok=ok))
    assert net.run(90, lambda: "ok" in done), "put_signed never completed"
    got = []
    b.get(key, lambda vals: got.extend(vals) or True)
    assert net.run(60, lambda: got), "get never saw the signed value"
    return {"ok": done["ok"], "signed": v.is_signed(), "seq": v.seq,
            "data": got[0].data, "check": got[0].check_signature(),
            "owner_is_a": bytes(got[0].owner.get_id()) == bytes(a.get_id()),
            "key_cached": b.get_public_key(a.get_id()) is not None}


def case_put_signed_bumps_seq(pkg, ids):
    net, (a, b, _) = make_secure_net(pkg, ids)
    M = net.M
    key = M["InfoHash"].get("seq-key")
    seqs = []
    for body in (b"version one", b"version two"):
        v = M["Value"](body)
        v.id = 7
        done = {}
        a.put_signed(key, v, lambda ok, ns: done.update(ok=ok))
        assert net.run(90, lambda: "ok" in done) and done["ok"]
        seqs.append(v.seq)
    got = []
    b.get(key, lambda vals: got.extend(vals) or True,
          f=M["Filters"].id_filter(7))
    assert net.run(60, lambda: got)
    assert seqs[1] > seqs[0]
    return {"seqs": seqs, "data": sorted({v.data for v in got})}


def case_put_encrypted_only_recipient_reads(pkg, ids):
    net, (a, b, c) = make_secure_net(pkg, ids)
    M = net.M
    key = M["InfoHash"].get("encrypted-key")
    done = {}
    a.put_encrypted(key, b.get_id(), M["Value"](b"for bob only"),
                    lambda ok, ns: done.update(ok=ok))
    assert net.run(120, lambda: "ok" in done)
    got_b, got_c, raw, state = [], [], [], {}
    b.get(key, lambda vals: got_b.extend(vals) or True)
    assert net.run(60, lambda: got_b)
    c.get(key, lambda vals: got_c.extend(vals) or True,
          done_cb=lambda ok, ns: state.update(done=True))
    assert net.run(60, lambda: "done" in state)
    c._dht.get(key, lambda vals: raw.extend(vals) or True)
    assert net.run(60, lambda: raw)
    return {"ok": done["ok"], "b": [v.data for v in got_b],
            "owner_is_a": bytes(got_b[0].owner.get_id()) == bytes(a.get_id()),
            "c": [v.data for v in got_c],
            "raw_encrypted": raw[0].is_encrypted()}


def case_find_certificate(pkg, ids):
    net, (a, b, _) = make_secure_net(pkg, ids)
    net.run(5.0)
    found, again = [], []
    b.find_certificate(a.get_id(), found.append)
    assert net.run(90, lambda: found), "find_certificate never returned"
    b.find_certificate(a.get_id(), again.append)
    return {"found": found[0] is not None and bytes(found[0].get_id())
            == bytes(a.get_id()), "cached_sync": bool(again)
            and bytes(again[0].get_id()) == bytes(a.get_id())}


def case_certificate_type_policy(pkg, ids):
    M = _mods(pkg)
    ident = _identities(pkg, ids)[0]
    v = M["Value"](ident.second.pack())
    v.type = M["CERTIFICATE_TYPE"].id
    ct = M["CERTIFICATE_TYPE"]
    return {"ok_key": ct.store_policy(ident.second.get_id(), v, None, None),
            "bad_key": ct.store_policy(M["InfoHash"].get("not the key"), v,
                                       None, None)}


def case_store_policy_rejects_bad_signature(pkg, ids):
    net, (a, b, _) = make_secure_net(pkg, ids)
    M = net.M
    key = M["InfoHash"].get("tamper-key")
    v = M["Value"](b"authentic")
    v.seq = 0
    v.sign(_identities(pkg, ids)[0].first)
    v.data = b"tampered!!"
    done = {}
    a._dht.put(key, v, lambda ok, ns: done.update(ok=ok))
    net.run(90, lambda: "ok" in done)
    got, state = [], {}
    b.get(key, lambda vals: got.extend(vals) or True)
    b.get(key, lambda vals: True, lambda ok, ns: state.update(done=True))
    assert net.run(60, lambda: "done" in state)
    return {"surfaced": [x.data for x in got]}


def case_edit_policy_requires_increasing_seq(pkg, ids):
    net, secured = make_secure_net(pkg, ids, n_plain=2)
    M = net.M
    idents = _identities(pkg, ids)
    vt = secured[0]._dht.types.get_type(M["Value"](b"").type)
    key = M["InfoHash"].get("edit")

    def signed(body, seq, who=0):
        v = M["Value"](body)
        v.seq = seq
        v.sign(idents[who].first)
        return v
    old = signed(b"old", 5)
    return {name: vt.edit_policy(key, old, new, None, None)
            for name, new in (("newer", signed(b"new", 6)),
                              ("stale", signed(b"stale", 4)),
                              ("other_owner", signed(b"other", 7, 1)),
                              ("same", signed(b"old", 5)))}


POLICY_CASES = {
    case_put_signed_get_verified: {"ok": True, "signed": True,
                                   "data": b"signed payload",
                                   "check": True, "owner_is_a": True,
                                   "key_cached": True},
    case_put_signed_bumps_seq: {"data": [b"version two"]},
    case_put_encrypted_only_recipient_reads: {
        "ok": True, "b": [b"for bob only"], "owner_is_a": True, "c": [],
        "raw_encrypted": True},
    case_find_certificate: {"found": True, "cached_sync": True},
    case_certificate_type_policy: {"ok_key": True, "bad_key": False},
    case_store_policy_rejects_bad_signature: {"surfaced": []},
    case_edit_policy_requires_increasing_seq: {
        "newer": True, "stale": False, "other_owner": False, "same": True},
}


@pytest.mark.parametrize("case", list(POLICY_CASES),
                         ids=lambda c: c.__name__[5:])
def test_secure_policies_give_the_same_results(case, jax_identities):
    got = {pkg: case(pkg, jax_identities) for pkg in (JAX, PORT)}
    assert got[PORT] == got[JAX]
    want = POLICY_CASES[case]
    assert {k: got[PORT][k] for k in want} == want


# ------------------------------------------------- tests/test_crypto.py
CRYPTO_CASES = case_params("test_crypto.py")
# results that no random draw reaches, besides booleans, None and numbers
CRYPTO_EXACT = ("hash_data", "Certificate.get_name",
                "Certificate.get_issuer_name")


def crypto_view(rec: list) -> list:
    """A crypto call record with each result that a key, a nonce or a
    salt reaches reduced to its type."""
    return [(name, res if name in CRYPTO_EXACT or res is None
             or isinstance(res, (bool, int, float))
             else ("kind", res[0] if isinstance(res, tuple)
                   else type(res).__name__))
            for name, res in rec]


def test_every_crypto_case_is_twinned():
    assert len({n for n, _ in CRYPTO_CASES}) == 19
    assert len(CRYPTO_CASES) == 19 + 5          # six sizes of one case


@pytest.mark.parametrize("name,kw", CRYPTO_CASES,
                         ids=["%s%s" % (n, "".join(f"[{v}]" for v in
                                                   kw.values()))
                              for n, kw in CRYPTO_CASES])
def test_jax_crypto_case_twin(name, kw, monkeypatch):
    recs = []
    for pkg in ("jax", "port"):
        ns = jax_case_namespace("test_crypto.py", pkg)
        case = ns[name]
        params = inspect.signature(case).parameters
        fix = dict(kw)
        # the file's module fixtures, made by the run's own package
        if "identity" in params:
            fix["identity"] = ns["crypto"].generate_identity(
                "testsign", key_length=1024)
        if "ec_identity" in params:
            fix["ec_identity"] = ns["crypto"].generate_ec_identity(
                "testsign-ec")
        recs.append(crypto_view(case_calls(case, fix, pkg, "test_crypto.py",
                                           ("crypto.py",))))
    assert recs[1] == recs[0]
