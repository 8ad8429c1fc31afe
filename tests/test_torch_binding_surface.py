"""The port's public surface against the JAX package's (the reference's
Python binding, python/opendht.pyx, as tests/test_binding_surface.py
holds it): every name of ``opendht_tpu.__all__`` on
``opendht_tpu_torch``, each from the port's own module; ``NodeSet``'s
behaviour equal in both; and the crypto-backed names lazy, so that
``import opendht_tpu_torch`` works on a host without ``cryptography``."""

import concurrent.futures
import json
import subprocess
import sys
from pathlib import Path

import pytest

import opendht_tpu as J
import opendht_tpu_torch as P
from test_binding_surface import PYX_SURFACE, PYX_SURFACE_CRYPTO

pytestmark = pytest.mark.quick  # sub-minute smoke tier: -m quick

REPO = Path(__file__).resolve().parents[1]

#: the lazy names of both packages that need the ``cryptography`` wheel
CRYPTO_NAMES = ("Certificate", "Identity", "PrivateKey", "PublicKey",
                "RevocationList", "TrustList", "VerifyResult",
                "generate_identity", "generate_ec_identity")


def test_pyx_class_surface_present():
    missing = [n for n in PYX_SURFACE
               if n not in PYX_SURFACE_CRYPTO and not hasattr(P, n)]
    assert not missing, missing
    # the port's runner needs no crypto wheel: it is there on every host
    assert hasattr(P, "DhtRunner")
    pytest.importorskip("cryptography")
    missing = [n for n in PYX_SURFACE_CRYPTO if not hasattr(P, n)]
    assert not missing, missing


def test_all_covers_the_jax_names_from_the_port():
    assert set(P.__all__) >= set(J.__all__)
    assert len(P.__all__) == len(set(P.__all__))
    assert set(P.__all__) - set(J.__all__) == {
        "resolve_device", "NodeTable", "Snapshot", "PendingLookup",
        "simulate_lookups", "Dht", "SecureDht"}
    pytest.importorskip("cryptography")
    for name in J.__all__:
        j, p = getattr(J, name), getattr(P, name)
        # the same class or function, by name (IndexValue is IndexEntry
        # in both), the port's from the port's own module
        assert p.__name__ == j.__name__, name
        if name == "ListenToken":
            assert p is j is concurrent.futures.Future
        else:
            assert p.__module__.split(".")[0] == "opendht_tpu_torch", name
    assert P.DhtConfig is P.Config
    assert P.telemetry.__name__ == "opendht_tpu_torch.telemetry"
    assert set(dir(P)) >= set(P.__all__)


def _nodeset_trace(o) -> tuple:
    """tests/test_binding_surface.py's NodeSet steps on package ``o``,
    with what each step gives."""
    ns = o.NodeSet()
    ids = [o.InfoHash.get(s) for s in ("x", "y", "z")]
    first = ns.insert(ids[1])
    again = ns.insert(ids[1])              # duplicate: map semantics
    ns.extend([(ids[0], None), o.NodeEntry(ids[2])])
    ordered = [e.id for e in ns]
    assert ordered == sorted(ids, key=bytes)
    assert ns.first() == ordered[0] and ns.last() == ordered[-1]
    return (first, again, len(ns), [bytes(i) for i in ordered],
            bytes(ns.first()), bytes(ns.last()), ids[0] in ns, str(ns))


def test_nodeset_sorted_semantics_equal():
    got = _nodeset_trace(P)
    assert got == _nodeset_trace(J)
    assert got[:3] == (True, False, 3) and got[6]
    assert got[7].count("\n") == 2


def test_value_where_and_listen_token_alike():
    """The binding's value names build the same things in both."""
    for o in (J, P):
        v = o.Value(b"x")
        assert v.data == b"x" and v.id == 0
        w = o.Where("WHERE id=12")
        assert str(w) == "WHERE id=12"
        assert str(o.Query(o.Select(), w)) == "Query[SELECT * WHERE id=12]"
    pv = P.Value(b"x", value_id=12)
    assert P.Where("WHERE id=12").get_filter()(pv)
    assert not P.Where("WHERE id=13").get_filter()(pv)
    assert bytes(P.InfoHash.get("k")) == bytes(J.InfoHash.get("k"))
    assert len(bytes(P.random_infohash())) == 20


_NO_CRYPTO_PROBE = """
import json, sys
names = json.loads(sys.argv[1])
sys.modules["cryptography"] = None
import opendht_tpu_torch as o
from opendht_tpu_torch import DhtRunner
out = {"runner": DhtRunner.__module__,
       "listed": sorted(set(dir(o)) & set(names)),
       "hasattr": [n for n in names if hasattr(o, n)]}
try:
    o.Certificate
except AttributeError as e:
    out["error"] = str(e)
    out["cause"] = type(e.__cause__).__name__
try:
    from opendht_tpu_torch import Identity
except ImportError as e:
    out["import_error"] = True
out["bad"] = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "opendht_tpu"))
print(json.dumps(out))
"""


def test_import_without_the_crypto_wheel():
    out = subprocess.run([sys.executable, "-c", _NO_CRYPTO_PROBE,
                          json.dumps(CRYPTO_NAMES)], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {
        "runner": "opendht_tpu_torch.runtime.runner",
        "listed": sorted(CRYPTO_NAMES), "hasattr": [],
        "error": "opendht_tpu_torch.Certificate requires the optional "
                 "'cryptography' package (runners without an identity, "
                 "the kernels and the lookup engine work without it)",
        "cause": "ModuleNotFoundError", "import_error": True, "bad": []}
