"""The port's host stores (``core/storage``, ``core/op_cache``,
``core/value_cache``) and its ``rate_limiter`` against the JAX package's,
on the CPU, tolerance 0.

Every case of tests/test_storage.py, tests/test_op_cache.py and
tests/test_value_cache.py, and the rate-limiter case of
tests/test_primitives.py, runs twice in one process: once as the JAX
package's test file is written, and once with each of its
``opendht_tpu`` imports turned into the same import of
``opendht_tpu_torch`` (the file is read and executed, never edited).
Both runs must pass the case's own assertions, and both must make the
same calls into the stores with the same results: a profile hook
records, in order, every function of the traced modules that returns
and what it returned (values by id, bytes and type; hashes by bytes;
containers element by element), and the two records must be equal.
The rate-limiter case of tests/test_wave_builder.py (the ingest
admission quota) is twinned by hand, on twin ``Dht`` nodes.

The helpers here (:func:`jax_case_namespace`, :func:`traced_returns`)
also drive tests/test_torch_monitor.py.
"""

from __future__ import annotations

import ast
import dataclasses
import enum
import functools
import math
import os
import random
import re
import socket
import sys
from pathlib import Path

import numpy as np
import pytest

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
PACKAGES = {"jax": "opendht_tpu", "port": "opendht_tpu_torch"}
_IMPORT = re.compile(r"^(\s*)(from|import) opendht_tpu(?=[. ])", re.M)


# ---------------------------------------------------------------- helpers
def case_names(fname: str) -> list:
    """The top-level ``test_*`` functions of tests/<fname>, in order."""
    tree = ast.parse((TESTS / fname).read_text())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]


@functools.lru_cache(maxsize=None)
def jax_case_namespace(fname: str, pkg: str) -> dict:
    """The namespace of tests/<fname> executed as written (``"jax"``) or
    with every ``opendht_tpu`` import read as ``opendht_tpu_torch``
    (``"port"``).  Line numbers are kept, so a failing assertion points
    at the JAX test's own line."""
    path = TESTS / fname
    src = path.read_text()
    if pkg == "port":
        src = _IMPORT.sub(r"\1\2 opendht_tpu_torch", src)
    ns = {"__name__": "twin_%s_%s" % (pkg, path.stem),
          "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    return ns


def norm(x, depth: int = 0):
    """A package-free, comparable form of a returned value."""
    if depth > 8:
        return ("deep",)
    if x is None or isinstance(x, (bool, int, str, bytes)):
        return x
    if isinstance(x, float):
        return "nan" if math.isnan(x) else x
    if isinstance(x, enum.Enum):
        return ("enum", type(x).__name__, x.name)
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return norm(x.item(), depth)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [norm(i, depth + 1) for i in x])
    if isinstance(x, (set, frozenset)):
        return ("set", sorted(repr(norm(i, depth + 1)) for i in x))
    if isinstance(x, dict):
        return ("dict", [(norm(k, depth + 1), norm(v, depth + 1))
                         for k, v in x.items()])
    name = type(x).__name__
    if name in ("InfoHash", "Hash", "PkId"):
        return ("hash", bytes(x))
    if name == "Value":
        return ("Value", x.id, bytes(x.data), x.type, x.user_type,
                x.seq)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (name, [(f.name, norm(getattr(x, f.name), depth + 1))
                       for f in dataclasses.fields(x)])
    if callable(x):
        return ("callable",)
    return ("object", name)


def traced_returns(fn, pkg: str, files) -> list:
    """Call ``fn()`` with a profile hook on this thread and return, in
    order, ``(qualified name, norm(result))`` for every function defined
    in ``files`` (paths inside the ``pkg`` package) that returned.  A
    module's own body is left out: whether it runs depends on what the
    process imported before."""
    root = REPO / PACKAGES[pkg]
    watched = {str(root / f) for f in files}
    rec = []

    def hook(frame, event, arg):
        if event == "return" and frame.f_code.co_filename in watched \
                and frame.f_code.co_name != "<module>":
            rec.append((frame.f_code.co_qualname, norm(arg)))
    sys.setprofile(hook)
    try:
        fn()
    finally:
        sys.setprofile(None)
    return rec


def case_calls(case, kwargs: dict, pkg: str, fname: str, files) -> list:
    """Call ``case(**kwargs)``, a function of tests/<fname> read as
    ``pkg``, with a profile hook on this thread, and return, in order,
    ``(qualified name, norm(result))`` for every call that the test
    file's own code makes into ``files`` of the package: what the JAX
    test observes of the modules it tests, whatever they call inside."""
    root = REPO / PACKAGES[pkg]
    watched = {str(root / f) for f in files}
    test_file = str(TESTS / fname)
    rec = []

    def hook(frame, event, arg):
        if event == "return" and frame.f_code.co_filename in watched \
                and frame.f_back is not None \
                and frame.f_back.f_code.co_filename == test_file:
            rec.append((frame.f_code.co_qualname, norm(arg)))
    sys.setprofile(hook)
    try:
        case(**kwargs)
    finally:
        sys.setprofile(None)
    return rec


def seed_streams(monkeypatch, seed: int) -> None:
    """``random`` seeded, and ``os.urandom`` and ``random._urandom``
    (which ``secrets`` draws through) one stream of ``seed``: the same
    draws before each run of a twin pair."""
    random.seed(seed)
    rng = random.Random(seed ^ 0x5EED)

    def urandom(n):
        return bytes(rng.getrandbits(8) for _ in range(n))
    monkeypatch.setattr(os, "urandom", urandom)
    monkeypatch.setattr(random, "_urandom", urandom)


def case_params(fname: str) -> list:
    """``(name, kwargs)`` for every case of tests/<fname>, a
    ``pytest.mark.parametrize``d case once per value."""
    ns = jax_case_namespace(fname, "jax")
    out = []
    for name in case_names(fname):
        marks = [m for m in getattr(ns[name], "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            out.append((name, {}))
            continue
        argname, values = marks[0].args[:2]
        out += [(name, {argname: v}) for v in values]
    return out


def run_twins(fname: str, name: str, files, **kwargs) -> tuple:
    """Run case ``name`` of tests/<fname> on both packages (each with
    ``kwargs`` as its fixtures) and return their traced records."""
    out = []
    for pkg in ("jax", "port"):
        case = jax_case_namespace(fname, pkg)[name]
        out.append(traced_returns(lambda: case(**kwargs), pkg, files))
    return tuple(out)


STORE_FILES = ("core/storage.py", "core/op_cache.py", "core/value_cache.py",
               "core/listener.py", "core/value.py", "rate_limiter.py")
STORE_CASES = [(f, n) for f in ("test_storage.py", "test_op_cache.py",
                                "test_value_cache.py")
               for n in case_names(f)]


# ------------------------------------------- the JAX cases, on both packages
def test_every_case_is_twinned():
    assert [n for f, n in STORE_CASES if f == "test_storage.py"] \
        and len(STORE_CASES) == 17 + 14 + 9


@pytest.mark.parametrize("fname,name", STORE_CASES,
                         ids=["%s::%s" % c for c in STORE_CASES])
def test_store_case_twin(fname, name):
    jax_rec, port_rec = run_twins(fname, name, STORE_FILES)
    assert jax_rec, "the case reached no traced function"
    assert port_rec == jax_rec


def test_rate_limiter_case_twin():
    jax_rec, port_rec = run_twins("test_primitives.py",
                                  "test_rate_limiter_quota_and_window",
                                  STORE_FILES)
    assert [q for q, _ in jax_rec].count("RateLimiter.limit") == 5
    assert port_rec == jax_rec


# ------------------------------ tests/test_wave_builder.py's quota, by hand
def _quota_node(pkg: str, clock: dict):
    """tests/test_wave_builder.py's make_dht(clock,
    ingest_admit_per_sec=2, ingest_deadline=5.0) in ``pkg``."""
    if pkg == "jax":
        from opendht_tpu.infohash import InfoHash
        from opendht_tpu.runtime import Config, Dht
        from opendht_tpu.scheduler import Scheduler
        from opendht_tpu.sockaddr import SockAddr
        place = {}
    else:
        from opendht_tpu_torch.infohash import InfoHash
        from opendht_tpu_torch.runtime import Config, Dht
        from opendht_tpu_torch.scheduler import Scheduler
        from opendht_tpu_torch.sockaddr import SockAddr
        place = {"device": "cpu"}
    dht = Dht(lambda data, addr: 0,
              config=Config(ingest_admit_per_sec=2, ingest_deadline=5.0),
              scheduler=Scheduler(clock=lambda: clock["t"]),
              has_v6=False, **place)
    rng = np.random.default_rng(1234)
    table = dht.tables[socket.AF_INET]
    added = 0
    while added < 12:
        h = InfoHash(bytes(rng.integers(0, 256, 20, dtype=np.uint8)))
        if table.insert(h, SockAddr("10.9.0.%d" % (added + 1), 4500),
                        now=clock["t"], confirm=2) is not None:
            added += 1
    return dht, InfoHash


def _admission_quota(pkg: str) -> list:
    """The body of test_admission_rate_limiter_quota; returns what it
    observed."""
    clock = {"t": 5000.0}
    dht, InfoHash = _quota_node(pkg, clock)
    results = []
    for i in range(3):
        dht.get(InfoHash.get(f"quota-{i}"),
                done_cb=lambda ok, ns, _i=i: results.append((_i, ok)))
    assert (2, False) in results
    assert dht.wave_builder.pending() == 2
    seen = [list(results), dht.wave_builder.pending()]
    clock["t"] += 1.1              # window slides: admissions resume
    dht.scheduler.sync_time()
    dht.get(InfoHash.get("quota-late"),
            done_cb=lambda ok, ns: results.append(("late", ok)))
    assert ("late", False) not in results
    assert dht.wave_builder.pending() == 3
    return seen + [list(results), dht.wave_builder.pending()]


def test_admission_rate_limiter_quota_twin():
    recs, seen = {}, {}
    for pkg in ("jax", "port"):
        random.seed(5)
        out = []
        recs[pkg] = traced_returns(lambda: out.append(_admission_quota(pkg)),
                                   pkg, ("rate_limiter.py",))
        seen[pkg] = out[0]
    assert seen["port"] == seen["jax"]
    assert recs["jax"] and recs["port"] == recs["jax"]


# ------------------------------------------- seeded sequences on both stores
def _store_sequence(pkg: str, seed: int) -> list:
    """A seeded stream of stores, refreshes, removals, expiries and clears
    on one ``Storage`` (with a quota bucket) and one ``ValueCache``; every
    result recorded."""
    if pkg == "jax":
        from opendht_tpu.core.storage import Storage, StorageBucket
        from opendht_tpu.core.value import TypeStore, Value, ValueType
        from opendht_tpu.core.value_cache import ValueCache
        from opendht_tpu.infohash import InfoHash
    else:
        from opendht_tpu_torch.core.storage import Storage, StorageBucket
        from opendht_tpu_torch.core.value import TypeStore, Value, ValueType
        from opendht_tpu_torch.core.value_cache import ValueCache
        from opendht_tpu_torch.infohash import InfoHash
    rng = random.Random(seed)
    key = InfoHash.get("sequence-%d" % seed)
    types = TypeStore()
    types.register_type(ValueType(7, "short", 5.0))
    st, bucket = Storage(), StorageBucket()
    events = []
    vc = ValueCache(lambda vals, expired: events.append(
        (sorted(v.id for v in vals), expired)) or True)
    now, out = 0.0, []
    for _ in range(200):
        now += rng.random() * 2.0
        op = rng.randrange(6)
        vid = rng.randrange(1, 12)
        v = Value(b"x" * rng.randrange(1, 40), value_id=vid,
                  type_id=rng.choice((0, 7)))
        if op == 0:
            slot, d = st.store(key, v, now, now + 10.0, bucket)
            out.append(("store", slot is not None, d.size_diff,
                        d.values_diff))
        elif op == 1:
            out.append(("refresh", st.refresh(now, vid, key)))
        elif op == 2:
            d = st.remove(key, vid)
            out.append(("remove", d.size_diff, d.values_diff))
        elif op == 3:
            n, expired = st.expire(key, now)
            out.append(("expire", n, sorted(x.id for x in expired)))
        elif op == 4:
            out.append(("cache", vc.on_values([v], [], [], types, now)))
        else:
            out.append(("cache_expire", vc.expire_values(now)))
        out.append((st.value_count(), st.total_size, bucket.size,
                    sorted(x.data.id for x in st.values)))
    out.append(("clear", vc.clear()))
    return [norm(x) for x in out] + [norm(events)]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_store_and_cache_sequence_twin(seed):
    assert _store_sequence("port", seed) == _store_sequence("jax", seed)


def _limiter_sequence(pkg: str, seed: int) -> list:
    if pkg == "jax":
        from opendht_tpu.rate_limiter import RateLimiter
    else:
        from opendht_tpu_torch.rate_limiter import RateLimiter
    rng = random.Random(seed)
    rl = RateLimiter(quota=rng.randrange(1, 6), period=1.0)
    now, out = 0.0, []
    for _ in range(300):
        now += rng.random() * 0.4
        if rng.random() < 0.1:
            out.append(("maintain", rl.maintain(now), rl.empty()))
        else:
            out.append(("limit", rl.limit(now)))
    return out


@pytest.mark.parametrize("seed", [4, 5])
def test_seeded_rate_limiter_sequence_twin(seed):
    assert _limiter_sequence("port", seed) == _limiter_sequence("jax", seed)
