"""The port's PHT (``opendht_tpu_torch/indexation/pht.py``) and its
virtual network (``opendht_tpu_torch/testing/virtual_net.py``) against
the JAX package's, on the CPU, tolerance 0.

- Every case of tests/test_pht.py on the port: ``Prefix`` / ``Cache``
  units, and insert / lookup scenarios over the port's ``VirtualNet``
  (``device="cpu"``), leaf splits past ``MAX_NODE_ENTRY_COUNT``
  included.
- ``Prefix``, ``Cache`` and ``IndexEntry`` against the JAX classes on
  the same inputs: the same hashes, bits, cache depths and packed value
  bytes, and each package unpacks the other's entries.
- One insert / lookup sequence on a JAX and a port ``VirtualNet`` under
  the same seed (the ``TwinNode`` manner of tests/test_torch_hotcache.py:
  the same ``random`` state and ``os.urandom`` stream, the port's nodes
  handed the JAX nodes' maintenance draws) gives the same results and
  the same datagrams at the same virtual times, byte for byte.

A JAX node polls each wave's result and, while it is not ready, re-arms
the poll 2 ms of virtual time later, so on a loaded host JAX's
asynchronous CPU dispatch lets the virtual clock run ahead of the
computation (and the net spin through its event budget).  The JAX nets
here take a wave's result as ready at its first poll, as on an
unloaded host; the port's torch calls finish before they return.
"""

from __future__ import annotations

import os
import random
import socket

import numpy as np
import pytest

from opendht_tpu.core.value import Value as JValue
from opendht_tpu.indexation import pht as jpht
from opendht_tpu.infohash import InfoHash as JHash
from opendht_tpu.runtime.config import Config as JConfig
from opendht_tpu.testing import VirtualNet as JNet
from opendht_tpu_torch.core.value import Value
from opendht_tpu_torch.indexation import pht as ppht
from opendht_tpu_torch.indexation.pht import (
    MAX_NODE_ENTRY_COUNT, Cache, IndexEntry, Pht, Prefix)
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.runtime.config import Config
from opendht_tpu_torch.testing import VirtualNet

CPU = "cpu"
AF = socket.AF_INET


# ------------------------------------------------- tests/test_pht.py's cases
def test_prefix_basics():
    p = Prefix(b"\xaa\x55")          # 10101010 01010101
    assert p.size == 16
    assert p.is_content_bit_active(0)
    assert not p.is_content_bit_active(1)
    assert not p.is_content_bit_active(8)
    assert p.is_content_bit_active(15)


def test_prefix_get_prefix():
    p = Prefix(b"\xff\x00")
    q = p.get_prefix(4)
    assert q.size == 4
    assert q.content == b"\xf0"
    r = p.get_prefix(-8)             # size - 8
    assert r.size == 8 and r.content == b"\xff"
    with pytest.raises(IndexError):
        p.get_prefix(17)


def test_prefix_sibling():
    p = Prefix(b"\xf0", size=8)
    s = p.get_sibling()
    assert s.content == b"\xf1"      # last bit (pos 7) flipped
    assert p.get_prefix(4).get_sibling().content == b"\xe0"


def test_prefix_hash_distinct_by_depth():
    p = Prefix(b"\xab\xcd")
    assert p.get_prefix(8).hash() != p.get_prefix(16).hash()
    assert p.get_prefix(8).hash() == Prefix(b"\xab").hash()


def test_common_bits():
    a = Prefix(b"\xff\x00")
    b = Prefix(b"\xff\x80")
    assert Prefix.common_bits(a, b) == 8
    assert Prefix.common_bits(a, a) == 16
    c = Prefix(b"\x00\x00")
    assert Prefix.common_bits(a, c) == 0
    assert Prefix.common_bits(a, b.get_prefix(4)) == 4


def test_padding_and_flags():
    p = Prefix(b"\xab")
    p.add_padding_content(3)
    assert len(p.content) == 3
    assert p.is_content_bit_active(8)
    p.update_flags()
    assert p.is_flag_active(0) and p.is_flag_active(7)
    assert len(p.flags) == len(p.content)


def test_zcurve_interleave():
    a = Prefix(b"\xff")
    a.update_flags()
    b = Prefix(b"\x00")
    b.update_flags()
    z = Pht.zcurve([a, b])
    assert z.size == 16
    assert z.content == b"\xaa\xaa"  # 1,0 interleaved


def test_cache_insert_lookup():
    t = {"now": 0.0}
    c = Cache(clock=lambda: t["now"])
    assert c.lookup(Prefix(b"\xf0")) == -1
    c.insert(Prefix(b"\xf0").get_prefix(4))
    assert c.lookup(Prefix(b"\xf0")) == 4
    assert c.lookup(Prefix(b"\x80")) == 1
    t["now"] = 1000.0
    assert c.lookup(Prefix(b"\xf0")) == -1


def make_net(n=4):
    """Distinct loopback IPs per node and a raised ingress budget, as in
    tests/test_pht.py: the virtual clock compresses an insert cascade
    into fractions of a virtual second."""
    net = VirtualNet(device=CPU)
    cfg = lambda: Config(max_req_per_sec=100_000)       # noqa: E731
    seed = net.add_node(cfg(), host="127.0.0.1")
    for i in range(n - 1):
        net.add_node(cfg(), host=f"127.0.0.{i + 2}")
    net.bootstrap_all(seed)
    assert net.run(90, net.all_connected)
    return net


def do_insert(net, pht, key, value):
    done = {}
    pht.insert(key, value, lambda ok: done.update(ok=ok))
    assert net.run(120, lambda: "ok" in done), "insert never completed"
    assert done["ok"], "insert failed"


def do_lookup(net, pht, key, exact=True):
    out = {}
    pht.lookup(key,
               lambda vals, p: out.update(vals=list(vals), prefix=p),
               lambda ok: out.update(done=ok), exact_match=exact)
    assert net.run(120, lambda: "done" in out), "lookup never completed"
    assert out["done"], "lookup failed"
    return out.get("vals", [])


def test_pht_insert_lookup_single():
    net = make_net()
    nodes = list(net.nodes.values())
    assert all(d.device.type == CPU for d in nodes)
    pht = Pht("test", {"name": 4}, nodes[0])
    key = {"name": b"ab"}
    target = (InfoHash.get("indexed"), 42)
    do_insert(net, pht, key, target)
    assert target in do_lookup(net, pht, key)
    assert target not in do_lookup(net, pht, {"name": b"zz"})


def test_pht_lookup_from_other_node():
    net = make_net()
    nodes = list(net.nodes.values())
    pht_a = Pht("shared", {"k": 4}, nodes[0])
    pht_b = Pht("shared", {"k": 4}, nodes[2])
    target = (InfoHash.get("val"), 7)
    do_insert(net, pht_a, {"k": b"key1"}, target)
    assert target in do_lookup(net, pht_b, {"k": b"key1"})


def test_pht_multiple_entries_same_key():
    net = make_net()
    nodes = list(net.nodes.values())
    pht = Pht("multi", {"k": 2}, nodes[1])
    key = {"k": b"xy"}
    targets = [(InfoHash.get(f"v{i}"), i + 1) for i in range(4)]
    for t in targets:
        do_insert(net, pht, key, t)
    vals = do_lookup(net, pht, key)
    for t in targets:
        assert t in vals


def test_pht_split_beyond_node_capacity():
    net = make_net(3)
    nodes = list(net.nodes.values())
    pht = Pht("split", {"k": 2}, nodes[0])
    n = MAX_NODE_ENTRY_COUNT + 3
    pairs = [({"k": bytes([i, 255 - i])}, (InfoHash.get(f"s{i}"), i + 1))
             for i in range(n)]
    for key, target in pairs:
        do_insert(net, pht, key, target)
    for key, target in [pairs[0], pairs[n // 2], pairs[-1]]:
        assert target in do_lookup(net, pht, key), f"lost {key} after split"


def test_index_entry_roundtrip():
    e = IndexEntry(b"\xab\xcd", (InfoHash.get("x"), 99), "index.pht.t")
    v = e.pack()
    assert v.user_type == "index.pht.t"
    e2 = IndexEntry.unpack(v)
    assert e2.prefix == e.prefix and e2.value == e.value


# ------------------------------------------- the classes against JAX's
PREFIXES = [(b"\xaa\x55", None), (b"\xff\x00", None), (b"\xf0", 8),
            (b"\xab\xcd\xef", 20), (b"", None), (b"\x01" * 20, 160),
            (b"\x80\x00\x01", 17)]


def _both(content, size):
    kw = {} if size is None else {"size": size}
    return Prefix(content, **kw), jpht.Prefix(content, **kw)


def _same(p, j):
    assert (p.content, p.flags, p.size) == (j.content, j.flags, j.size)
    assert bytes(p.hash()) == bytes(j.hash())
    assert p.to_string() == j.to_string()


@pytest.mark.parametrize("content,size", PREFIXES)
def test_prefix_ops_equal_jax(content, size):
    p, j = _both(content, size)
    _same(p, j)
    for n in range(0, p.size + 1, max(1, p.size // 5)):
        _same(p.get_prefix(n), j.get_prefix(n))
        if n:
            _same(p.get_prefix(n).get_sibling(), j.get_prefix(n).get_sibling())
    assert [p.is_content_bit_active(i) for i in range(p.size)] == \
        [j.is_content_bit_active(i) for i in range(j.size)]
    _same(p.get_full_size(), j.get_full_size())
    for pad in (0, 2, 5):
        pp, jj = _both(content, size)
        pp.add_padding_content(len(pp.content) + pad)
        jj.add_padding_content(len(jj.content) + pad)
        pp.update_flags()
        jj.update_flags()
        _same(pp, jj)
        assert [pp.is_flag_active(i) for i in range(pp.size)] == \
            [jj.is_flag_active(i) for i in range(jj.size)]
    for other, osize in PREFIXES:
        po, jo = _both(other, osize)
        assert Prefix.common_bits(p, po) == jpht.Prefix.common_bits(j, jo)
    h = InfoHash.get(content)
    _same(Prefix.from_hash(h), jpht.Prefix.from_hash(JHash(bytes(h))))


def test_zcurve_and_linearize_equal_jax():
    spec = {"a": 3, "b": 5, "c": 1}
    rng = np.random.default_rng(4)
    pp = Pht("z", spec, None)
    jp = jpht.Pht("z", spec, None)
    for _ in range(24):
        key = {f: rng.integers(0, 256, size=rng.integers(0, n + 1),
                               dtype=np.uint8).tobytes()
               for f, n in spec.items()}
        assert pp.valid_key(key) == jp.valid_key(key)
        _same(pp.linearize(key), jp.linearize(key))


def test_cache_depths_equal_jax():
    """The same inserts and lookups on both caches over one clock give
    the same depths, expiry and the bound on elements included."""
    t = {"now": 0.0}
    pc, jc = Cache(clock=lambda: t["now"]), jpht.Cache(clock=lambda: t["now"])
    rng = np.random.default_rng(9)
    for step in range(600):
        raw = rng.integers(0, 256, size=3, dtype=np.uint8).tobytes()
        depth = int(rng.integers(1, 24))
        p, j = Prefix(raw).get_prefix(depth), jpht.Prefix(raw).get_prefix(depth)
        if rng.random() < 0.5:
            pc.insert(p)
            jc.insert(j)
        assert pc.lookup(Prefix(raw)) == jc.lookup(jpht.Prefix(raw)), step
        t["now"] += float(rng.random() * 3.0)


@pytest.mark.parametrize("i", range(4))
def test_index_entry_packs_equal_jax_and_crosses(i):
    rng = np.random.default_rng(i)
    raw = rng.integers(0, 256, size=int(rng.integers(1, 21)),
                       dtype=np.uint8).tobytes()
    h = rng.integers(0, 256, size=20, dtype=np.uint8).tobytes()
    vid = int(rng.integers(0, 2 ** 63))
    name = "index.pht.n%d" % i
    pv = IndexEntry(raw, (InfoHash(h), vid), name).pack()
    jv = jpht.IndexEntry(raw, (JHash(h), vid), name).pack()
    assert pv.data == jv.data and pv.user_type == jv.user_type
    assert (pv.id, pv.type) == (jv.id, jv.type)
    back = IndexEntry.unpack(Value(jv.data, value_id=jv.id,
                                   user_type=jv.user_type))
    jback = jpht.IndexEntry.unpack(JValue(pv.data, value_id=pv.id,
                                          user_type=pv.user_type))
    assert back.prefix == jback.prefix == raw
    assert bytes(back.value[0]) == bytes(jback.value[0]) == h
    assert back.value[1] == jback.value[1] == vid


# --------------------------------------------- one sequence on twin nets
def _seeded(monkeypatch, seed: int) -> None:
    random.seed(seed)
    rng = random.Random(seed ^ 0x5EED)
    monkeypatch.setattr(os, "urandom",
                        lambda n: bytes(rng.getrandbits(8) for _ in range(n)))


@pytest.fixture
def jax_sync_dispatch(monkeypatch):
    """A JAX wave's result counts as ready at its first poll (its consume
    then waits for the computation), as on an unloaded host."""
    from opendht_tpu.core.table import PendingLookup as JPending
    monkeypatch.setattr(JPending, "ready", lambda self: True)


def _twin_net(pkg, monkeypatch, sweeps: dict, seed: int, tag: str):
    """Four nodes of ``pkg`` on a virtual net under ``seed`` (fixed ids,
    the same ``random`` state and ``os.urandom`` stream), every datagram
    recorded (virtual arrival time, source, destination, bytes); the
    port's nodes replay the JAX nodes' maintenance draws (``sweeps``),
    their own stale buckets held equal."""
    port = pkg == "port"
    H = InfoHash if port else JHash
    _seeded(monkeypatch, seed)
    net = VirtualNet(device=CPU) if port else JNet()
    sent = []
    enqueue = net._enqueue

    def record(arrival, data, src, dst_key):
        sent.append((arrival, (src.host, src.port), dst_key, bytes(data)))
        enqueue(arrival, data, src, dst_key)
    net._enqueue = record
    C = Config if port else JConfig
    nodes = [net.add_node(C(max_req_per_sec=100_000,
                            node_id=H.get("%s-%d" % (tag, i))),
                          host=f"127.0.0.{i + 1}")
             for i in range(4)]
    for i, d in enumerate(nodes):
        table = d.tables[AF]
        orig = table.maintenance_sweep

        def sweep(now, *a, _orig=orig, _i=i, **k):
            stale, targets = _orig(now, *a, **k)
            if not port:
                sweeps.setdefault(_i, []).append((stale, targets))
                return stale, targets
            jstale, jtargets = sweeps[_i].pop(0)
            assert np.array_equal(stale, jstale)
            return jstale, jtargets
        table.maintenance_sweep = sweep
    net.bootstrap_all(nodes[0])
    assert net.run(90, net.all_connected)
    return net, nodes, sent


def _twin_sequence(pkg, monkeypatch, sweeps: dict) -> tuple:
    """Four nodes, a two-field index on node 0 with enough entries to
    split a leaf, exact and partial lookups from node 2; returns the op
    results and every datagram."""
    port = pkg == "port"
    H = InfoHash if port else JHash
    net, nodes, sent = _twin_net(pkg, monkeypatch, sweeps, 21, "pht-twin")
    P = ppht.Pht if port else jpht.Pht
    spec = {"name": 2, "kind": 1}
    writer = P("twin", spec, nodes[0], rng=random.Random(5))
    reader = P("twin", spec, nodes[2], rng=random.Random(6))
    pairs = [({"name": bytes([i, 7 * i & 0xFF]), "kind": bytes([i % 3])},
              (H.get("twin-%d" % i), i + 1))
             for i in range(MAX_NODE_ENTRY_COUNT + 6)]
    results = []
    for key, target in pairs:
        done = {}
        writer.insert(key, target, lambda ok: done.update(ok=ok))
        assert net.run(120, lambda: "ok" in done)
        results.append(("insert", done["ok"]))
    for key, _ in pairs[::3] + [({"name": b"\x00", "kind": b""}, None)]:
        for exact in (True, False):
            out = {}
            reader.lookup(key, lambda vals, p: out.update(
                vals=sorted((bytes(h), v) for h, v in vals),
                prefix=p.to_string()),
                lambda ok: out.update(done=ok), exact_match=exact)
            assert net.run(120, lambda: "done" in out)
            results.append(("lookup", exact, out.get("done"),
                            out.get("vals"), out.get("prefix")))
    return results, sent


def test_twin_nets_run_one_sequence_to_the_same_results_and_datagrams(
        monkeypatch, jax_sync_dispatch):
    sweeps: dict = {}
    jres, jsent = _twin_sequence("jax", monkeypatch, sweeps)
    pres, psent = _twin_sequence("port", monkeypatch, sweeps)
    assert all(r[1] for r in jres if r[0] == "insert")
    assert any(r[0] == "lookup" and r[3] for r in jres)
    assert pres == jres
    assert len(psent) == len(jsent) > 100
    for i, (p, j) in enumerate(zip(psent, jsent)):
        assert p == j, f"datagram {i} differs"


# ------------------ a fault of both packages, pinned (ROADMAP C.3)
def _two_indexes(pkg: str, monkeypatch, sweeps: dict) -> list:
    """Two PHT indexes ("a", "b") on node 0 of a four-node virtual net,
    40 entries inserted alternately, then each looked up exactly: the
    entries not found."""
    port = pkg == "port"
    P, H = (ppht.Pht, InfoHash) if port else (jpht.Pht, JHash)
    net, nodes, _sent = _twin_net(pkg, monkeypatch, sweeps, 5, "pht-two")
    rng = np.random.default_rng(31)
    phts = [P(name, {"name": 4, "kind": 1}, nodes[0], rng=random.Random(i))
            for i, name in enumerate(("a", "b"))]
    entries = []
    for j in range(40):
        key = {"name": rng.integers(0, 256, 4, np.uint8).tobytes(),
               "kind": bytes([int(rng.integers(0, 4))])}
        entries.append((j % 2, key, (H.get("e%d" % j), j + 1)))
        done = {}
        phts[j % 2].insert(key, entries[-1][2], lambda ok: done.update(ok=ok))
        assert net.run(120, lambda: "ok" in done) and done["ok"]
    net.run(30, None)
    missed = []
    for x, key, val in entries:
        out = {}
        phts[x].lookup(key, lambda vals, p: out.update(v=list(vals)),
                       lambda ok: out.update(done=ok))
        assert net.run(120, lambda: "done" in out)
        if val not in out.get("v", []):
            missed.append((x, key))
    return missed


def test_two_indexes_over_one_dht_lose_the_same_entries_in_both_packages(
        monkeypatch, jax_sync_dispatch):
    """Two indexes over one DHT share their trie nodes' keys
    (``Prefix.hash`` leaves the index name out) and both write canary
    value id 1 there, so one index's canary replaces the other's and
    entries become unreachable: the same entries of the 40 in both
    packages.  The fix belongs in both packages together; the port
    reproduces the JAX behaviour until then."""
    sweeps: dict = {}
    jmissed = _two_indexes("jax", monkeypatch, sweeps)
    missed = _two_indexes("port", monkeypatch, sweeps)
    assert missed == jmissed
    assert len(missed) == 5
