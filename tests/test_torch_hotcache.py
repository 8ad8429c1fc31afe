"""The port's hot-value cache (``opendht_tpu_torch/hotcache.py`` and
``ops/cache_probe.py``) against the JAX package's, and a port node at
its defaults against a JAX node at its defaults.

- ``cache_probe`` on the CPU, bit-identical to the JAX function and to
  the numpy mirror ``probe_host``, at the budget shape
  (``perf_budgets.json`` ``kernels.cache_probe``: Q=64, C=64) and at
  edge cases: duplicate targets, all-invalid rows, ids with the top bit
  set, a table with duplicate rows (the lowest valid one answers).
- ``HotValueCache``, step by step against the JAX class: the same
  admissions, evictions, capacity bound, fill-on-get offers with their
  freshness tokens, invalidations, probes and ``serve_one`` answers,
  replica sets and snapshots; the go-dark contract.
- Twin nodes at the defaults (every plane on, the resharder included):
  the same datagrams at the same virtual times — locally stored values,
  a Zipf get stream that turns keys hot, cache hits, ``replica_k`` 16
  and the widened announce walk, a client's get_values for a hot key —
  give the same op results and the same outbound datagrams, reply bytes
  included.  The maintenance sweep's refresh targets are random draws
  (jax.random in one table, torch in the other): the port's node is
  handed the JAX node's draws, its own stale buckets held equal.
- A JAX node with live planes carried across (``convert.dht_from_jax``)
  answers the same next requests.
"""

from __future__ import annotations

import importlib
import os
import random
import socket

import numpy as np
import pytest
import torch

from opendht_tpu import telemetry as jtel
from opendht_tpu.hotcache import HotCacheConfig as JCfg
from opendht_tpu.hotcache import HotValueCache as JCache
from opendht_tpu.infohash import InfoHash as JHash
from opendht_tpu.ops import cache_probe as JCP
from opendht_tpu_torch import convert
from opendht_tpu_torch import telemetry as ptel
from opendht_tpu_torch.hotcache import HotCacheConfig, HotValueCache
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.ops import cache_probe as PCP
from opendht_tpu_torch.ops import ids as IK

PORT, JAX = "opendht_tpu_torch", "opendht_tpu"
AF = socket.AF_INET
CPU = "cpu"


# ------------------------------------------------------------ the probe
def probe_inputs(seed: int, q: int, c: int):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2 ** 32, size=(c, 5), dtype=np.uint32)
    valid = rng.random(c) < 0.75
    table[: c // 8, 0] |= np.uint32(0x80000000)
    if c >= 4:
        table[3] = table[1]                     # a duplicate row
        valid[1] = False                        # ... the lower invalid
        valid[3] = True
    targets = rng.integers(0, 2 ** 32, size=(q, 5), dtype=np.uint32)
    hits = rng.integers(0, c, size=q // 2)
    targets[: q // 2] = table[hits]             # members, live or not
    if q >= 4:
        targets[2] = targets[1]                 # duplicate targets
    return table, valid, targets


@pytest.mark.parametrize("q,c", [(64, 64), (1, 64), (64, 1), (200, 7)])
@pytest.mark.parametrize("valid_kind", ["mixed", "none", "all"])
def test_cache_probe_equals_jax_and_numpy(q, c, valid_kind):
    table, valid, targets = probe_inputs(q * 31 + c, q, c)
    if valid_kind != "mixed":
        valid[:] = valid_kind == "all"
    want = [np.asarray(x) for x in JCP.cache_probe(table, valid, targets)]
    host = PCP.probe_host(table, valid, targets)
    got = PCP.cache_probe(IK.to_keys(table, CPU), torch.from_numpy(valid),
                          targets)
    for w, h, g in zip(want, host, got):
        assert g.dtype == {np.dtype(bool): torch.bool,
                           np.dtype(np.int32): torch.int32}[w.dtype]
        assert np.array_equal(g.numpy(), w) and np.array_equal(h, w)
    if valid_kind == "none":
        assert not want[0].any() and (want[1] == -1).all()


# ------------------------------------------------------------ the cache
def fresh_registries(monkeypatch) -> dict:
    """A fresh telemetry registry for each package (the planes register
    their series at construction), by package."""
    regs = {}
    for pkg, mod in ((JAX, jtel), (PORT, ptel)):
        reg = regs[pkg] = mod.MetricsRegistry()
        reg.enabled = True
        monkeypatch.setattr(mod, "_registry", reg, raising=False)
        monkeypatch.setattr(mod, "get_registry", lambda r=reg: r)
    return regs


def _jvals(vals):
    from opendht_tpu.core.value import Value as JV
    return [JV(v.data, value_id=v.id) for v in vals]


class _TwinCaches:
    """A JAX and a port HotValueCache over one host store (the port's
    values; the JAX cache is handed equal JAX values) and one clock."""

    def __init__(self, **cfg):
        self.now = {"t": 0.0}
        self.store = {}
        clock = lambda: self.now["t"]               # noqa: E731
        self.j = JCache(JCfg(**cfg), local_values=lambda kb: _jvals(
            self.store.get(kb, [])), clock=clock)
        self.p = HotValueCache(HotCacheConfig(**cfg),
                               local_values=lambda kb: self.store.get(kb, []),
                               clock=clock, device=CPU)

    def both(self, name, *args, jargs=None):
        got = getattr(self.p, name)(*args)
        want = getattr(self.j, name)(*(jargs if jargs is not None
                                       else args))
        return got, want

    def same(self):
        sp, sj = self.p.snapshot(), self.j.snapshot()
        assert sp == sj
        assert self.p.hit_ratio() == self.j.hit_ratio()
        assert self.p._inval_seq == self.j._inval_seq
        assert self.p._slots == self.j._slots
        if self.j._ids_dev is not None:
            assert np.array_equal(IK.from_keys(self.p._ids_dev),
                                  np.asarray(self.j._ids_dev))
            assert np.array_equal(self.p._valid_dev.numpy(),
                                  np.asarray(self.j._valid_dev))


def _top(keys, hot=True, base=100):
    return [{"key": k.hex(), "_key": k, "estimate": base - i,
             "share": 0.5, "hot": hot} for i, k in enumerate(keys)]


def _data(vals):
    return None if vals is None else [(v.id, bytes(v.data)) for v in vals]


def test_cache_state_machine_matches_jax_step_by_step(monkeypatch):
    """Admission from the store, fill-on-get with its freshness token,
    probes (eligible and not), serve_one, invalidation, capacity
    eviction, TTL expiry and decay out of the hot set: the same answers
    and the same state after every step."""
    from opendht_tpu_torch.core.value import Value
    fresh_registries(monkeypatch)
    t = _TwinCaches(capacity=4, entry_ttl=5.0)
    keys = [bytes(InfoHash.get(f"hc-sm-{i}")) for i in range(8)]
    for i, k in enumerate(keys[:5]):
        t.store[k] = [Value(b"v%d" % i, value_id=i + 1)]
    rng = np.random.default_rng(3)
    for step in range(14):
        t.now["t"] = step * 1.5
        hot = [keys[i] for i in sorted(set(
            rng.choice(8, size=int(rng.integers(0, 7)))))]
        t.both("on_keyspace_tick", _top(hot))
        t.same()
        for k in keys:
            got, want = t.both("wants", k)
            assert got == want
        k = keys[int(rng.integers(0, 8))]
        tok_p, tok_j = t.both("offer_token", k)
        assert tok_p == tok_j
        if step % 4 == 1:
            t.both("invalidate", keys[int(rng.integers(0, 8))])
        vals = [Value(b"got-%d" % step, value_id=50 + step)]
        got, want = t.both("offer", k, vals, tok_p,
                           jargs=(k, _jvals(vals), tok_j))
        assert got == want
        targets = [InfoHash(keys[i]) for i in rng.integers(0, 8, size=6)]
        elig = list(rng.random(6) < 0.7)
        got = t.p.probe_wave(targets, elig)
        want = t.j.probe_wave([JHash(bytes(x)) for x in targets], elig)
        assert [_data(v) for v in got] == [_data(v) for v in want]
        got, want = t.both("serve_one", keys[step % 8])
        assert _data(got) == _data(want)
        for k in keys:
            got, want = t.both("replica_k", k)
            assert got == want
        t.same()
    assert t.p.snapshot()["hits"] > 0 and t.p.snapshot()["evictions"] > 0


def test_probe_go_dark_matches_jax(monkeypatch):
    """A failing probe turns the cache off and clears it, as in JAX: the
    wave proceeds unserved, nothing widens, the same snapshot."""
    from opendht_tpu_torch.core.value import Value
    fresh_registries(monkeypatch)
    t = _TwinCaches()
    k = bytes(InfoHash.get("hc-dark"))
    t.store[k] = [Value(b"v", value_id=1)]
    t.both("on_keyspace_tick", _top([k]))

    def boom(*a, **kw):
        raise RuntimeError("device lost")
    import opendht_tpu_torch.hotcache as PH
    monkeypatch.setattr(PH, "cache_probe", boom)
    monkeypatch.setattr(JCP, "cache_probe", boom)
    assert t.p.probe_wave([InfoHash(k)], [True]) == [None]
    assert t.j.probe_wave([JHash(k)], [True]) == [None]
    assert not t.p.enabled and not t.j.enabled
    assert t.p.snapshot() == t.j.snapshot()
    assert t.p.replica_k(k) == t.j.replica_k(k) == 8


def test_the_table_lives_on_the_cache_device_and_dark_without_it(
        monkeypatch):
    from opendht_tpu_torch.core.value import Value
    fresh_registries(monkeypatch)
    k = bytes(InfoHash.get("hc-dev"))
    hc = HotValueCache(local_values=lambda kb: [Value(b"x", value_id=1)],
                       clock=lambda: 0.0, device=CPU)
    hc.on_keyspace_tick(_top([k]))
    assert _data(hc.probe_wave([InfoHash(k)], [True])[0]) == [(1, b"x")]
    assert hc._ids_dev.device.type == "cpu" and hc._ids_dev.shape == (64, 5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dark = HotValueCache(local_values=lambda kb: [Value(b"x", value_id=1)],
                         clock=lambda: 0.0, device=None)
    dark.on_keyspace_tick(_top([k]))
    assert dark.probe_wave([InfoHash(k)], [True]) == [None]
    assert not dark.enabled


# --------------------------------------------- twin nodes at the defaults
def mods(pkg: str) -> dict:
    m = {k: importlib.import_module(f"{pkg}.{k}")
         for k in ("infohash", "sockaddr", "scheduler", "runtime",
                   "core.value", "net.engine")}
    return {"InfoHash": m["infohash"].InfoHash,
            "SockAddr": m["sockaddr"].SockAddr,
            "Scheduler": m["scheduler"].Scheduler,
            "Config": m["runtime"].Config, "Dht": m["runtime"].Dht,
            "Value": m["core.value"].Value, "Query": m["core.value"].Query,
            "Where": m["core.value"].Where,
            "NetworkEngine": m["net.engine"].NetworkEngine,
            "EngineCallbacks": m["net.engine"].EngineCallbacks}


def seeded(monkeypatch, seed: int) -> None:
    """The same ``random`` state and ``os.urandom`` stream before each
    node of a twin pair."""
    random.seed(seed)
    rng = random.Random(seed ^ 0x5EED)
    monkeypatch.setattr(os, "urandom",
                        lambda n: bytes(rng.getrandbits(8) for _ in range(n)))


class TwinNode:
    """One node of either package at its defaults (every plane on, the
    resharder included) on a virtual clock, a 300-row table at loopback addresses that answer nothing,
    and a transport that records (virtual time, destination, bytes).
    ``sweeps`` carries the JAX node's maintenance draws to the port's
    (None: a node on its own, its draws its own)."""

    def __init__(self, pkg, monkeypatch, sweeps: list, name: str,
                 seed: int = 5, **cfg):
        self.pkg, self.M = pkg, mods(pkg)
        M = self.M
        seeded(monkeypatch, seed)
        self.clock = {"t": 0.0}
        self.sent = []
        kw = {"device": CPU} if pkg == PORT else {}
        self.dht = M["Dht"](
            lambda d, a: self.sent.append((self.clock["t"], str(a),
                                           bytes(d))) and 0,
            M["Config"](node_id=M["InfoHash"].get(name), **cfg),
            M["Scheduler"](clock=lambda: self.clock["t"]),
            has_v6=False, **kw)
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, 2 ** 32, size=(300, 5), dtype=np.uint32)
        table = self.dht.tables[AF]
        table.bulk_load(ids, 0.0, addrs=M["SockAddr"]("127.0.0.2", 4567))
        if sweeps is None:
            return
        orig = table.maintenance_sweep

        def sweep(now, *a, **k):
            stale, targets = orig(now, *a, **k)
            if pkg == JAX:
                sweeps.append((stale, targets))
                return stale, targets
            jax_stale, jax_targets = sweeps.pop(0)
            assert np.array_equal(stale, jax_stale)
            return jax_stale, jax_targets
        table.maintenance_sweep = sweep

    def key(self, raw: bytes):
        return self.M["InfoHash"](raw)

    def advance(self, to: float, step: float = 0.001) -> None:
        """Pump the node until virtual time ``to``."""
        while self.clock["t"] < to:
            self.clock["t"] = min(to, self.clock["t"] + step)
            self.dht.periodic(None, None)

    def feed(self, raw: bytes, host="10.0.0.5", port=4000) -> None:
        self.dht.periodic(raw, self.M["SockAddr"](host, port))


def client_requests(build) -> list:
    """Raw request datagrams made by a JAX client engine (a client: no
    node inserts the asker); ``build(ceng, peer, M)`` sends them."""
    M = mods(JAX)
    reqs = []
    ceng = M["NetworkEngine"](M["InfoHash"].get("twin-asker"), 0,
                              lambda d, a: reqs.append(bytes(d)) or 0,
                              M["Scheduler"](), M["EngineCallbacks"](),
                              is_client=True)
    seq = iter(range(500, 10_000))
    build(ceng, lambda node_id: _peer(ceng, M, node_id, seq), M)
    return reqs


def _peer(ceng, M, node_id, seq):
    peer = ceng.cache.get_node(M["InfoHash"](bytes(node_id)),
                               M["SockAddr"]("10.0.0.5", 4000), 0.0,
                               confirm=True)
    peer.get_new_tid = lambda: next(seq)
    return peer


def zipf_stream(seed: int, n_keys: int, n: int, s: float):
    rng = np.random.default_rng(seed)
    keys = [r.tobytes() for r in IK.ids_to_bytes(rng.integers(
        0, 2 ** 32, size=(n_keys, 5), dtype=np.uint32))]
    p = 1.0 / np.arange(1, n_keys + 1) ** s
    return keys, rng.choice(n_keys, size=n, p=p / p.sum())


def run_hot_scenario(node: TwinNode, keys, ranks) -> dict:
    """Values stored on 40 keys, a Zipf get stream (one get every 10
    virtual ms: each get rides a wave of its own) through three
    observatory ticks, a put on the hottest key (replica_k 16, the
    widened announce walk), a client's get_values on it, more gets."""
    dht, M = node.dht, node.M
    for i, k in enumerate(keys):
        dht.storage_store(node.key(k), M["Value"](b"val-%d" % i,
                                                  value_id=100 + i), 0.0)
    results = []

    def get(i, k):
        got, done = [], []
        dht.get(node.key(k), lambda vals: got.extend(vals) or True,
                lambda ok, ns: done.append((ok, node.clock["t"])))
        results.append((i, got, done))
    t = 0.0
    for i, r in enumerate(ranks):
        get(i, keys[r])
        t += 0.01
        node.advance(t)
    node.advance(t + 0.5)
    hot = keys[int(np.bincount(ranks).argmax())]
    out = {"replica_k_hot": dht._replica_k(node.key(hot)),
           "hot_keys": sorted(dht.keyspace.snapshot()["hot_keys"]),
           "cache_after_gets": _cache_view(dht.hotcache.snapshot())}
    put = {}
    dht.put(node.key(hot), M["Value"](b"fresh", value_id=999),
            lambda ok, ns: put.setdefault("ok", (ok, node.clock["t"])))
    node.advance(t + 1.0)
    out["cache_after_put"] = _cache_view(dht.hotcache.snapshot())
    for raw in client_requests(lambda ceng, peer, JM: ceng.send_get_values(
            peer(dht.myid), JM["InfoHash"](hot), JM["Query"](), want=1)):
        node.feed(raw)
    for i, r in enumerate(ranks[:60]):
        get(len(ranks) + i, keys[r])
        node.advance(t + 1.0 + 0.01 * (i + 1))
    node.advance(t + 10.0, step=0.01)
    out["gets"] = [(i, sorted((v.id, bytes(v.data)) for v in got), done)
                   for i, got, done in results]
    out["put"] = put
    out["cache_end"] = _cache_view(dht.hotcache.snapshot())
    out["sent"] = node.sent
    return out


def _cache_view(snap: dict) -> dict:
    return {k: snap[k] for k in ("occupancy", "hits", "misses",
                                 "admissions", "evictions", "invalidations",
                                 "hot_keys", "entries")}


def test_twin_nodes_at_the_defaults_serve_a_zipf_stream_alike(monkeypatch):
    keys, ranks = zipf_stream(21, 40, 600, 1.2)
    sweeps = []
    want = run_hot_scenario(TwinNode(JAX, monkeypatch, sweeps, "hc-twin"),
                            keys, ranks)
    got = run_hot_scenario(TwinNode(PORT, monkeypatch, sweeps, "hc-twin"),
                           keys, ranks)
    assert not sweeps
    assert want["hot_keys"], "the Zipf head turned hot"
    assert want["cache_after_gets"]["hits"] > 0
    assert want["replica_k_hot"] == 16
    for k in ("replica_k_hot", "hot_keys", "cache_after_gets",
              "cache_after_put", "put", "gets", "cache_end"):
        assert got[k] == want[k], k
    assert len(got["sent"]) == len(want["sent"])
    assert got["sent"] == want["sent"]


# ------------------------------------------------ carrying a JAX node
def test_dht_from_jax_carries_the_live_planes(monkeypatch):
    """A JAX node whose keys turned hot (sketch, candidates, hot set,
    cache entries) carried into a port node on the same clock: the
    carried planes equal the originals, and the next gets, a client's
    get_values and a put give the same results and datagrams."""
    keys, ranks = zipf_stream(22, 30, 400, 1.3)
    sweeps = []
    src = TwinNode(JAX, monkeypatch, sweeps, "hc-carry")
    t = 0.0
    for i, k in enumerate(keys):
        src.dht.storage_store(src.key(k), src.M["Value"](
            b"c-%d" % i, value_id=10 + i), 0.0)
    for r in ranks:
        src.dht.get(src.key(keys[r]), lambda vals: True)
        t += 0.01
        src.advance(t)
    src.advance(t + 0.5)
    assert src.dht.hotcache.snapshot()["occupancy"] > 0
    PM = mods(PORT)
    sent_port = []
    dst = convert.dht_from_jax(
        src.dht, lambda d, a: sent_port.append(
            (src.clock["t"], str(a), bytes(d))) and 0,
        PM["Scheduler"](clock=lambda: src.clock["t"]), device=CPU)
    ks, jks = dst.keyspace, src.dht.keyspace
    assert ks.snapshot() == jks.snapshot()
    assert np.array_equal(ks._sketch.numpy(), np.asarray(jks._sketch))
    assert dst.hotcache._slots == src.dht.hotcache._slots
    assert [(kb, _data(e.values)) for kb, e in
            dst.hotcache._entries.items()] == \
        [(kb, _data(e.values)) for kb, e in
         src.dht.hotcache._entries.items()]
    assert dst.listener_table.snapshot() == \
        src.dht.listener_table.snapshot()

    hot = sorted(src.dht.hotcache._entries)[0]
    reqs = client_requests(lambda ceng, peer, JM: [
        ceng.send_get_values(peer(src.dht.myid), JM["InfoHash"](hot),
                             JM["Query"](), want=1),
        ceng.send_find_node(peer(src.dht.myid), JM["InfoHash"](keys[5]),
                            want=1)])
    n0 = len(src.sent)
    outs = {}
    for name, dht, M, sent in ((JAX, src.dht, src.M, src.sent),
                               (PORT, dst, PM, sent_port)):
        start = len(sent)
        got = []
        for raw in reqs:
            dht.periodic(raw, M["SockAddr"]("10.0.0.5", 4000))
        dht.get(M["InfoHash"](hot), lambda vals: got.extend(vals) or True)
        outs[name] = (sorted((v.id, bytes(v.data)) for v in got),
                      dht._replica_k(M["InfoHash"](hot)),
                      [s[2] for s in sent[start:]])
    assert len(src.sent) > n0
    assert outs[PORT] == outs[JAX]
    assert outs[JAX][1] == 16
