"""The port's serving node (``opendht_tpu_torch.runtime.Dht``) against
the JAX package's ``Dht``.

- Twin clusters: the cases of tests/test_dht_core.py run once on JAX
  nodes and once on port nodes (``device="cpu"``), with the same node
  ids, the same seeded ``random`` and the same patched ``os.urandom``,
  each cluster on a virtual clock of its own.  The two clusters do not
  exchange the same bytes throughout (the routing tables' maintenance
  draws its refresh targets from jax.random in one and torch in the
  other), so the ops' results are compared: put/get/query outcomes,
  the values and fields found, listener deliveries and expiry pushes,
  who holds a value.  Both run at their defaults, every plane on, the
  resharder included.
- A mixed cluster of port and JAX nodes round-trips put → get and
  put → listen in both directions.
- ``ingest_pipeline_depth`` 1 ≡ 2 ≡ ``ingest_batching="off"`` on the
  port, as tests/test_wave_builder.py pins for the JAX builder.
- An 8,192-row port node serves a burst over localhost UDP through the
  churn view, and a batched resolve through the snapshot, with the
  lookups per route counted and every answer exact.
- The batched resolve, ``resolve_mesh_t``, the left-out ``Config``
  fields, ``warmup`` and carrying a JAX node's state across
  (``convert.dht_from_jax``).
"""

from __future__ import annotations

import heapq
import importlib
import itertools
import os
import random
import select
import socket
import threading
import time

import numpy as np
import pytest

import opendht_tpu_torch
from opendht_tpu_torch import convert
from opendht_tpu_torch.core import table as table_mod
from opendht_tpu_torch.core.value import Field, Query, Select, Value
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.net.engine import EngineCallbacks, NetworkEngine
from opendht_tpu_torch.ops import ids as IK
from opendht_tpu_torch.runtime import Config, Dht, NodeStatus
from opendht_tpu_torch.runtime.live_search import SEARCH_NODES
from opendht_tpu_torch.scheduler import Scheduler
from opendht_tpu_torch.sockaddr import SockAddr

PORT, JAX = "opendht_tpu_torch", "opendht_tpu"
AF = socket.AF_INET


def _mods(pkg: str) -> dict:
    m = {k: importlib.import_module(f"{pkg}.{k}")
         for k in ("infohash", "sockaddr", "scheduler", "runtime",
                   "core.value")}
    return {"InfoHash": m["infohash"].InfoHash,
            "SockAddr": m["sockaddr"].SockAddr,
            "Scheduler": m["scheduler"].Scheduler,
            "Config": m["runtime"].Config, "Dht": m["runtime"].Dht,
            "NodeStatus": m["runtime"].NodeStatus,
            "Value": m["core.value"].Value, "Query": m["core.value"].Query,
            "Select": m["core.value"].Select,
            "Field": m["core.value"].Field}


class Net:
    """An in-process virtual network of Dht nodes of either package (the
    shape of opendht_tpu.testing.VirtualNet): datagrams queue on one
    event heap, a virtual clock jumps to the next arrival or job, and a
    delivery hands each node a source address of its own package."""

    def __init__(self, delay: float = 0.01):
        self.clock = 0.0
        self.delay = delay
        self.nodes: dict = {}
        self._q: list = []
        self._seq = itertools.count()

    def add(self, pkg: str, name: str, **cfg) -> object:
        M = _mods(pkg)
        key = ("127.0.0.1", 20000 + len(self.nodes))

        def send(data, dest, _src=key):
            heapq.heappush(self._q, (self.clock + self.delay,
                                     next(self._seq), bytes(data), _src,
                                     (dest.host, dest.port)))
            return 0

        kw = {"device": "cpu"} if pkg == PORT else {}
        d = M["Dht"](send, M["Config"](node_id=M["InfoHash"].get(name),
                                       **cfg),
                     M["Scheduler"](clock=lambda: self.clock),
                     has_v6=False, **kw)
        d.bound_addr = M["SockAddr"](*key)
        d.M = M
        d.name = name
        self.nodes[key] = d
        return d

    def bootstrap(self, seed) -> None:
        for d in self.nodes.values():
            if d is not seed:
                d.insert_node(d.M["InfoHash"](bytes(seed.myid)),
                              d.M["SockAddr"](*_key(seed)))
                d.ping_node(d.M["SockAddr"](*_key(seed)))

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
                    d.periodic(data, d.M["SockAddr"](*src))
            for d in self.nodes.values():
                if d.scheduler.next_job_time() <= self.clock:
                    d.periodic(None, None)

    def all_connected(self) -> bool:
        return all(d.get_status().name == "CONNECTED"
                   for d in self.nodes.values())


def _key(d) -> tuple:
    return (d.bound_addr.host, d.bound_addr.port)


def _seeded(monkeypatch, seed: int) -> None:
    """The same ``random`` state and ``os.urandom`` stream before each
    cluster of a twin pair."""
    random.seed(seed)
    rng = random.Random(seed ^ 0x5EED)
    monkeypatch.setattr(os, "urandom",
                        lambda n: bytes(rng.getrandbits(8) for _ in range(n)))


def make_cluster(pkg: str, n: int, tag: str, monkeypatch, seed: int = 7):
    _seeded(monkeypatch, seed)
    net = Net()
    nodes = [net.add(pkg, f"{tag}-node-{i}") for i in range(n)]
    net.bootstrap(nodes[0])
    return net, nodes


# ----------------------------------------------------- twin-cluster cases
def case_connect(pkg, mp):
    net, _ = make_cluster(pkg, 2, "connect", mp)
    return {"connected": net.run(30, net.all_connected)}


def case_put_get(pkg, mp):
    net, nodes = make_cluster(pkg, 5, "putget", mp)
    assert net.run(60, net.all_connected)
    M = nodes[0].M
    key = M["InfoHash"].get("hello")
    put, done, got = {}, {}, []
    nodes[1].put(key, M["Value"](b"some data payload"),
                 lambda ok, ns: put.update(ok=ok))
    assert net.run(60, lambda: "ok" in put)
    nodes[3].get(key, lambda vals: got.extend(vals) or True,
                 lambda ok, ns: done.update(ok=ok))
    assert net.run(60, lambda: "ok" in done)
    return {"put": put["ok"], "get": done["ok"],
            "values": sorted(v.data for v in got)}


def case_get_missing(pkg, mp):
    net, nodes = make_cluster(pkg, 3, "missing", mp)
    assert net.run(60, net.all_connected)
    got, done = [], {}
    nodes[2].get(nodes[0].M["InfoHash"].get("nothing here"),
                 lambda vals: got.extend(vals) or True,
                 lambda ok, ns: done.update(ok=ok))
    assert net.run(60, lambda: "ok" in done)
    return {"get": done["ok"], "values": got}


def case_listen_put_cancel(pkg, mp):
    net, nodes = make_cluster(pkg, 5, "listen", mp)
    assert net.run(60, net.all_connected)
    M = nodes[0].M
    key = M["InfoHash"].get("chatroom")
    heard = []
    token = nodes[2].listen(key, lambda vals, exp: heard.extend(
        (v.data, exp) for v in vals) or True)
    net.run(5)
    nodes[4].put(key, M["Value"](b"first message"))
    assert net.run(60, lambda: (b"first message", False) in heard)
    return {"token": bool(token), "heard": heard,
            "cancelled": nodes[2].cancel_listen(key, token)}


def case_listen_expiry(pkg, mp):
    net, nodes = make_cluster(pkg, 4, "expiry", mp)
    assert net.run(60, net.all_connected)
    M = nodes[0].M
    key = M["InfoHash"].get("ephemeral")
    heard = []
    nodes[1].listen(key, lambda vals, exp: heard.extend(
        (v.data, exp) for v in vals) or True)
    net.run(5)
    nodes[3].put(key, M["Value"](b"gone soon"))
    assert net.run(60, lambda: (b"gone soon", False) in heard)
    expired = net.run(15 * 60, lambda: (b"gone soon", True) in heard)
    return {"expired_pushed": expired, "heard": sorted(set(heard))}


def case_query(pkg, mp):
    net, nodes = make_cluster(pkg, 4, "query", mp)
    assert net.run(60, net.all_connected)
    M = nodes[0].M
    key = M["InfoHash"].get("queried")
    val = M["Value"](b"queried payload", user_type="test/1")
    val.seq = 3
    done, qdone, fields = {}, {}, []
    nodes[1].put(key, val, lambda ok, ns: done.update(ok=ok))
    assert net.run(60, lambda: "ok" in done)
    F = M["Field"]
    nodes[2].query(key, lambda fs: fields.extend(fs) or True,
                   lambda ok, ns: qdone.update(ok=ok),
                   M["Query"](M["Select"]().field(F.ID).field(F.SEQ_NUM)))
    assert net.run(60, lambda: "ok" in qdone)
    return {"put": done["ok"], "query": qdone["ok"],
            "seqs": sorted({fv.index[F.SEQ_NUM].value for fv in fields
                            if fv.index.get(F.SEQ_NUM) is not None})}


def case_replicas(pkg, mp):
    net, nodes = make_cluster(pkg, 8, "replica", mp)
    assert net.run(120, net.all_connected)
    M = nodes[0].M
    key = M["InfoHash"].get("replicated")
    done = {}
    nodes[0].put(key, M["Value"](b"replica"),
                 lambda ok, ns: done.update(ok=ok))
    assert net.run(60, lambda: "ok" in done)
    return {"put": done["ok"],
            "holders": sorted(d.name for d in nodes if d.get_local(key))}


def case_wrong_token(pkg, mp):
    net, (a, b) = make_cluster(pkg, 2, "token", mp)
    assert net.run(30, net.all_connected)
    M = a.M
    key = M["InfoHash"].get("locked")
    node_b = a.engine.cache.get_node(b.myid, b.bound_addr,
                                     a.scheduler.time(), confirm=False)
    a.engine.send_announce_value(node_b, key, M["Value"](b"x", value_id=7),
                                 None, b"\0" * 32)
    net.run(5)
    return {"stored": bool(b.get_local(key))}


def case_local_replay_and_export(pkg, mp):
    net, (a, b) = make_cluster(pkg, 2, "local", mp)
    assert net.run(30, net.all_connected)
    M = a.M
    key = M["InfoHash"].get("local")
    a.storage_store(key, M["Value"](b"preexisting", value_id=1),
                    a.scheduler.time())
    heard = []
    a.listen(key, lambda vals, exp: heard.extend(v.data for v in vals)
             or True)
    b.import_values(a.export_values())
    return {"heard": heard, "imported": [v.data for v in b.get_local(key)]}


def case_repeated_put(pkg, mp):
    net, nodes = make_cluster(pkg, 5, "again", mp)
    assert net.run(60, net.all_connected)
    M = nodes[0].M
    key = M["InfoHash"].get("again")
    val = M["Value"](b"same value twice")
    val.id = 42
    first, second = {}, {}
    nodes[2].put(key, val, lambda ok, ns: first.update(ok=ok))
    assert net.run(60, lambda: "ok" in first)
    nodes[2].put(key, val, lambda ok, ns: second.update(ok=ok))
    assert net.run(60, lambda: "ok" in second)
    return {"first": first["ok"], "second": second["ok"]}


def case_status_and_size(pkg, mp):
    _seeded(mp, 3)
    net = Net()
    solo = net.add(pkg, "status-solo")
    before = solo.get_status().name
    other = net.add(pkg, "status-other")
    other.insert_node(solo.myid, solo.bound_addr)
    mid = other.get_status().name
    connected = net.run(400, net.all_connected)
    return {"before": before, "after_insert": mid, "connected": connected,
            "estimate_ge_8": all(d.network_size_estimate() >= 8
                                 for d in net.nodes.values())}


TWIN_CASES = [case_connect, case_put_get, case_get_missing,
              case_listen_put_cancel, case_listen_expiry, case_query,
              case_replicas, case_wrong_token, case_local_replay_and_export,
              case_repeated_put, case_status_and_size]


@pytest.mark.parametrize("case", TWIN_CASES, ids=lambda c: c.__name__[5:])
def test_twin_clusters_give_the_same_results(case, monkeypatch):
    want = case(JAX, monkeypatch)
    got = case(PORT, monkeypatch)
    assert got == want


# ------------------------------------------------------- mixed cluster
@pytest.mark.parametrize("writer,reader", [(PORT, JAX), (JAX, PORT)])
def test_mixed_cluster_put_get_and_listen(writer, reader, monkeypatch):
    _seeded(monkeypatch, 11)
    net = Net()
    pkgs = [PORT, JAX] * 3
    nodes = [net.add(p, f"mixed-{i}") for i, p in enumerate(pkgs)]
    net.bootstrap(nodes[0])
    assert net.run(60, net.all_connected)
    w = next(d for d in nodes[1:] if d.M["Dht"].__module__.startswith(
        writer + "."))
    r = next(d for d in nodes[1:] if d is not w
             and d.M["Dht"].__module__.startswith(reader + "."))
    key_w, key_r = w.M["InfoHash"].get("mixed"), r.M["InfoHash"].get("mixed")
    heard = []
    r.listen(key_r, lambda vals, exp: heard.extend(
        v.data for v in vals if not exp) or True)
    net.run(5)
    put, done, got = {}, {}, []
    w.put(key_w, w.M["Value"](b"across packages", value_id=9),
          lambda ok, ns: put.update(ok=ok))
    assert net.run(60, lambda: "ok" in put) and put["ok"]
    assert net.run(60, lambda: b"across packages" in heard)
    r.get(key_r, lambda vals: got.extend(vals) or True,
          lambda ok, ns: done.update(ok=ok))
    assert net.run(60, lambda: "ok" in done) and done["ok"]
    assert [v.data for v in got] == [b"across packages"]
    assert [v.id for v in got] == [9]


# ------------------------------------------------------- the wave builder
def make_port_dht(clock, n_nodes=12, **cfg_kw):
    """A v4-only port Dht on a virtual clock with a populated table and
    a swallow-everything transport (tests/test_wave_builder.py's)."""
    dht = Dht(lambda data, addr: 0, config=Config(**cfg_kw),
              scheduler=Scheduler(clock=lambda: clock["t"]), has_v6=False,
              device="cpu")
    rng = np.random.default_rng(1234)
    table = dht.tables[AF]
    if n_nodes > 64:        # past what k-bucket admission keeps
        table.bulk_load(rng.integers(0, 2 ** 32, size=(n_nodes, 5),
                                     dtype=np.uint32), clock["t"],
                        addrs=SockAddr("10.9.0.1", 4500))
        return dht
    added = 0
    while added < n_nodes:
        h = InfoHash(bytes(rng.integers(0, 256, 20, dtype=np.uint8)))
        if table.insert(h, SockAddr("10.9.0.%d" % (added + 1), 4500),
                        now=clock["t"], confirm=2) is not None:
            added += 1
    return dht


@pytest.mark.parametrize("n_nodes", [12, 5000])
def test_pipeline_depths_and_off_resolve_identically(n_nodes):
    """Depth 2, depth 1 and batching off return the same node rows in
    the same order — at 12 rows (host scan) and 5,000 rows (the device
    snapshot route, here its plain version)."""
    clock = {"t": 22_000.0}
    targets = [InfoHash.get(f"d-eq-{i}") for i in range(70)]

    def resolve(**cfg_kw):
        dht = make_port_dht(clock, n_nodes, ingest_fill_target=64,
                            ingest_deadline=5.0, **cfg_kw)
        got = []
        for t in targets:
            dht.wave_builder.submit(t, AF, SEARCH_NODES,
                                    lambda nodes: got.append(nodes))
        dht.scheduler.run()
        clock["t"] += 6.0
        dht.scheduler.run()
        assert len(got) == len(targets)
        return [[n.id for n in row] for row in got]

    r2 = resolve(ingest_pipeline_depth=2)
    r1 = resolve(ingest_pipeline_depth=1)
    roff = resolve(ingest_batching="off")
    assert r2 == r1 == roff
    assert all(len(r) == min(n_nodes, SEARCH_NODES) for r in r2)


def test_pipeline_depths_and_off_give_the_same_cluster_results(monkeypatch):
    def run(**cfg):
        _seeded(monkeypatch, 99)
        net = Net()
        nodes = [net.add(PORT, f"wb-pd-node-{i}", **cfg) for i in range(6)]
        net.bootstrap(nodes[0])
        net.run(30)
        key = InfoHash.get("wb-pd-key")
        done, heard, got = {}, [], []
        nodes[3].listen(key, lambda vals, exp: heard.extend(
            v.data for v in vals if not exp) or True)
        net.run(30)
        nodes[1].put(key, Value(b"wb-pipeline", value_id=7),
                     lambda ok, ns: done.setdefault("put", ok))
        net.run(30)
        nodes[2].get(key, get_cb=lambda vals: got.extend(vals) or True,
                     done_cb=lambda ok, ns: done.setdefault("get", ok))
        net.run(30)
        return (done, sorted(v.data for v in got), sorted(heard),
                sorted(d.name for d in nodes if d.get_local(key)))

    d2 = run(ingest_pipeline_depth=2)
    assert d2[0].get("put") and d2[1] == [b"wb-pipeline"]
    assert run(ingest_pipeline_depth=1) == d2
    assert run(ingest_batching="off") == d2


def test_config1_gets_end_by_expiry_as_on_the_jax_node(monkeypatch):
    """BASELINE config 1 (10,000 rows, node id and 1,000 keys from
    default_rng(1), a transport that swallows every datagram, the
    scheduler pumped after each get) at ingest pipeline depth 1, as
    chip_smoke.py's serve phase runs it: with the virtual clock advanced
    6 s, the same gets have ended by search expiry on the port's node as
    on the JAX node, after the same datagrams at the same virtual times;
    shutdown() then ends every other get, each done_cb once.

    Depth 1 scatters a wave inside the job that launched it.  At depth 2
    a wave scatters when the device's handle is ready in real time, so
    on a virtual clock which searches expire would follow the host's
    speed.  The bucket maintenance's refresh targets are random draws
    (jax.random in one table, torch in the other): the port's node is
    handed the JAX node's draws, its own stale buckets held equal."""
    n_gets = 1000
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 2 ** 32, size=(10_000, 5), dtype=np.uint32)
    keys = [bytes(r) for r in IK.ids_to_bytes(
        rng.integers(0, 2 ** 32, size=(n_gets, 5), dtype=np.uint32))]
    me = rng.integers(0, 256, size=20, dtype=np.uint8).tobytes()
    sweeps = []                 # the JAX node's (stale, refresh targets)

    def run(pkg):
        M = _mods(pkg)
        _seeded(monkeypatch, 1)
        clock = {"t": 0.0}
        sent = []
        kw = {"device": "cpu"} if pkg == PORT else {}
        dht = M["Dht"](lambda d, a: sent.append((clock["t"], str(a),
                                                 bytes(d))) and 0,
                       M["Config"](node_id=M["InfoHash"](me),
                                   ingest_pipeline_depth=1),
                       M["Scheduler"](clock=lambda: clock["t"]),
                       has_v6=False, **kw)
        table = dht.tables[AF]
        table.bulk_load(ids, 0.0, addrs=M["SockAddr"]("127.0.0.2", 4567))
        dht.warmup()
        orig_sweep = table.maintenance_sweep

        def sweep(now, *a, **kw):
            stale, targets = orig_sweep(now, *a, **kw)
            if pkg == JAX:
                sweeps.append((stale, targets))
                return stale, targets
            jax_stale, jax_targets = sweeps.pop(0)
            assert np.array_equal(stale, jax_stale)
            return jax_stale, jax_targets
        table.maintenance_sweep = sweep
        first, done = {}, [0] * n_gets
        orig_insert = dht._refill_insert

        def refill_insert(sr, nodes):
            first.setdefault(bytes(sr.id), [bytes(n.id) for n in nodes])
            return orig_insert(sr, nodes)
        dht._refill_insert = refill_insert
        for i, key in enumerate(keys):
            dht.get(M["InfoHash"](key), done_cb=lambda ok, ns, _i=i:
                    done.__setitem__(_i, done[_i] + 1))
            dht.periodic(None, None)
        while len(first) < n_gets:       # the last partial wave's deadline
            clock["t"] += 0.0005
            dht.periodic(None, None)
        while clock["t"] < 6.0:
            clock["t"] += 0.25
            dht.periodic(None, None)
        by_expiry = [i for i, n in enumerate(done) if n]
        dht.shutdown()
        return by_expiry, done, [first[k] for k in keys], sent

    jax_expired, jax_done, jax_first, jax_sent = run(JAX)
    port_expired, port_done, port_first, port_sent = run(PORT)
    assert not sweeps
    assert port_first == jax_first
    assert port_sent == jax_sent
    assert port_expired == jax_expired and len(port_expired) >= 1
    assert port_done == jax_done == [1] * n_gets


# ------------------------------------------- a live node past host scan
def _exact_top_ids(ids: np.ndarray, target: InfoHash, k: int) -> list:
    d = ids ^ IK.ids_from_hashes([target])[0]
    order = np.lexsort((d[:, 4], d[:, 3], d[:, 2], d[:, 1], d[:, 0]))[:k]
    return [bytes(b) for b in IK.ids_to_bytes(ids[order])]


def _near(me: InfoHash, bits: int, salt: int) -> InfoHash:
    """An id sharing ``bits`` leading bits with ``me`` (a bucket that a
    random table leaves nearly empty)."""
    raw = bytearray(bytes(InfoHash.get(b"near-%d" % salt)))
    mine = bytes(me)
    for i in range(bits):
        byte, bit = divmod(i, 8)
        m = 0x80 >> bit
        raw[byte] = (raw[byte] & ~m) | (mine[byte] & m)
    byte, bit = divmod(bits, 8)
    raw[byte] ^= (0x80 >> bit) & ~(raw[byte] ^ mine[byte])
    return InfoHash(bytes(raw))


def test_live_node_serves_a_burst_through_both_routes(monkeypatch):
    """tests/test_live_node_scale.py's shape on the port: 8,192 rows
    (past HOST_SCAN_MAX_ROWS), bursts over localhost UDP from a client
    engine, which the node does not insert, so the first burst runs
    through the snapshot; a peer joining a near-empty bucket then leaves
    churn pending, and the second burst runs through the churn view; a
    forced snapshot() serves a batched resolve through the snapshot
    again.  Every answer equals an exact top-8 over the reachable rows.
    The loaded peers' datagrams never leave the process."""
    n_rows, n_burst = 8192, 6
    assert n_rows > table_mod.HOST_SCAN_MAX_ROWS
    ssock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    ssock.bind(("127.0.0.1", 0))
    sport = ssock.getsockname()[1]
    ssock.setblocking(False)
    csock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    csock.bind(("127.0.0.1", 0))
    csock.setblocking(False)
    client = csock.getsockname()

    def server_send(data, dst):
        if (str(dst.ip), dst.port) == client:       # only to the client
            ssock.sendto(data, client)
        return 0

    dht = Dht(server_send, Config(max_req_per_sec=1_000_000), has_v6=False,
              device="cpu")
    table = dht.tables[AF]
    ids = np.random.default_rng(3).integers(0, 2 ** 32, size=(n_rows, 5),
                                            dtype=np.uint32)
    table.bulk_load(ids, dht.scheduler.time(),
                    addrs=SockAddr("127.0.0.2", 4567))
    dht.warmup()
    assert table._snap is not None and table.churn_pending == 0

    routes = {"snapshot": 0, "churn": 0}
    for cls, name in ((table_mod.Snapshot, "snapshot"),
                      (table_mod.ChurnView, "churn")):
        def counted(self, queries, *, _orig=cls.lookup_launch, _n=name,
                    **kw):
            routes[_n] += 1
            return _orig(self, queries, **kw)
        monkeypatch.setattr(cls, "lookup_launch", counted)

    stop = threading.Event()

    def serve():
        while not stop.is_set():
            r, _, _ = select.select([ssock], [], [], 0.02)
            if r:
                data, addr = ssock.recvfrom(64 * 1024)
                dht.periodic(data, SockAddr(addr[0], addr[1]))

    # a client engine: a non-client requester may be queried by the
    # node's own searches and, answering without a token, blacklisted
    ceng = NetworkEngine(InfoHash.get("client"), 0,
                         lambda data, dst: csock.sendto(
                             data, (str(dst.ip), dst.port)) and 0,
                         Scheduler(), EngineCallbacks(), is_client=True)
    node = ceng.cache.get_node(dht.myid, SockAddr("127.0.0.1", sport),
                               time.monotonic(), confirm=True)

    def burst(tag: bytes) -> None:
        """Send find/get requests alternately; every answer is exact
        over the rows reachable now."""
        targets = [InfoHash.get(tag + b"-%d" % i) for i in range(n_burst)]
        answers = {}
        for i, tgt in enumerate(targets):
            cb = (lambda r, a, _i=i: answers.__setitem__(_i, a))
            if i % 2:
                ceng.send_find_node(node, tgt, want=1, on_done=cb)
            else:
                ceng.send_get_values(node, tgt, Query(), want=1, on_done=cb)
        deadline = time.monotonic() + 90
        while len(answers) < n_burst and time.monotonic() < deadline:
            ceng.scheduler.run()
            r, _, _ = select.select([csock], [], [], 0.02)
            if r:
                data, addr = csock.recvfrom(64 * 1024)
                ceng.process_message(data, SockAddr(addr[0], addr[1]))
        assert len(answers) == n_burst
        live = table._ids[table.reachable_mask(0.0)]
        for i, tgt in enumerate(targets):
            assert [bytes(n.id) for n in answers[i].nodes4] == \
                _exact_top_ids(live, tgt, 8)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    try:
        burst(b"first")
        assert routes == {"snapshot": n_burst, "churn": 0}
        assert len(table) == n_rows            # a client is not inserted
        # a peer joins a near-empty bucket (the serving thread is idle
        # between bursts): one delta row of pending churn
        dht.insert_node(_near(dht.myid, 30, 1), SockAddr("127.0.0.3", 1))
        assert table.churn_pending == 1
        burst(b"second")
        assert routes == {"snapshot": n_burst, "churn": n_burst}
    finally:
        stop.set()
        th.join()
        ssock.close()
        csock.close()

    table.snapshot()
    assert table.churn_pending == 0
    live = table._ids[table.reachable_mask(0.0)]
    assert len(live) == n_rows + 1
    wave = [InfoHash.get(b"wave-%d" % i) for i in range(100)]
    res = dht.find_closest_nodes_batched(wave, AF)
    assert routes["snapshot"] == n_burst + 1
    for tgt, nodes in zip(wave, res):
        assert [bytes(n.id) for n in nodes] == _exact_top_ids(live, tgt, 8)


def test_batched_resolve_matches_the_jax_table():
    from opendht_tpu.runtime import Config as JConfig, Dht as JDht
    from opendht_tpu.infohash import InfoHash as JHash
    from opendht_tpu.sockaddr import SockAddr as JAddr
    ids = np.random.default_rng(5).integers(0, 2 ** 32, size=(6000, 5),
                                            dtype=np.uint32)
    me = bytes(range(20))
    port = Dht(lambda d, a: 0, Config(node_id=InfoHash(me)), has_v6=False,
               device="cpu")
    jax_ = JDht(lambda d, a: 0, JConfig(node_id=JHash(me)), has_v6=False)
    port.tables[AF].bulk_load(ids, 0.0, addrs=SockAddr("10.0.0.1", 1))
    jax_.tables[AF].bulk_load(ids, 0.0, addrs=JAddr("10.0.0.1", 1))
    names = [b"t-%d" % i for i in range(80)]
    for k in (8, SEARCH_NODES):
        got = port.find_closest_nodes_batched([InfoHash.get(n)
                                               for n in names], AF, k)
        want = jax_.find_closest_nodes_batched([JHash.get(n)
                                                for n in names], AF, k)
        assert [[bytes(n.id) for n in r] for r in got] == \
            [[bytes(n.id) for n in r] for r in want]


# ----------------------------------------------------------- the surface
def test_resolve_mesh_t_2_raises(caplog):
    """``resolve_mesh_t=2`` no longer raises: a node on the CPU builds a
    (q=1, t=2) mesh of virtual shards; more shards than the CPU's
    virtual devices log a warning and serve unsharded, as the JAX node
    does with too few devices; 1 is unsharded."""
    dht = Dht(lambda d, a: 0, Config(resolve_mesh_t=2), device="cpu")
    m = dht.resolve_mesh()
    assert m.shape == {"q": 1, "t": 2} and dht.resolve_mesh_t() == 2
    assert {d.type for d in m.devices.reshape(-1)} == {"cpu"}
    with caplog.at_level("WARNING", logger="opendht_tpu_torch.dht"):
        big = Dht(lambda d, a: 0, Config(resolve_mesh_t=512), device="cpu")
        assert big.resolve_mesh() is None and big.resolve_mesh_t() == 1
    assert "serving the unsharded resolve path" in caplog.text
    dht = Dht(lambda d, a: 0, Config(resolve_mesh_t=1), device="cpu")
    assert dht.resolve_mesh() is None and dht.resolve_mesh_t() == 1
    assert dht.last_resolve_shard_t == 1


@pytest.mark.parametrize("field", ["reshard"])
def test_left_out_config_fields_raise(field):
    """The one field the port once left out is back, at the JAX
    default (the resharder on)."""
    import dataclasses
    from opendht_tpu.runtime import Config as JConfig
    assert field in JConfig.__dataclass_fields__
    assert dataclasses.asdict(getattr(Config(), field)) == \
        dataclasses.asdict(getattr(JConfig(), field))
    assert Config().reshard.enabled is True


@pytest.mark.parametrize("field", ["keyspace", "cache", "listeners",
                                   "listen_batching", "chaos_enabled"])
def test_plane_config_fields_take_the_jax_defaults(field):
    """The planes' fields are back, at the JAX defaults (all on but
    chaos)."""
    import dataclasses
    from opendht_tpu.runtime import Config as JConfig
    port, jax_ = getattr(Config(), field), getattr(JConfig(), field)
    if dataclasses.is_dataclass(port):
        port, jax_ = dataclasses.asdict(port), dataclasses.asdict(jax_)
    assert port == jax_


@pytest.mark.parametrize("field", ["health", "history"])
def test_runner_config_fields_take_the_jax_defaults(field):
    """``health`` and ``history`` came back with the runner layer, at
    the JAX defaults."""
    import dataclasses
    from opendht_tpu.runtime import Config as JConfig
    assert dataclasses.asdict(getattr(Config(), field)) == \
        dataclasses.asdict(getattr(JConfig(), field))


def test_dht_defaults_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opendht_tpu_torch.Dht(lambda d, a: 0)


def test_warmup_builds_the_snapshot_and_raises_on_failure(monkeypatch):
    dht = Dht(lambda d, a: 0, has_v6=False, device="cpu")
    ids = np.random.default_rng(9).integers(0, 2 ** 32, size=(5000, 5),
                                            dtype=np.uint32)
    dht.tables[AF].bulk_load(ids, 0.0, addrs=SockAddr("10.0.0.1", 1))
    dht.warmup()

    def broken(*a, **kw):
        raise RuntimeError("select_kernels: CUDA error 700 at launch")

    monkeypatch.setattr(table_mod.NodeTable, "find_closest", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        dht.warmup()


def test_warm_device_runs_each_program_at_the_node_shapes(monkeypatch):
    """``warm_device`` (run on the card by ``Dht.warmup`` and, before the
    node's scheduler starts, by ``DhtRunner.run``) calls the sketch's
    update, query and decay, both probes and the maintenance sweep once,
    at the shapes the node's config gives its planes, and leaves a
    node's planes and table as they were: no device state made, nothing
    observed, the table's maintenance generator not drawn."""
    from opendht_tpu_torch.ops import cache_probe as cp
    from opendht_tpu_torch.ops import listener_match as lm
    from opendht_tpu_torch.ops import radix
    from opendht_tpu_torch.ops import sketch as sk
    from opendht_tpu_torch.runtime.dht import warm_device
    cfg = Config()
    cfg.keyspace.width, cfg.cache.capacity, cfg.listeners.capacity = \
        1024, 32, 256
    dht = Dht(lambda d, a: 0, cfg, has_v6=False, device="cpu")
    calls = []

    def spy(mod, name):
        real = getattr(mod, name)

        def call(*a, **kw):
            calls.append((name, tuple(a[0].shape)))
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, call)
    for mod, name in ((sk, "sketch_update"), (sk, "sketch_query"),
                      (sk, "sketch_decay"), (cp, "cache_probe"),
                      (lm, "listener_match"), (radix, "maintenance_sweep")):
        spy(mod, name)
    before = (dht.keyspace.snapshot(), dht.hotcache.snapshot())
    warm_device(cfg, "cpu")
    assert calls == [("sketch_update", (4, 1024)),
                     ("sketch_query", (4, 1024)),
                     ("sketch_decay", (4, 1024)),
                     ("cache_probe", (32, 5)),
                     ("listener_match", (256, 5)),
                     ("maintenance_sweep", (5,))]
    assert (dht.keyspace.snapshot(), dht.hotcache.snapshot()) == before
    assert dht.keyspace._device_ok is dht.hotcache._device_ok \
        is dht.listener_table._device_ok is None
    assert dht.tables[AF]._maint_gen is None
    # a node without the observatory skips the sketch
    calls.clear()
    cfg.keyspace.enabled = False
    warm_device(cfg, "cpu")
    assert [c[0] for c in calls] == ["cache_probe", "listener_match",
                                     "maintenance_sweep"]


def test_ingest_failures_counter_lives_on_the_port_registry():
    from opendht_tpu import telemetry as jtel
    from opendht_tpu_torch import telemetry as ptel
    assert ptel.get_registry() is not jtel.get_registry()
    clock = {"t": 0.0}
    dht = make_port_dht(clock)
    before = ptel.get_registry().counter(
        "dht_ingest_wave_failures_total").value

    def boom(*a, **kw):
        raise RuntimeError("launch failed")

    dht.find_closest_nodes_launch = boom
    got = []
    dht.wave_builder.submit(InfoHash.get("x"), AF, 8, got.append)
    for _ in range(4):
        clock["t"] += 0.01
        dht.scheduler.run()
    assert got == [[]]
    assert ptel.get_registry().counter(
        "dht_ingest_wave_failures_total").value == before + 3


# -------------------------------------------------- carrying a JAX node
def test_dht_from_jax_answers_the_same_bytes():
    """A JAX node's tables and value store carried into a port node: a
    find and a get sent to each return the same reply bytes."""
    from opendht_tpu.core.value import Query as JQuery, Value as JValue
    from opendht_tpu.infohash import InfoHash as JHash
    from opendht_tpu.net.engine import (EngineCallbacks as JCbs,
                                        NetworkEngine as JEngine)
    from opendht_tpu.runtime import Config as JConfig, Dht as JDht
    from opendht_tpu.scheduler import Scheduler as JSched
    from opendht_tpu.sockaddr import SockAddr as JAddr

    me = bytes(range(20))
    out = {"jax": [], "port": []}
    random.seed(1)
    src = JDht(lambda d, a: out["jax"].append(bytes(d)) or 0,
               JConfig(node_id=JHash(me)), has_v6=False)
    ids = np.random.default_rng(2).integers(0, 2 ** 32, size=(300, 5),
                                            dtype=np.uint32)
    src.tables[AF].bulk_load(ids, src.scheduler.time(),
                             addrs=JAddr("10.0.0.7", 4222))
    key = JHash.get("carried")
    for i in range(3):
        src.storage_store(key, JValue(b"v%d" % i, value_id=10 + i,
                                      user_type="t"), src.scheduler.time())
    dst = convert.dht_from_jax(
        src, lambda d, a: out["port"].append(bytes(d)) or 0, device="cpu")
    assert [v.data for v in dst.get_local(InfoHash.get("carried"))] == \
        [b"v0", b"v1", b"v2"]
    assert len(dst.tables[AF]) == len(src.tables[AF]) == 300

    # one client's requests (a client: neither node inserts the asker)
    reqs = []
    ceng = JEngine(JHash.get("asker"), 0,
                   lambda d, a: reqs.append(bytes(d)) or 0, JSched(),
                   JCbs(), is_client=True)
    peer = ceng.cache.get_node(JHash(me), JAddr("10.0.0.5", 4000), 0.0,
                               confirm=True)
    seq = [101, 102]
    peer.get_new_tid = lambda: seq.pop(0)
    ceng.send_find_node(peer, JHash.get("somewhere"), want=1)
    ceng.send_get_values(peer, key, JQuery(), want=1)
    for raw in reqs:
        src.periodic(raw, JAddr("10.0.0.5", 4000))
        dst.periodic(raw, SockAddr("10.0.0.5", 4000))
    assert len(out["jax"]) == 2
    assert out["port"] == out["jax"]
