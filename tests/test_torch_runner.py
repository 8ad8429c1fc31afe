"""The port's runner layer (``opendht_tpu_torch.runtime.runner``) over
real localhost UDP, against the JAX package's.

- The cases of tests/test_runner.py on the port's ``DhtRunner`` with
  ``device="cpu"``: bootstrap, put/get, listen, a five-node cluster,
  dual-stack v6 (native and Python sockets), a signed put between two
  identities, idempotent join, and the op queues' fairness and gating.
- A mixed cluster: a JAX ``DhtRunner`` and a port ``DhtRunner``
  bootstrapped to each other, with put/get, listen and a signed put in
  both directions.
- A node carried by ``convert.secure_dht_from_jax`` answers a client's
  find and get with the same bytes as the original.
- The proxy backend: ``RunnerConfig(proxy_server=)`` starts a runner
  proxied and ``enable_proxy`` swaps it to UDP and back, against a port
  ``DhtProxyServer`` (tests/test_torch_proxy.py holds the rest).  A
  runner without ``device=`` needs the card.  Every plane's accessor
  (the resharder's included) reports with the JAX runner's keys.

Every real-UDP test binds port 0, waits on predicates with budgets of
at least 20 s and joins its runners in ``finally``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import random
import socket
import time

import numpy as np
import pytest

from opendht_tpu_torch import convert
from opendht_tpu_torch.core.value import Value
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.runtime.config import Config, NodeStatus
from opendht_tpu_torch.runtime.runner import DhtRunner, RunnerConfig
from opendht_tpu_torch.sockaddr import SockAddr

CPU = {"device": "cpu"}


def wait_for(pred, timeout=20.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def connected(*runners) -> bool:
    return all(r.get_status().name == "CONNECTED" for r in runners)


@pytest.fixture
def two_nodes():
    a, b = DhtRunner(), DhtRunner()
    try:
        a.run(0, **CPU)
        b.run(0, **CPU)
        b.bootstrap("127.0.0.1", a.get_bound_port())
        yield a, b
    finally:
        a.join()
        b.join()


# ------------------------------------------- tests/test_runner.py's cases
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_ipv6_dual_stack_put_get(native):
    """Dual-stack runners bootstrap over ::1 and serve values on the v6
    family, through the native engine's v6 socket or the Python
    fallback's."""
    a, b = DhtRunner(), DhtRunner()
    try:
        a.run(0, RunnerConfig(native_engine=native), ipv6=True, **CPU)
        b.run(0, RunnerConfig(native_engine=native), ipv6=True, **CPU)
        if not native:
            assert a._udp is None and b._udp is None

        def v6_up(r):
            return (r._sock6 is not None
                    or (r._udp is not None and r._udp.has_v6))
        if not (v6_up(a) and v6_up(b)):
            pytest.skip("no IPv6 loopback available")
        b.bootstrap("::1", a.get_bound_port())
        assert wait_for(lambda: b.get_status(socket.AF_INET6)
                        is NodeStatus.CONNECTED)
        key = InfoHash.get("v6key-%s" % native)
        assert b.put_sync(key, Value(b"over-six"), timeout=20.0)
        vals = a.get_sync(key, timeout=20.0)
        assert any(v.data == b"over-six" for v in vals)
    finally:
        a.join()
        b.join()


def test_bootstrap_connects(two_nodes):
    a, b = two_nodes
    assert a._udp is not None and b._udp is not None    # the native engine
    assert a.get_bound_port() > 0 and b.get_bound_port() > 0
    assert wait_for(lambda: connected(a, b)), \
        f"never connected: a={a.get_status()} b={b.get_status()}"


def test_put_get(two_nodes):
    a, b = two_nodes
    assert wait_for(lambda: b.get_status() is NodeStatus.CONNECTED)
    key = InfoHash.get("testkey")
    assert b.put_sync(key, Value(b"yo"), timeout=20.0)
    vals = a.get_sync(key, timeout=20.0)
    assert any(v.data == b"yo" for v in vals)


def test_listen(two_nodes):
    a, b = two_nodes
    assert wait_for(lambda: connected(a, b))
    key = InfoHash.get("listenkey")
    heard = []
    token_fut = a.listen(key, lambda vals, expired:
                         heard.extend(v.data for v in vals
                                      if not expired) or True)
    assert token_fut.result(20.0) >= 1
    b.put(key, Value(b"pushed value"))
    assert wait_for(lambda: b"pushed value" in heard, 20.0), \
        "listener never heard the remote put"
    a.cancel_listen(key, token_fut)
    assert wait_for(lambda: not a._listeners)


def test_many_nodes_converge():
    runners = []
    try:
        seed = DhtRunner()
        runners.append(seed)
        seed.run(0, **CPU)
        for _ in range(4):
            r = DhtRunner()
            runners.append(r)
            r.run(0, **CPU)
            r.bootstrap("127.0.0.1", seed.get_bound_port())
        assert wait_for(lambda: connected(*runners), 30.0)
        key = InfoHash.get("multi")
        assert runners[2].put_sync(key, Value(b"over the mesh"),
                                   timeout=20.0)
        vals = runners[4].get_sync(key, timeout=20.0)
        assert any(v.data == b"over the mesh" for v in vals)
        assert runners[0].get_node_stats().good_nodes >= 1
    finally:
        for r in runners:
            r.join()


def test_identity_signed_put():
    crypto = pytest.importorskip("opendht_tpu_torch.crypto")
    ida = crypto.generate_identity("runner-a", key_length=1024)
    idb = crypto.generate_identity("runner-b", key_length=1024)
    a, b = DhtRunner(), DhtRunner()
    try:
        a.run(0, RunnerConfig(identity=ida), **CPU)
        b.run(0, RunnerConfig(identity=idb), **CPU)
        assert b.get_id() == idb.first.public_key().get_id()
        b.bootstrap("127.0.0.1", a.get_bound_port())
        assert wait_for(lambda: b.get_status() is NodeStatus.CONNECTED)
        key = InfoHash.get("signed-runner")
        fut = concurrent.futures.Future()
        b.put_signed(key, Value(b"signed over udp"),
                     lambda ok, ns: fut.done() or fut.set_result(ok))
        assert fut.result(30.0)
        vals = a.get_sync(key, timeout=20.0)
        assert any(v.data == b"signed over udp" and v.check_signature()
                   for v in vals)
    finally:
        a.join()
        b.join()


def test_join_idempotent():
    r = DhtRunner()
    r.run(0, **CPU)
    r.join()
    r.join()
    assert not r.is_running()
    assert r._dht_thread is None or not r._dht_thread.is_alive()
    assert r._native_thread is None and r._udp is None


def test_prio_ops_cannot_starve_normal_ops():
    """Sustained prio traffic (the prio queue non-empty again at every
    pump) must not defer normal ops forever: each pump drains prio
    first, then the eligible normal backlog."""
    r = DhtRunner()
    r.run(0, RunnerConfig(threaded=False), **CPU)
    try:
        order = []
        r._post(lambda dht: order.append("normal"))

        def rearm(dht):
            order.append("prio")
            r._post(rearm, prio=True)

        r._post(rearm, prio=True)
        for _ in range(4):
            r.loop()
        assert "normal" in order
        assert order.index("prio") < order.index("normal")
    finally:
        r.join()


def test_normal_ops_still_gated_while_bootstrapping():
    """While a bootstrap attempt is in flight (disconnected +
    bootstrapping) normal ops stay queued and prio ops run
    (dhtrunner.cpp:393-398)."""
    r = DhtRunner()
    r.run(0, RunnerConfig(threaded=False), **CPU)
    try:
        r._bootstraping = True
        ran = []
        r._post(lambda dht: ran.append("normal"))
        r._post(lambda dht: ran.append("prio"), prio=True)
        r.loop()
        assert ran == ["prio"], ran
        r._bootstraping = False
        r.loop()
        assert ran == ["prio", "normal"], ran
    finally:
        r.join()


# ------------------------------------------ the proxy, and the card cut
def test_proxy_is_not_ported():
    """The proxy backend is ported: a runner started with
    ``RunnerConfig(proxy_server=)`` is proxied from ``run()``, puts and
    gets through a port ``DhtProxyServer``, and ``enable_proxy`` swaps
    it to its UDP node and back to the proxy."""
    from opendht_tpu_torch.proxy import DhtProxyServer
    a, b, c = DhtRunner(), DhtRunner(), DhtRunner()
    server = None
    try:
        a.run(0, **CPU)
        b.run(0, **CPU)
        b.bootstrap("127.0.0.1", a.get_bound_port())
        assert wait_for(lambda: connected(a, b), 60.0)
        server = DhtProxyServer(b, port=0)
        spec = "127.0.0.1:%d" % server.port
        c.run(0, RunnerConfig(proxy_server=spec), **CPU)
        assert wait_for(lambda: c.use_proxy, 60.0)
        key = InfoHash.get("runner-proxy-key")
        assert c.put_sync(key, Value(b"through the proxy", value_id=5),
                          timeout=60.0)
        assert [v.data for v in a.get_sync(key, timeout=60.0)] == \
            [b"through the proxy"]
        assert [v.data for v in c.get_sync(key, timeout=60.0)] == \
            [b"through the proxy"]
        c.enable_proxy(None)
        assert wait_for(lambda: not c.use_proxy, 60.0)
        assert c._proxy_client is None
        c.enable_proxy(spec)
        assert wait_for(lambda: c.use_proxy, 60.0)
        assert wait_for(lambda: c.get_status() is NodeStatus.CONNECTED, 60.0)
    finally:
        c.join()
        if server is not None:
            server.stop()
        a.join()
        b.join()


def test_planes_not_ported_answer_as_absent_and_the_rest_report():
    """Every plane the port carries (keyspace, cache, listener table and,
    since the resharder is ported, resharding) reports as the JAX
    runner's does, with the same keys; the resharder reads the runner's
    history ring; health, history, the bundle, the waterfall, the
    pipeline and the peers report."""
    from opendht_tpu.hotcache import HotValueCache as JCache
    from opendht_tpu.keyspace import KeyspaceObservatory as JObs
    from opendht_tpu.listeners import ListenerTable as JTable
    from opendht_tpu.reshard import Resharder as JResharder
    r = DhtRunner()
    r.run(0, **CPU)
    try:
        assert r._dht.reshard.history is r._history
        for get, jax_plane in ((r.get_keyspace, JObs()),
                               (r.get_cache, JCache()),
                               (r.get_listeners, JTable()),
                               (r.get_reshard, JResharder())):
            snap = get()
            assert snap["enabled"] is True
            assert set(snap) == set(jax_plane.snapshot())
        # a lone node is disconnected: its first health tick (1 s)
        # turns the verdict from unknown to unhealthy
        assert wait_for(lambda: r.get_health()["verdict"] == "unhealthy")
        assert r.get_health()["enabled"] is True
        assert r.get_history()["enabled"] is True
        b = r.dump_bundle()
        assert b["kernels"] == {}
        assert b["keyspace"]["enabled"] and b["cache"]["enabled"]
        assert b["listeners"]["enabled"]
        assert b["node_id"] == r.get_node_id().hex()
        assert {"stages", "budgets"} <= set(r.get_profile())
        assert r.get_pipeline()["enabled"] is True
        assert r.get_peers()["enabled"] is True
        assert set(r.get_metrics()) == {"counters", "gauges", "histograms"}
    finally:
        r.join()


def test_runner_needs_the_card_without_device(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = DhtRunner()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        r.run(0)
    assert not r.running and r._udp is None and r._sock4 is None


def test_the_runner_serves_its_table_through_the_device_route():
    """A runner whose table is past the host scan answers a client's
    find from its DHT thread through the snapshot route, with the table
    loaded on that thread as a posted op."""
    from opendht_tpu_torch.core import table as CT
    from opendht_tpu_torch.net.engine import EngineCallbacks, NetworkEngine
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.scheduler import Scheduler

    ids = np.random.default_rng(21).integers(0, 2 ** 32, size=(6000, 5),
                                             dtype=np.uint32)
    r = DhtRunner()
    csock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        r.run(0, RunnerConfig(dht_config=Config(max_req_per_sec=100000)),
              **CPU)
        loaded = concurrent.futures.Future()

        def load(dht):
            t = dht.tables[socket.AF_INET]
            t.bulk_load(ids, dht.scheduler.time(),
                        addrs=SockAddr("127.0.0.2", 9))
            dht.warmup()
            loaded.set_result(len(t))
        r._post(load, prio=True)
        assert loaded.result(20.0) == 6000 > CT.HOST_SCAN_MAX_ROWS

        csock.bind(("127.0.0.1", 0))
        csock.settimeout(0.05)
        ceng = NetworkEngine(InfoHash.get("runner-client"), 0,
                             lambda d, a: csock.sendto(
                                 d, (str(a.ip), a.port)) and 0,
                             Scheduler(), EngineCallbacks(), is_client=True)
        peer = ceng.cache.get_node(InfoHash(bytes(r.get_node_id())),
                                   SockAddr("127.0.0.1", r.get_bound_port()),
                                   time.monotonic(), confirm=True)
        target = InfoHash.get("far away")
        answers = []
        ceng.send_find_node(peer, target, want=1,
                            on_done=lambda req, a: answers.append(a))
        deadline = time.monotonic() + 20.0
        while not answers and time.monotonic() < deadline:
            ceng.scheduler.run()
            try:
                data, addr = csock.recvfrom(65536)
            except socket.timeout:
                continue
            ceng.process_message(data, SockAddr(*addr))
        assert answers
        d = ids ^ np.frombuffer(bytes(target), ">u4").astype(np.uint32)
        want = IK.ids_to_bytes(ids[np.lexsort(d.T[::-1])[:8]])
        assert [bytes(n.id) for n in answers[0].nodes4] == \
            [w.tobytes() for w in want]
    finally:
        csock.close()
        r.join()


# --------------------------------------------- a mixed JAX / port cluster
def _jax_runner_mods():
    from opendht_tpu import crypto as jcrypto
    from opendht_tpu.core.value import Value as JValue
    from opendht_tpu.infohash import InfoHash as JHash
    from opendht_tpu.runtime.runner import (DhtRunner as JRunner,
                                            RunnerConfig as JRunnerConfig)
    return jcrypto, JValue, JHash, JRunner, JRunnerConfig


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mixed_cluster_put_get_listen_and_signed_put(writer, monkeypatch):
    """A JAX runner and a port runner over localhost UDP: the writer's
    put reaches the reader's get and listener, and a signed put made on
    the writer verifies on the reader.  A first exchange, not checked,
    lets each node build what it builds at first use.

    The JAX node compiles an XLA program on its DHT thread the first time
    it meets each shape (the keyspace sketch update per wave width, the
    listener match per batch of stored puts).  On a loaded host one
    compile takes seconds: the JAX runner then drops every datagram that
    waited in its receive queue longer than ``RX_QUEUE_MAX_DELAY`` (0.5
    s), and the port's requests to it expire after their three 1 s
    attempts.  So the unchecked first exchange runs every op of the
    checked one (put, get, listen and push, signed put and get) on keys
    of its own, which compiles the shapes the checked ops meet, and the
    JAX peer keeps delayed packets (a 60 s limit) instead of dropping
    them; the port runner's own limit is unchanged."""
    import opendht_tpu.runtime.runner as jrunner
    monkeypatch.setattr(jrunner, "RX_QUEUE_MAX_DELAY", 60.0)
    from opendht_tpu.runtime import Config as JConfig
    from opendht_tpu_torch import crypto
    jcrypto, JValue, JHash, JRunner, JRunnerConfig = _jax_runner_mods()
    pid = crypto.generate_identity("mixed-port", key_length=1024)
    jid = jcrypto.generate_identity("mixed-jax", key_length=1024)
    port, jax_r = DhtRunner(), JRunner()
    try:
        port.run(0, RunnerConfig(identity=pid), **CPU)
        jax_r.run(0, JRunnerConfig(dht_config=JConfig(), identity=jid))
        if writer == "port":
            w, rd, WVal, RHash, WHash = port, jax_r, Value, JHash, InfoHash
        else:
            w, rd, WVal, RHash, WHash = jax_r, port, JValue, InfoHash, JHash
        rd.bootstrap("127.0.0.1", w.get_bound_port())
        assert wait_for(lambda: connected(port, jax_r), 30.0)
        warm = []
        with contextlib.suppress(TimeoutError):
            w.put_sync(WHash.get("mixed-warm"), WVal(b"warm"), timeout=30.0)
            rd.get_sync(RHash.get("mixed-warm"), timeout=30.0)
            rd.listen(RHash.get("mixed-warm-listen"),
                      lambda vals, expired: warm.extend(vals) or True
                      ).result(30.0)
            w.put(WHash.get("mixed-warm-listen"), WVal(b"warm"))
            wait_for(lambda: warm, 30.0)
            signed = concurrent.futures.Future()
            w.put_signed(WHash.get("mixed-warm-signed"), WVal(b"warm"),
                         lambda ok, ns: signed.done()
                         or signed.set_result(ok))
            signed.result(30.0)
            rd.get_sync(RHash.get("mixed-warm-signed"), timeout=30.0)

        heard = []
        tok = rd.listen(RHash.get("mixed-listen"),
                        lambda vals, expired: heard.extend(
                            v.data for v in vals if not expired) or True)
        tok.result(20.0)
        assert w.put_sync(WHash.get("mixed-key"), WVal(b"from " +
                                                      writer.encode()),
                          timeout=20.0)
        vals = rd.get_sync(RHash.get("mixed-key"), timeout=20.0)
        assert [v.data for v in vals] == [b"from " + writer.encode()]
        w.put(WHash.get("mixed-listen"), WVal(b"pushed"))
        assert wait_for(lambda: b"pushed" in heard, 20.0)

        fut = concurrent.futures.Future()
        w.put_signed(WHash.get("mixed-signed"), WVal(b"signed"),
                     lambda ok, ns: fut.done() or fut.set_result(ok))
        assert fut.result(30.0)
        vals = rd.get_sync(RHash.get("mixed-signed"), timeout=20.0)
        assert [v.data for v in vals] == [b"signed"]
        assert vals[0].check_signature()
        assert bytes(vals[0].owner.get_id()) == bytes(w.get_id())
    finally:
        port.join()
        jax_r.join()


# ------------------------------------------- carrying a JAX secure node
def test_secure_dht_from_jax_answers_as_the_original():
    """A JAX SecureDht with an identity, a table and stored values,
    carried into the port: same node id and crypto id, the same cached
    certificates, and the same reply bytes to a client's find and get."""
    from opendht_tpu import crypto as jcrypto
    from opendht_tpu.core.value import Query as JQuery, Value as JValue
    from opendht_tpu.infohash import InfoHash as JHash
    from opendht_tpu.net.engine import (EngineCallbacks as JCbs,
                                        NetworkEngine as JEngine)
    from opendht_tpu.runtime import Config as JConfig, Dht as JDht
    from opendht_tpu.runtime.secure_dht import (SecureDht as JSecure,
                                                secure_node_id)
    from opendht_tpu.scheduler import Scheduler as JSched
    from opendht_tpu.sockaddr import SockAddr as JAddr

    ident = jcrypto.generate_identity("carried", key_length=1024)
    other = jcrypto.generate_identity("other", key_length=1024)
    # the replies to the client (10.0.0.5:4000); both nodes also send
    # their own maintenance and the certificate announce elsewhere
    out = {"jax": [], "port": []}

    def to_client(which):
        return lambda d, a: (a.port == 4000
                             and out[which].append(bytes(d))) or 0
    random.seed(3)
    inner = JDht(to_client("jax"),
                 JConfig(node_id=secure_node_id(ident.second)),
                 has_v6=False)
    src = JSecure(inner, ident)
    src.register_certificate(other.second)
    ids = np.random.default_rng(4).integers(0, 2 ** 32, size=(200, 5),
                                            dtype=np.uint32)
    inner.tables[socket.AF_INET].bulk_load(ids, inner.scheduler.time(),
                                           addrs=JAddr("10.0.0.7", 4222))
    key = JHash.get("secure-carried")
    v = JValue(b"signed and stored", value_id=5)
    src.sign(v)
    inner.storage_store(key, v, inner.scheduler.time())

    dst = convert.secure_dht_from_jax(src, to_client("port"), device="cpu")
    assert bytes(dst.get_node_id()) == bytes(src.get_node_id())
    assert bytes(dst.get_id()) == bytes(src.get_id())
    assert dst.certificate.pack() == src.certificate.pack()
    oid = InfoHash(bytes(other.second.get_id()))
    assert dst.get_certificate(oid).pack() == other.second.pack()
    local = dst.get_local(InfoHash(bytes(key)))
    assert [x.data for x in local] == [b"signed and stored"]
    assert dst.check_value(local[0]) is not None

    reqs = []
    ceng = JEngine(JHash.get("asker"), 0,
                   lambda d, a: reqs.append(bytes(d)) or 0, JSched(),
                   JCbs(), is_client=True)
    peer = ceng.cache.get_node(JHash(bytes(src.get_node_id())),
                               JAddr("10.0.0.5", 4000), 0.0, confirm=True)
    seq = [201, 202]
    peer.get_new_tid = lambda: seq.pop(0)
    ceng.send_find_node(peer, JHash.get("elsewhere"), want=1)
    ceng.send_get_values(peer, key, JQuery(), want=1)
    for raw in reqs:
        src.periodic(raw, JAddr("10.0.0.5", 4000))
        dst.periodic(raw, SockAddr("10.0.0.5", 4000))
    assert len(out["jax"]) == 2
    assert out["port"] == out["jax"]
