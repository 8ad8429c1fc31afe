"""The port's REST proxy (``opendht_tpu_torch/proxy/``) and the runner's
proxy swap against the JAX package's, on the CPU over real localhost
sockets, tolerance 0.

- Every case of tests/test_proxy.py and tests/test_proxy_routes.py on
  the port: a peer runner, a proxy runner with a ``DhtProxyServer`` and
  a ``DhtProxyClient`` doing get / put / listen through REST, the push
  gateway, ``enable_proxy`` and ``RunnerConfig(proxy_server=)``,
  ``SecureDht`` over the client, the shed 503s and the observability
  routes.
- The codec: ``value_to_json`` / ``value_from_json`` give the JAX
  codec's JSON and values (packed bytes) on the same values.
- Mixed pairs: a JAX ``DhtProxyClient`` against a port server and a port
  client against a JAX server (a JAX runner in the same UDP cluster)
  round-trip put, get and listen.
- The port's planes behind the routes: ``GET /stats`` carries the
  port's ``dht_kernel_*`` ledger gauges, ``GET /profile`` its
  OPEN-bound tracker with the node's device.
- The swap: a listener survives UDP → proxy → UDP → proxy and is told of
  each put once; ``get_status`` follows the backend.
- ``convert.proxy_server_from_jax``: a port server carrying a JAX
  server's permanent puts and push listeners serves the same ``GET``.

Robust under a loaded host: every wait has its own limit of at least
60 s, a listener is attached when the proxy runner holds its record
(never after a fixed sleep), and each topology first runs an unchecked
exchange on keys of its own.
"""

from __future__ import annotations

import contextlib
import http.server
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from opendht_tpu_torch import crypto, profiling, telemetry, tracing
from opendht_tpu_torch.core.value import Value
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.proxy import (
    DhtProxyClient, DhtProxyServer, value_from_json, value_to_json)
from opendht_tpu_torch.runtime.config import Config, NodeStatus
from opendht_tpu_torch.runtime.runner import DhtRunner, RunnerConfig
from opendht_tpu_torch.runtime.secure_dht import SecureDht

CPU = {"device": "cpu"}
WAIT = 60.0


def wait_for(pred, timeout=WAIT, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def connected(*runners) -> bool:
    return all(r.get_status() is NodeStatus.CONNECTED for r in runners)


def listening(runner, key, n: int = 1) -> bool:
    """``runner`` (a proxy's backend) holds ``n`` listener records on
    ``key``: a proxied LISTEN / SUBSCRIBE is attached."""
    with runner._listeners_lock:
        recs = list(runner._listeners.values())
    return sum(1 for r in recs if bytes(r["key"]) == bytes(key)) >= n


def _get(server, path):
    url = "http://127.0.0.1:%d%s" % (server.port, path)
    with urllib.request.urlopen(url, timeout=WAIT) as r:
        return r.status, json.loads(r.read().decode())


def _get_text(port, path):
    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                timeout=WAIT) as r:
        return r.read().decode()


def warm_up(client, peer, server_runner, tag: str) -> None:
    """One unchecked exchange of every op the checked ones make (put and
    get both ways, a listen and its push), on keys of its own."""
    heard = []
    k = InfoHash.get("warm-" + tag)
    with contextlib.suppress(Exception):
        client.put(k, Value(b"warm", value_id=1), lambda ok, ns: None)
        peer.get_sync(k, timeout=WAIT)
        client.get_sync(k, timeout=WAIT)
        lk = InfoHash.get("warm-listen-" + tag)
        tok = client.listen(lk, lambda vals, expired:
                            heard.extend(vals) or True)
        wait_for(lambda: listening(server_runner, lk))
        peer.put_sync(lk, Value(b"warm", value_id=2), timeout=WAIT)
        wait_for(lambda: heard)
        client.cancel_listen(lk, tok)


@pytest.fixture(scope="module")
def topology():
    """peer node ↔ proxy node + DhtProxyServer + DhtProxyClient, as in
    tests/test_proxy.py (dhtproxytester.cpp:34-60)."""
    peer, proxy_node = DhtRunner(), DhtRunner()
    server = client = None
    try:
        peer.run(0, **CPU)
        proxy_node.run(0, **CPU)
        proxy_node.bootstrap("127.0.0.1", peer.get_bound_port())
        assert wait_for(lambda: connected(peer, proxy_node))
        server = DhtProxyServer(proxy_node, port=0)
        client = DhtProxyClient("127.0.0.1", server.port)
        warm_up(client, peer, proxy_node, "topology")
        yield peer, proxy_node, server, client
    finally:
        if client is not None:
            client.join()
        if server is not None:
            server.stop()
        peer.join()
        proxy_node.join()


# ------------------------------------------------------------- the codec
def test_json_roundtrip_plain():
    v = Value(b"hello world", type_id=3, value_id=42, user_type="text/plain")
    v2 = value_from_json(value_to_json(v))
    assert v2.id == 42 and v2.data == b"hello world"
    assert v2.type == 3 and v2.user_type == "text/plain"


def test_json_roundtrip_signed():
    ident = crypto.generate_identity("codec-test", key_length=1024)
    v = Value(b"signed payload", value_id=7)
    v.sign(ident.first)
    obj = value_to_json(v)
    assert "sig" in obj and "owner" in obj
    v2 = value_from_json(obj)
    assert v2.data == b"signed payload"
    assert v2.check_signature()


def test_json_roundtrip_encrypted():
    v = Value(value_id=9)
    v.cypher = b"\x01\x02\x03"
    v2 = value_from_json(value_to_json(v))
    assert v2.is_encrypted() and v2.cypher == b"\x01\x02\x03"


def _codec_values():
    ident = crypto.generate_identity("codec-twin", key_length=1024)
    out = [Value(b"plain", value_id=1),
           Value(b"typed", type_id=3, value_id=2**63 + 5,
                 user_type="text/plain"),
           Value(b"", value_id=0), Value(bytes(range(256)), value_id=77)]
    signed = Value(b"signed", value_id=8, user_type="u")
    signed.sign(ident.first)
    out.append(signed)
    to = Value(b"to someone", value_id=9)
    to.recipient = InfoHash.get("recipient")
    to.seq = 4
    to.sign(ident.first)
    out.append(to)
    enc = Value(value_id=10)
    enc.cypher = bytes(range(40))
    out.append(enc)
    return out


def test_codec_equals_the_jax_codec_both_ways():
    """The same ``Value`` (through its packed bytes) gives the same JSON
    in both packages, and each package decodes the other's JSON to the
    same packed value."""
    from opendht_tpu.core.value import Value as JValue
    from opendht_tpu.proxy import json_codec as J
    for v in _codec_values():
        jv = JValue.from_packed(v.get_packed())
        obj, jobj = value_to_json(v), J.value_to_json(jv)
        assert obj == jobj
        assert json.dumps(obj) == json.dumps(jobj)
        back, jback = value_from_json(jobj), J.value_from_json(obj)
        assert back.get_packed() == jback.get_packed() == v.get_packed()
        assert back.id == jback.id == v.id
    body = {"permanent": True}
    from opendht_tpu_torch.proxy.json_codec import permanent_deadline
    assert permanent_deadline(body, 3600.0) == \
        J.permanent_deadline(body, 3600.0) == 3600.0
    assert permanent_deadline({}, 1.0) is J.permanent_deadline({}, 1.0)


# ------------------------------------------------------------ the REST API
def test_node_info(topology):
    peer, proxy_node, server, client = topology
    info = client.get_proxy_info()
    assert info is not None
    assert info["node_id"] == proxy_node.get_node_id().hex()
    assert "ipv4" in info and "ingest" in info
    assert wait_for(lambda: client.get_status() is NodeStatus.CONNECTED)


def test_put_via_proxy_get_via_udp(topology):
    peer, proxy_node, server, client = topology
    key = InfoHash.get("proxy-put-key")
    done = []
    client.put(key, Value(b"via-proxy", value_id=11),
               lambda ok, ns: done.append(ok))
    assert wait_for(lambda: bool(done)) and done[0]
    vals = peer.get_sync(key, timeout=WAIT)
    assert any(v.data == b"via-proxy" for v in vals)


def test_put_via_udp_get_via_proxy(topology):
    peer, proxy_node, server, client = topology
    key = InfoHash.get("proxy-get-key")
    assert peer.put_sync(key, Value(b"via-udp", value_id=12), timeout=WAIT)
    vals = client.get_sync(key, timeout=WAIT)
    assert any(v.data == b"via-udp" for v in vals)


def test_get_specific_value_id(topology):
    peer, proxy_node, server, client = topology
    key = InfoHash.get("proxy-vid-key")
    assert peer.put_sync(key, Value(b"one", value_id=21), timeout=WAIT)
    assert peer.put_sync(key, Value(b"two", value_id=22), timeout=WAIT)
    url = "http://127.0.0.1:%d/%s/22" % (server.port, key.hex())
    with urllib.request.urlopen(url, timeout=WAIT) as r:
        lines = [json.loads(l) for l in r.read().decode().splitlines()
                 if l.strip()]
    assert lines and all(int(o["id"]) == 22 for o in lines)


def test_listen_via_proxy(topology):
    peer, proxy_node, server, client = topology
    key = InfoHash.get("proxy-listen-key")
    heard = []
    token = client.listen(key, lambda vals, expired:
                          heard.extend(v.data for v in vals) or True)
    assert wait_for(lambda: listening(proxy_node, key))
    assert peer.put_sync(key, Value(b"pushed", value_id=31), timeout=WAIT)
    assert wait_for(lambda: b"pushed" in heard), heard
    assert client.cancel_listen(key, token)


def test_stats_endpoint(topology):
    peer, proxy_node, server, client = topology
    st = client._request_json("STATS", "/")
    assert st is not None
    assert "putCount" in st and "listenCount" in st and "nodeInfo" in st


def test_subscribe_push_notifications(topology):
    """SUBSCRIBE registers a push listener; a value's arrival invokes the
    server's push sender; UNSUBSCRIBE stops it."""
    peer, proxy_node, server, client = topology
    pushed = []
    server._push_sender = lambda client_id, payload: pushed.append(
        (client_id, payload))
    try:
        push_client = DhtProxyClient("127.0.0.1", server.port,
                                     client_id="device-42")
        key = InfoHash.get("push-key")
        res = push_client.subscribe(key)
        assert res is not None and "token" in res
        assert wait_for(lambda: listening(proxy_node, key))
        assert peer.put_sync(key, Value(b"push-me", value_id=61),
                             timeout=WAIT)
        assert wait_for(lambda: any(cid == "device-42"
                                    and 61 in p.get("ids", [])
                                    for cid, p in pushed)), pushed
        assert push_client.unsubscribe(key).get("ok") is True
        push_client.join()
    finally:
        server._push_sender = None


class _FakeGorush(http.server.BaseHTTPRequestHandler):
    got: list = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self.got.append((self.path, json.loads(body)))
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, fmt, *args):
        pass


def test_push_gateway_http(topology):
    """A SUBSCRIBE with gateway fields drives Gorush-shaped POSTs to an
    HTTP push server on a value's arrival, and a refresh push near
    expiry."""
    peer, proxy_node, server, client = topology
    got = _FakeGorush.got = []
    gw = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _FakeGorush)
    threading.Thread(target=gw.serve_forever, daemon=True).start()
    from opendht_tpu_torch.proxy.push import GorushPushSender
    server._gorush = GorushPushSender("127.0.0.1:%d" % gw.server_address[1])
    try:
        push_client = DhtProxyClient("127.0.0.1", server.port,
                                     client_id="gw-client")
        key = InfoHash.get("gorush-key")
        res = push_client.subscribe(key, push_token="device-token-xyz",
                                    platform="ios", token=777)
        assert res is not None and res.get("token") == 777
        assert wait_for(lambda: listening(proxy_node, key))
        assert peer.put_sync(key, Value(b"notify-me", value_id=91),
                             timeout=WAIT)
        assert wait_for(lambda: len(got) > 0)
        path, payload = got[0]
        assert path == "/api/push"
        n = payload["notifications"][0]
        assert n["tokens"] == ["device-token-xyz"]
        assert n["platform"] == 1            # ios
        assert n["priority"] == "high" and n["time_to_live"] == 600
        assert n["data"] == {"key": key.hex(), "to": "gw-client",
                             "token": "777"}
        from opendht_tpu_torch.proxy.server import OP_MARGIN
        with server._lock:
            rec = server._push_listeners[(key, "gw-client")]
            # within OP_MARGIN of its expiry, and far from the expiry
            # itself: the maintenance pass (every 1 s, later on a loaded
            # host) expires a listener past its deadline before it
            # looks for refreshes
            rec.deadline = time.monotonic() + OP_MARGIN / 2
        assert wait_for(lambda: any("timeout" in p["notifications"][0]["data"]
                                    for _, p in got)), got
        refresh = next(p for _, p in got
                       if "timeout" in p["notifications"][0]["data"])
        d = refresh["notifications"][0]["data"]
        assert d["timeout"] == key.hex() and d["token"] == "777"
        assert push_client.unsubscribe(key).get("ok") is True
        push_client.join()
    finally:
        server._gorush.join()
        server._gorush = None
        gw.shutdown()
        gw.server_close()


def test_runner_enable_proxy_hotswap(topology):
    """A third runner switches its backend to the REST proxy, its ops and
    its live listener carry over, then it swaps back
    (dhtrunner.cpp:992-1041)."""
    peer, proxy_node, server, client = topology
    c = DhtRunner()
    c.run(0, **CPU)
    try:
        heard = []
        key = InfoHash.get("hotswap-listen")
        tok = c.listen(key, lambda vals, expired:
                       heard.extend(v.data for v in vals) or True)
        tok.result(WAIT)
        c.enable_proxy("127.0.0.1:%d" % server.port)
        assert wait_for(lambda: c.use_proxy)
        assert wait_for(lambda: c.get_status() is NodeStatus.CONNECTED)
        key2 = InfoHash.get("hotswap-put")
        assert c.put_sync(key2, Value(b"over-proxy", value_id=51),
                          timeout=WAIT)
        vals = peer.get_sync(key2, timeout=WAIT)
        assert any(v.data == b"over-proxy" for v in vals)
        assert wait_for(lambda: listening(proxy_node, key))
        assert peer.put_sync(key, Value(b"carried", value_id=52),
                             timeout=WAIT)
        assert wait_for(lambda: b"carried" in heard), heard
        c.enable_proxy(None)
        assert wait_for(lambda: not c.use_proxy)
    finally:
        c.join()


def test_runner_config_proxy_server_startup(topology):
    """RunnerConfig.proxy_server starts the node proxied from run()
    (↔ DhtRunner::Config::proxy_server, dhtrunner.cpp:98-149)."""
    peer, proxy_node, server, client = topology
    c = DhtRunner()
    c.run(0, RunnerConfig(proxy_server="127.0.0.1:%d" % server.port), **CPU)
    try:
        assert wait_for(lambda: c.use_proxy)
        assert wait_for(lambda: c.get_status() is NodeStatus.CONNECTED)
        key = InfoHash.get("config-proxy-key")
        assert c.put_sync(key, Value(b"from-config-proxy", value_id=71),
                          timeout=WAIT)
        vals = peer.get_sync(key, timeout=WAIT)
        assert any(v.data == b"from-config-proxy" for v in vals)
    finally:
        c.join()


def test_secure_dht_over_proxy(topology):
    """SecureDht over the REST backend: a signed put through the proxy,
    verified through a UDP get."""
    peer, proxy_node, server, client = topology
    ident = crypto.generate_identity("proxy-sec", key_length=1024)
    sdht = SecureDht(client, (ident.first, ident.second))
    key = InfoHash.get("proxy-signed-key")
    done = []
    sdht.put_signed(key, Value(b"signed-over-rest", value_id=41),
                    lambda ok, ns: done.append(ok))
    assert wait_for(lambda: bool(done)) and done[0]
    vals = peer.get_sync(key, timeout=WAIT)
    got = [v for v in vals if v.data == b"signed-over-rest"]
    assert got and got[0].is_signed() and got[0].check_signature()


def test_listen_and_subscribe_shed_return_503():
    """A backend listen shed at ingest admission surfaces as a 503 on
    LISTEN and SUBSCRIBE, never an open stream or a push token."""
    r = DhtRunner()
    try:
        r.run(0, RunnerConfig(dht_config=Config(ingest_queue_max=0)), **CPU)
        server = DhtProxyServer(r, 0)
        try:
            key_hex = InfoHash.get("shed-proxy").hex()
            req = urllib.request.Request(
                "http://127.0.0.1:%d/%s" % (server.port, key_hex),
                method="LISTEN")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=WAIT)
            assert ei.value.code == 503
            req = urllib.request.Request(
                "http://127.0.0.1:%d/%s" % (server.port, key_hex),
                data=json.dumps({"client_id": "shed-c"}).encode(),
                method="SUBSCRIBE",
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=WAIT)
            assert ei.value.code == 503
            assert server.get_stats().push_listeners_count == 0
        finally:
            server.stop()
    finally:
        r.join()


# ------------------------------------------ tests/test_proxy_routes.py's
def test_trace_route_name_filter(topology):
    peer, proxy_node, server, client = topology
    tr = tracing.get_tracer()
    tr.event("proxy_filter_probe_a", marker=1)
    tr.event("proxy_filter_probe_b", marker=2)
    _code, full = _get(server, "/trace")
    names = {e["ev"] for e in full["events"]}
    assert {"proxy_filter_probe_a", "proxy_filter_probe_b"} <= names
    _code, filt = _get(server, "/trace?name=proxy_filter_probe_a")
    assert filt["events"]
    assert all(e["ev"] == "proxy_filter_probe_a" for e in filt["events"])
    want = [e for e in full["events"] if "proxy_filter_probe_a" in e["ev"]]
    assert [e["seq"] for e in filt["events"]] == [e["seq"] for e in want]
    assert all("proxy_filter_probe_a" in s["name"] for s in filt["spans"])


def test_trace_route_malformed_vs_unknown_id(topology):
    peer, proxy_node, server, client = topology
    base = "http://127.0.0.1:%d/trace/" % server.port
    for bad in ("zz-not-hex", "0xqqqqqqqq", "a" * 33):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + bad, timeout=WAIT)
        assert ei.value.code == 400, bad
        assert "invalid trace id" in json.loads(
            ei.value.read().decode())["err"]
    code, doc = _get(server, "/trace/" + "f" * 32)
    assert code == 200 and doc["spans"] == []
    code, doc = _get(server, "/trace/" + "f" * 32 + "?fmt=chrome")
    assert code == 200 and doc["traceEvents"] == []


def test_cache_endpoint(topology):
    """GET /cache: the port's hot-value cache; a key admitted through the
    observe→act loop shows up with its replica widening."""
    peer, proxy_node, server, client = topology
    code, doc = _get(server, "/cache")
    assert code == 200 and doc["enabled"] is True
    assert doc["occupancy"] == len(doc["entries"])
    key = InfoHash.get("proxy-cache-key")
    assert proxy_node.put_sync(key, Value(b"cv", value_id=91), timeout=WAIT)
    ks = proxy_node._dht.keyspace
    done = []

    def observe(dht):
        for _ in range(max(40, ks.cfg.hot_min_count + 8)):
            ks.observe_hashes([key])
        ks.tick()                  # admits through the subscriber hook
        done.append(True)
    proxy_node._post(observe, prio=True)
    assert wait_for(lambda: done)

    def admitted():
        return key.hex() in [e["key"] for e in _get(server, "/cache")[1]
                             ["entries"]]
    # the admission completes on the node's thread after the tick: on a
    # loaded host GET /cache can come first
    wait_for(admitted)
    code, doc = _get(server, "/cache")
    assert code == 200
    assert key.hex() in [e["key"] for e in doc["entries"]], doc
    assert key.hex() in doc["hot_keys"]
    assert doc["replica_k"] == {"base": 8, "widened": 16}


def test_keyspace_endpoint(topology):
    """GET /keyspace: traffic through the proxy node surfaces in the
    port's sketch and, after a tick, in the heavy hitters."""
    peer, proxy_node, server, client = topology
    key = InfoHash.get("proxy-keyspace-key")
    assert peer.put_sync(key, Value(b"ks", value_id=81), timeout=WAIT)
    proxy_node._dht.keyspace.cfg.sample_stride = 1
    for _ in range(6):
        proxy_node.get_sync(key, timeout=WAIT)
    done = []
    proxy_node._post(lambda dht: done.append(dht.keyspace.tick()), prio=True)
    assert wait_for(lambda: done)
    code, doc = _get(server, "/keyspace")
    assert code == 200 and doc["enabled"] is True
    assert doc["observed_total"] > 0
    assert len(doc["hist"]) == 256
    assert "imbalance" in doc["shards"]
    assert any(t["key"] == key.hex() for t in doc["top"]), doc["top"]


def test_trace_limit_pagination(topology):
    peer, proxy_node, server, client = topology
    tr = tracing.get_tracer()
    for i in range(8):
        tr.event("limit_probe", n=i)
    _code, full = _get(server, "/trace?name=limit_probe")
    assert len(full["events"]) == 8
    _code, lim = _get(server, "/trace?name=limit_probe&limit=3")
    assert lim["limit"] == 3
    assert [e["seq"] for e in lim["events"]] == \
        [e["seq"] for e in full["events"][-3:]]
    assert len(lim["spans"]) <= 3
    _code, zero = _get(server, "/trace?limit=0")
    assert zero["events"] == [] and zero["spans"] == []
    _code, doc = _get(server, "/trace/" + "f" * 32 + "?limit=5")
    assert doc["spans"] == []
    for bad in ("nan", "-1", "1.5", "x", "1_5", "%2B5"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen("http://127.0.0.1:%d/trace?limit=%s"
                                   % (server.port, bad), timeout=WAIT)
        assert ei.value.code == 400, bad
        assert "invalid limit" in json.loads(
            ei.value.read().decode())["err"]


def test_history_endpoint(topology):
    peer, proxy_node, server, client = topology
    h = proxy_node._history
    assert h is not None
    key = InfoHash.get("proxy-history-key")
    assert proxy_node.put_sync(key, Value(b"hv", value_id=71), timeout=WAIT)
    h.tick()
    assert proxy_node.get_sync(key, timeout=WAIT)
    h.tick()
    # the recorder also ticks on its own (every period): read the full
    # ring and its last frame with no tick between them
    for _ in range(20):
        code, doc = _get(server, "/history")
        code_l, lim = _get(server, "/history?limit=1")
        if _get(server, "/history")[1]["frames"][-1]["seq"] \
                == doc["frames"][-1]["seq"]:
            break
    assert code == 200 and doc["enabled"] is True
    assert doc["frames"] and "time" in doc and "mono" in doc
    assert doc["node_id"] == proxy_node.get_node_id().hex()
    assert code_l == 200 and len(lim["frames"]) == 1
    assert lim["frames"][0]["seq"] == doc["frames"][-1]["seq"]
    code, win = _get(server, "/history?since=0.0001")
    assert len(win["frames"]) <= len(doc["frames"])
    code, zero = _get(server, "/history?limit=0")
    assert code == 200 and zero["frames"] == []
    for bad in ("since=-1", "since=x", "since=nan", "since=inf",
                "limit=-2", "limit=1.5", "limit=1_5", "since=1_0",
                "limit=%2B5"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen("http://127.0.0.1:%d/history?%s"
                                   % (server.port, bad), timeout=WAIT)
        assert ei.value.code == 400, bad


def test_debug_bundle_endpoint(topology):
    peer, proxy_node, server, client = topology
    proxy_node._history.tick()
    code, b = _get(server, "/debug/bundle")
    assert code == 200
    assert b["kind"] == "dht-blackbox-bundle"
    assert b["node_id"] == proxy_node.get_node_id().hex()
    assert b["reason"] == "on_demand"
    for section in ("history", "flight_recorder", "health", "keyspace",
                    "cache", "metrics", "auto_captures"):
        assert section in b, section
    assert b["history"]["enabled"] is True
    assert b["history"]["frames"]
    assert isinstance(b["flight_recorder"]["events"], list)


# ---------------------------------------- the port's planes behind routes
def test_stats_carry_the_port_ledger_and_profile_its_open_bounds(
        topology, monkeypatch):
    """``GET /stats`` refreshes the runner's metrics: once the port's
    ledger is computed, its ``dht_kernel_*`` gauges are in the text
    exposition with the ledger's values; ``GET /profile`` carries the
    OPEN-bound tracker of the node's device, and ``/reshard`` and
    ``/listeners`` the port's planes.  The gauges go to a registry of
    the test's own: exported gauges outlive ``clear()``, and other test
    files hold the process registry free of them."""
    peer, proxy_node, server, client = topology
    reg = telemetry.MetricsRegistry()
    monkeypatch.setattr(telemetry, "get_registry", lambda: reg)
    led = profiling.get_ledger()
    try:
        entry = led.compute(["cache_probe"], device="cpu")["cache_probe"]
        text = _get_text(server.port, "/stats")
        got = [float(l.split()[-1]) for l in text.splitlines()
               if l.startswith('dht_kernel_launches{kernel="cache_probe"}')]
        assert got == [entry["launches"]] and got[0] > 0
        for g in ("dht_kernel_flops", "dht_kernel_bytes_accessed",
                  "dht_kernel_hbm_bytes"):
            assert any(l.startswith(g + '{kernel="cache_probe"}')
                       and float(l.split()[-1]) > 0
                       for l in text.splitlines()), g
        assert "dht_proxy_requests_total" in text
    finally:
        led.clear()
    code, prof = _get(server, "/profile")
    ob = prof["open_bounds"]
    assert (ob["platform"], ob["status"]) == ("cpu", "unsettled")
    assert set(ob["bounds"]) and "stages" in prof
    code, rs = _get(server, "/reshard")
    assert code == 200 and set(rs) == set(proxy_node.get_reshard())
    code, ls = _get(server, "/listeners")
    assert code == 200 and ls["enabled"] is True


# ----------------------------------------------------- the swap, in full
def test_listener_survives_two_swaps_and_status_follows_the_backend(
        topology):
    """A runner in the cluster listens, then swaps UDP → proxy → UDP →
    proxy; each put is delivered to its callback exactly once (the
    runner's dedup absorbs each new backend's replay), and
    ``get_status`` is the proxy client's while proxied."""
    peer, proxy_node, server, client = topology
    spec = "127.0.0.1:%d" % server.port
    c = DhtRunner()
    try:
        c.run(0, **CPU)
        c.bootstrap("127.0.0.1", peer.get_bound_port())
        assert wait_for(lambda: connected(c))
        heard = []
        key = InfoHash.get("two-swaps-listen")
        c.listen(key, lambda vals, expired: heard.extend(
            (v.id, v.data) for v in vals if not expired) or True
            ).result(WAIT)
        puts = []

        def put_and_hear(i):
            v = (100 + i, b"swap put %d" % i)
            puts.append(v)
            assert peer.put_sync(key, Value(v[1], value_id=v[0]),
                                 timeout=WAIT)
            assert wait_for(lambda: heard[-1:] == [v]), (heard, v)

        put_and_hear(0)
        for i, proxy in enumerate((spec, None, spec), 1):
            n_before = sum(1 for r in list(proxy_node._listeners.values())
                           if bytes(r["key"]) == bytes(key))
            c.enable_proxy(proxy)
            assert wait_for(lambda: c.use_proxy is bool(proxy))
            if proxy:
                assert c.get_status() is c._proxy_dht.get_status()
                assert wait_for(lambda: listening(proxy_node, key,
                                                  n_before + 1))
            else:
                assert c._proxy_dht is None
                assert c.get_status() is max(
                    (c.status4, c.status6), key=lambda s: s.value)
            put_and_hear(i)
        time.sleep(1.0)                 # a late duplicate would land here
        assert heard == puts
        assert c.get_status() is NodeStatus.CONNECTED
    finally:
        c.join()


# ------------------------------------------------------------ mixed pairs
@pytest.fixture(scope="module")
def jax_side(topology):
    """A JAX runner in the same UDP cluster (bootstrapped to the port
    peer) with a JAX DhtProxyServer in front of it.  The JAX node keeps
    delayed packets (its first XLA compiles take seconds on a loaded
    host) and runs an unchecked exchange first."""
    import opendht_tpu.runtime.runner as jrunner
    from opendht_tpu.proxy import DhtProxyServer as JServer
    peer, proxy_node, server, client = topology
    mp = pytest.MonkeyPatch()
    mp.setattr(jrunner, "RX_QUEUE_MAX_DELAY", 60.0)
    jr = jrunner.DhtRunner()
    jserver = None
    try:
        jr.run(0)
        jr.bootstrap("127.0.0.1", peer.get_bound_port())
        assert wait_for(lambda: jr.get_status().name == "CONNECTED")
        jserver = JServer(jr, port=0)
        pclient = DhtProxyClient("127.0.0.1", jserver.port)
        warm_up(pclient, peer, jr, "jax-side")
        yield jr, jserver, pclient
        pclient.join()
    finally:
        if jserver is not None:
            jserver.stop()
        jr.join()
        mp.undo()


def _round_trip(cl, H, V, server_runner, peer, tag: str) -> None:
    """Put through the client (read back over UDP), get through it (a
    UDP put), listen through it (a UDP put heard once)."""
    k1 = H.get("mixed-put-" + tag)
    done = []
    cl.put(k1, V(b"put " + tag.encode(), value_id=301),
           lambda ok, ns: done.append(ok))
    assert wait_for(lambda: done) and done[0]
    assert any(v.data == b"put " + tag.encode()
               for v in peer.get_sync(InfoHash(bytes(k1)), timeout=WAIT))
    k2 = InfoHash.get("mixed-get-" + tag)
    assert peer.put_sync(k2, Value(b"get " + tag.encode(), value_id=302),
                         timeout=WAIT)
    got = cl.get_sync(H(bytes(k2)), timeout=WAIT)
    assert [(v.id, v.data) for v in got] == [(302, b"get " + tag.encode())]
    k3 = InfoHash.get("mixed-listen-" + tag)
    heard = []
    tok = cl.listen(H(bytes(k3)), lambda vals, expired: heard.extend(
        (v.id, v.data) for v in vals) or True)
    assert wait_for(lambda: listening(server_runner, k3))
    assert peer.put_sync(k3, Value(b"heard " + tag.encode(), value_id=303),
                         timeout=WAIT)
    assert wait_for(lambda: heard)
    time.sleep(0.5)
    assert heard == [(303, b"heard " + tag.encode())]
    assert cl.cancel_listen(H(bytes(k3)), tok)


def test_jax_client_against_the_port_server(topology):
    from opendht_tpu.core.value import Value as JValue
    from opendht_tpu.infohash import InfoHash as JHash
    from opendht_tpu.proxy import DhtProxyClient as JClient
    peer, proxy_node, server, client = topology
    jc = JClient("127.0.0.1", server.port)
    try:
        _round_trip(jc, JHash, JValue, proxy_node, peer, "jax-client")
    finally:
        jc.join()


def test_port_client_against_the_jax_server(topology, jax_side):
    peer, proxy_node, server, client = topology
    jr, jserver, pclient = jax_side
    _round_trip(pclient, InfoHash, Value, jr, peer, "port-client")


def test_proxy_server_from_jax_serves_the_same_gets(topology, jax_side):
    """``convert.proxy_server_from_jax``: a JAX server's permanent put
    and push subscription carried onto a port server in front of the
    port proxy runner; both servers answer ``GET /{hash}`` with the same
    JSON lines, keep the same deadlines, and the carried subscription
    pushes on the next put."""
    from opendht_tpu.core.value import Value as JValue
    from opendht_tpu.infohash import InfoHash as JHash
    from opendht_tpu.proxy import DhtProxyClient as JClient
    from opendht_tpu_torch import convert
    peer, proxy_node, server, client = topology
    jr, jserver, pclient = jax_side
    jc = JClient("127.0.0.1", jserver.port, client_id="carried-device")
    pushed = []
    jserver._push_sender = lambda cid, payload: pushed.append((cid, payload))
    dst = None
    try:
        key = JHash.get("carried-permanent")
        done = []
        jc.put(key, JValue(b"permanent over rest", value_id=401),
               lambda ok, ns: done.append(ok), permanent=True)
        assert wait_for(lambda: done) and done[0]
        sub_key = JHash.get("carried-subscription")
        assert jc.subscribe(sub_key, push_token="tok", token=9) is not None
        dst = convert.proxy_server_from_jax(jserver, proxy_node)
        assert dst._push_sender is jserver._push_sender
        carried = []
        dst._push_sender = lambda cid, payload: carried.append(
            (cid, payload))
        pkey = InfoHash(bytes(key))
        with jserver._lock, dst._lock:
            jp = jserver._puts[(key, 401)]
            pp = dst._puts[(pkey, 401)]
            assert (pp.deadline, pp.client_id) == (jp.deadline, jp.client_id)
            assert pp.value.get_packed() == jp.value.get_packed()
            jl = jserver._push_listeners[(sub_key, "carried-device")]
            pl = dst._push_listeners[(InfoHash(bytes(sub_key)),
                                      "carried-device")]
            assert (pl.deadline, pl.push_token, pl.is_android,
                    pl.client_token, pl.refresh_sent) == \
                (jl.deadline, jl.push_token, jl.is_android,
                 jl.client_token, jl.refresh_sent)
        assert dst.stats.put_count == 1
        assert dst.stats.push_listeners_count == 1

        def lines(port):
            text = _get_text(port, "/" + key.hex())
            return sorted(l for l in text.splitlines() if l.strip())
        assert wait_for(lambda: lines(dst.port)
                        and lines(dst.port) == lines(jserver.port))
        assert json.loads(lines(dst.port)[0])["id"] == "401"
        assert wait_for(lambda: listening(proxy_node, InfoHash(bytes(sub_key))))
        assert peer.put_sync(InfoHash(bytes(sub_key)),
                             Value(b"ring", value_id=402), timeout=WAIT)
        for got in (pushed, carried):       # the JAX server's, the port's
            assert wait_for(lambda: any(cid == "carried-device"
                                        and 402 in p.get("ids", [])
                                        for cid, p in got)), got
        assert [p for _, p in carried if 402 in p["ids"]][0] == \
            [p for _, p in pushed if 402 in p["ids"]][0]
    finally:
        jserver._push_sender = None
        jc.join()
        if dst is not None:
            dst.stop()
