"""The port's monitor (``tools/dhtmon.py``, ``testing/health_monitor.py``,
``testing/telemetry_smoke.py``) and assemblers
(``testing/timeline_assembler.py``, ``testing/wiremap_assembler.py``)
against the JAX package's, on the CPU, tolerance 0.

- Every case of tests/test_health.py, test_history.py, test_telemetry.py,
  test_peers.py, test_waterfall.py and test_hotcache.py that calls one of
  those modules runs on both packages (the JAX test file executed as
  written and with its imports read as ``opendht_tpu_torch``, the manner
  of tests/test_torch_storage.py): both pass the case's assertions, and
  both make the same calls into the monitor and assemblers with the
  same results.  Where a case reads the wall clock, the clock is frozen
  for both runs; where it scrapes a live registry, both packages get a
  fresh one and the scraped values are masked (their names stay).
- The replica-coverage probe's cases of tests/test_health.py, twinned by
  hand with ``device="cpu"``: the census, the batched resolve against
  the per-key scalar oracle, a census smaller than k, the t-sharded
  resolve and the end-to-end accounting over stub runners.  Over 64
  keys the port resolves through its device snapshot (counted), at 64
  or fewer by its host scan; both give the JAX id lists.
- Mixed pairs over a live real-UDP cluster of port and JAX runners, each
  behind its own package's REST proxy: the JAX ``dhtmon`` over the port
  nodes' endpoints, and the port's over the JAX nodes', each against
  the other package's ``dhtmon`` on the same endpoints (the same
  violations, report and exit code), each node read through a
  ``FrozenFront`` so both monitors see one moment of it.
- ``convert.stores_from_jax``: the JAX cluster's values carried into port
  runners, after which both packages' probes read the same answer.
- ``telemetry_smoke.main(["--cpu"])`` on the port.

Robust under a loaded host: the live cluster runs an unchecked exchange
on keys of its own first, both packages' runners keep delayed packets,
and every wait has its own limit of at least 60 s.
"""

from __future__ import annotations

import inspect
import json
import time

import numpy as np
import pytest
import torch

from opendht_tpu_torch.core.value import Value
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.sockaddr import SockAddr
from opendht_tpu_torch.testing import health_monitor as hm
from opendht_tpu_torch.tools import dhtmon
from test_torch_storage import jax_case_namespace, norm, traced_returns

CPU = "cpu"
WAIT = 60.0
MONITOR_FILES = ("tools/dhtmon.py", "testing/health_monitor.py",
                 "testing/telemetry_smoke.py",
                 "testing/timeline_assembler.py",
                 "testing/wiremap_assembler.py")


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads while this file's nodes run: their ops are
    tiny, and beside other busy test processes all-core OpenMP pools
    spin against each other and slow every process on the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def wait_for(pred, timeout=WAIT, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


# ---------------------------------------- the JAX cases, on both packages
FROZEN, FRESH = "frozen clock", "fresh registries"
JAX_CASES = [
    ("test_health.py",
     "test_dhtmon_window_skips_second_scrape_when_not_windowed", ()),
    ("test_health.py", "test_dhtmon_imbalance_unknown_never_violates", ()),
    ("test_health.py", "test_dhtmon_listener_lag_gate", ()),
    ("test_health.py",
     "test_dhtmon_listener_lag_unknown_never_violates", ()),
    ("test_history.py", "test_frames_json_roundtrip", (FROZEN,)),
    ("test_history.py", "test_frames_equal_scrape_diff", ()),
    ("test_history.py", "test_dhtmon_since_rejects_non_positive", ()),
    ("test_history.py", "test_timeline_skew_and_monotonicity", (FROZEN,)),
    ("test_history.py", "test_timeline_accepts_bundles_with_events",
     (FROZEN,)),
    ("test_history.py",
     "test_timeline_single_source_gets_default_node_name", ()),
    ("test_history.py", "test_timeline_empty_histories", ()),
    ("test_history.py",
     "test_timeline_non_monotonic_dip_reports_once_and_keeps_frames", ()),
    ("test_telemetry.py", "test_prometheus_escaping_and_validity", ()),
    ("test_telemetry.py", "test_prometheus_exposition_golden", ()),
    ("test_telemetry.py", "test_snapshot_prometheus_same_registry", ()),
    ("test_telemetry.py", "test_proxy_stats_prometheus_route", (FRESH,)),
    ("test_peers.py", "test_runner_get_peers_degrades_before_run", ()),
    ("test_peers.py", "test_wiremap_from_ledgers_edges_and_attribution",
     ()),
    ("test_peers.py", "test_wiremap_skew_adjustment_and_violations", ()),
    ("test_peers.py", "test_dhtmon_max_peer_fail_worst_link_gate", ()),
    ("test_peers.py", "test_dhtmon_max_peer_fail_unknown_never_violates",
     ()),
    ("test_waterfall.py",
     "test_dhtmon_stage_p95_reader_handles_both_label_orders", ()),
    ("test_waterfall.py", "test_dhtmon_max_stage_spec_validation", ()),
    ("test_hotcache.py", "test_dhtmon_min_cache_hit_contract", ()),
]


def _mask(x):
    """Scraped values out of a normalised record (names stay)."""
    if isinstance(x, float):
        return "value"
    if isinstance(x, (list, tuple)):
        return type(x)(_mask(i) for i in x)
    return x


def _fresh_registries(monkeypatch) -> None:
    from opendht_tpu import telemetry as jtel
    from opendht_tpu_torch import telemetry as ptel
    for mod in (jtel, ptel):
        reg = mod.MetricsRegistry()
        monkeypatch.setattr(mod, "_global_registry", reg, raising=False)
        monkeypatch.setattr(mod, "_registry", reg, raising=False)
        monkeypatch.setattr(mod, "get_registry", lambda r=reg: r)


@pytest.mark.parametrize("fname,name,how", JAX_CASES,
                         ids=["%s::%s" % c[:2] for c in JAX_CASES])
def test_jax_case_on_both_packages(fname, name, how, monkeypatch):
    recs = []
    for pkg in ("jax", "port"):
        case = jax_case_namespace(fname, pkg)[name]
        with monkeypatch.context() as mp:
            if FROZEN in how:
                mp.setattr(time, "time", lambda: 1_760_000_000.0)
            if FRESH in how:
                _fresh_registries(mp)
            kw = {"monkeypatch": mp} \
                if "monkeypatch" in inspect.signature(case).parameters \
                else {}
            recs.append(traced_returns(lambda: case(**kw), pkg,
                                       MONITOR_FILES))
    jax_rec, port_rec = recs
    assert jax_rec, "the case reached no monitor function"
    if FRESH in how:
        jax_rec, port_rec = _mask(jax_rec), _mask(port_rec)
    assert port_rec == jax_rec


# ------------------------------------- the probe's cases, twinned by hand
def _pkgs():
    """(health_monitor, InfoHash, SockAddr, placement) of each package."""
    from opendht_tpu.infohash import InfoHash as JHash
    from opendht_tpu.sockaddr import SockAddr as JAddr
    from opendht_tpu.testing import health_monitor as jhm
    return {"jax": (jhm, JHash, JAddr, {}),
            "port": (hm, InfoHash, SockAddr, {"device": CPU})}


def _census(pkg, n_nodes, seed):
    """tests/test_health.py's _census in ``pkg``: (table, ids, keys rng)."""
    mod, H, A, place = _pkgs()[pkg]
    rng = np.random.default_rng(seed)
    ids = [H(bytes(rng.integers(0, 256, 20, dtype=np.uint8)))
           for _ in range(n_nodes)]
    nodes = [(nid, A("127.0.0.1", 1000 + i)) for i, nid in enumerate(ids)]
    return mod.census_table(nodes, now=100.0, **place), ids, rng


def _keys(pkg, rng, n):
    H = _pkgs()[pkg][1]
    return [H(bytes(rng.integers(0, 256, 20, dtype=np.uint8)))
            for _ in range(n)]


def _hex(rows):
    return [[str(i) for i in row] for row in rows]


def _closest(pkg, n_nodes, n_keys, seed, k=8, mesh=None):
    """closest_ids over a seeded census in ``pkg`` and its per-key
    scalar oracle."""
    mod, _, _, place = _pkgs()[pkg]
    table, ids, rng = _census(pkg, n_nodes, seed)
    keys = _keys(pkg, rng, n_keys)
    batched = mod.closest_ids(table, keys, k=k, now=100.0, mesh=mesh,
                              **place)
    oracle = [mod.closest_ids(table, [key], k=k, now=100.0, **place)[0]
              for key in keys]
    return _hex(batched), _hex(oracle), [str(i) for i in ids]


def _count_snapshot_calls(monkeypatch) -> list:
    from opendht_tpu_torch.core import table as CT
    calls = []
    orig = CT.Snapshot.lookup_launch

    def counted(self, q, *a, **kw):
        calls.append(len(q))
        return orig(self, q, *a, **kw)
    monkeypatch.setattr(CT.Snapshot, "lookup_launch", counted)
    return calls


def test_census_table_holds_every_node():
    for pkg in ("jax", "port"):
        table, ids, _ = _census(pkg, 64, 3)
        assert len(table) == 64
    assert str(_census("port", 64, 3)[0].device) == CPU


def test_replica_probe_batched_matches_scalar_oracle():
    jb, jo, _ = _closest("jax", 24, 20, 5)
    pb, po, _ = _closest("port", 24, 20, 5)
    assert pb == po == jb == jo
    assert all(len(row) == 8 for row in pb)


def test_replica_probe_fewer_than_k_nodes():
    pb, po, ids = _closest("port", 5, 7, 6)
    jb, _, _ = _closest("jax", 5, 7, 6)
    assert pb == po == jb
    for row in pb:
        assert len(row) == 5 and set(row) == set(ids)


def test_replica_probe_tsharded_matches_oracle():
    """Over 64 keys, so both packages resolve through their device
    snapshot, the port's on a virtual mesh of two CPU shards."""
    import jax
    from opendht_tpu.parallel import make_mesh as jmake_mesh
    from opendht_tpu_torch.parallel import make_mesh
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    jb, jo, _ = _closest("jax", 96, 80, 8, mesh=jmake_mesh(2, q=1, t=2))
    pb, po, _ = _closest("port", 96, 80, 8,
                         mesh=make_mesh(2, q=1, t=2, devices=CPU))
    assert pb == po == jb == jo


@pytest.mark.parametrize("n_keys,route", [(256, "snapshot"),
                                          (64, "host scan")])
def test_closest_ids_device_path_equals_jax(n_keys, route, monkeypatch):
    """256 keys take the port's device snapshot (window_select's route),
    64 its host scan; both equal the JAX package's id lists, and the
    per-key scalar oracle."""
    calls = _count_snapshot_calls(monkeypatch)
    table, _, rng = _census("port", 32, 21)
    keys = _keys("port", rng, n_keys)
    got = _hex(hm.closest_ids(table, keys, k=8, now=100.0, device=CPU))
    assert calls == ([n_keys] if route == "snapshot" else [])
    jtable, _, jrng = _census("jax", 32, 21)
    jkeys = _keys("jax", jrng, n_keys)
    from opendht_tpu.testing import health_monitor as jhm
    want = _hex(jhm.closest_ids(jtable, jkeys, k=8, now=100.0))
    assert got == want
    assert all(len(row) == 8 for row in got)
    assert got[:8] == [_hex(hm.closest_ids(table, [key], k=8, now=100.0,
                                           device=CPU))[0]
                       for key in keys[:8]]


def test_closest_ids_refuses_a_table_on_another_device(monkeypatch):
    table, _, rng = _census("port", 8, 2)
    with pytest.raises(ValueError, match="census table is on cpu"):
        hm.closest_ids(table, _keys("port", rng, 2), device="meta")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hm.closest_ids(table, _keys("port", rng, 2))


class _St:
    def __init__(self, has):
        self._has = has

    def empty(self):
        return not self._has


class _StubRunner:
    """The surface the probe reads: node id, bound port, ``_dht.store``."""

    def __init__(self, nid, store, port=4000):
        self._nid = nid
        self._port = port
        self._dht = type("D", (), {"store": store})()

    def get_node_id(self):
        return self._nid

    def get_bound_port(self):
        return self._port


def _stub_cluster(pkg, n_nodes, n_keys, seed, sample_max):
    """Seeded stub runners of ``pkg``: each key held by a seeded subset,
    the probe's report over them."""
    mod, H, _, place = _pkgs()[pkg]
    rng = np.random.default_rng(seed)
    ids = [H(bytes(rng.integers(0, 256, 20, dtype=np.uint8)))
           for _ in range(n_nodes)]
    keys = [H(bytes(rng.integers(0, 256, 20, dtype=np.uint8)))
            for _ in range(n_keys)]
    held = rng.random((n_nodes, n_keys)) < 0.3
    runners = [_StubRunner(nid, {key: _St(bool(held[i, j]))
                                 for j, key in enumerate(keys)},
                           port=4000 + i)
               for i, nid in enumerate(ids)]
    return mod.replica_coverage(runners, sample_max=sample_max, k=8,
                                seed=seed, **place)


def test_replica_coverage_end_to_end_fake_runners():
    """tests/test_health.py's case: a value held by every census node
    scores 1.0, a value held nowhere is not sampled."""
    out = {}
    for pkg in ("jax", "port"):
        mod, H, _, place = _pkgs()[pkg]
        rng = np.random.default_rng(9)
        ids = [H(bytes(rng.integers(0, 256, 20, dtype=np.uint8)))
               for _ in range(4)]
        k_full = H(bytes(rng.integers(0, 256, 20, dtype=np.uint8)))
        k_none = H(bytes(rng.integers(0, 256, 20, dtype=np.uint8)))
        runners = [_StubRunner(nid, {k_full: _St(True), k_none: _St(False)})
                   for nid in ids]
        cov = out[pkg] = mod.replica_coverage(runners, k=8, **place)
        assert cov["keys"] == 1 and cov["mean_coverage"] == 1.0
        assert {p["key"]: p for p in cov["per_key"]}[k_full.hex()][
            "expected"] == 4
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("n_keys,sample_max", [(300, 256), (40, 64)])
def test_replica_coverage_equals_jax_on_stub_runners(n_keys, sample_max,
                                                     monkeypatch):
    """The same stores in both packages: the same sample, the same
    closest-8 accounting, key by key (256 sampled keys resolve through
    the port's device snapshot, 40 through its host scan)."""
    calls = _count_snapshot_calls(monkeypatch)
    port = _stub_cluster("port", 32, n_keys, 12, sample_max)
    assert calls == ([256] if n_keys > 64 else [])
    jax_ = _stub_cluster("jax", 32, n_keys, 12, sample_max)
    assert port == jax_
    assert port["keys"] == min(sample_max, port["sampled_of"])
    assert 0.0 < port["mean_coverage"] < 1.0


# ------------------------------------------------ convert.stores_from_jax
def test_stores_from_jax_carries_values_and_the_probe_agrees():
    """Values stored on JAX nodes (stubs over JAX ``Dht`` cores, and one
    running port runner among the targets) carried by
    ``convert.stores_from_jax``: the same keys, bytes and expirations,
    and the same probe report in both packages."""
    from opendht_tpu.core.value import Value as JValue
    from opendht_tpu.infohash import InfoHash as JHash
    from opendht_tpu.runtime import Config as JConfig, Dht as JDht
    from opendht_tpu.scheduler import Scheduler as JScheduler
    from opendht_tpu.testing import health_monitor as jhm
    from opendht_tpu_torch import convert
    from opendht_tpu_torch.runtime import Config, Dht, DhtRunner, RunnerConfig
    from opendht_tpu_torch.scheduler import Scheduler

    rng = np.random.default_rng(17)
    ids = [bytes(rng.integers(0, 256, 20, dtype=np.uint8))
           for _ in range(12)]
    now = time.monotonic()
    jstubs = []
    for i, nid in enumerate(ids):
        d = JDht(lambda data, addr: 0, JConfig(node_id=JHash(nid)),
                 JScheduler(clock=time.monotonic), has_v6=False)
        jstubs.append(_StubRunner(JHash(nid), None, port=5000 + i))
        jstubs[-1]._dht = d
    for j in range(90):
        key = JHash(bytes(rng.integers(0, 256, 20, dtype=np.uint8)))
        for i in rng.choice(12, size=int(rng.integers(1, 9)),
                            replace=False):
            jstubs[i]._dht.storage_store(
                key, JValue(b"value %d" % j, value_id=j + 1), now)
    runner = DhtRunner()
    try:
        runner.run(0, RunnerConfig(
            dht_config=Config(node_id=InfoHash(ids[0]))), device=CPU)
        pstubs = [runner]
        for i, nid in enumerate(ids[1:], 1):
            d = Dht(lambda data, addr: 0, Config(node_id=InfoHash(nid)),
                    Scheduler(clock=time.monotonic), has_v6=False,
                    device=CPU)
            pstubs.append(_StubRunner(InfoHash(nid), None, port=5000 + i))
            pstubs[-1]._dht = d
        carried = convert.stores_from_jax(jstubs, pstubs)
        want = sum(st.value_count() for s in jstubs
                   for st in s._dht.store.values())
        assert carried == want > 90

        def dump(stubs):
            return sorted((bytes(s.get_node_id()), bytes(k), vs.data.id,
                           bytes(vs.data.data), vs.created, vs.expiration)
                          for s in stubs
                          for k, st in list(s._dht.store.items())
                          for vs in st.values)
        assert dump(pstubs) == dump(jstubs)
        p = hm.replica_coverage(pstubs, sample_max=256, device=CPU)
        j = jhm.replica_coverage(jstubs, sample_max=256)
        assert p == j and p["keys"] == 90
        with pytest.raises(KeyError):
            convert.stores_from_jax(jstubs, pstubs[1:])
    finally:
        runner.join()


# --------------------------------------------- the port's telemetry smoke
def test_telemetry_smoke_runs_on_the_cpu():
    from opendht_tpu_torch.testing import telemetry_smoke
    assert telemetry_smoke.main(["--cpu"]) == 0


# ------------------------------------------------------------ mixed pairs
@pytest.fixture(scope="module")
def mixed_cluster():
    """Three port runners and three JAX runners on one localhost UDP
    cluster, each behind a REST proxy of its own package, after an
    unchecked warm-up exchange and a checked one.  Both packages' nodes
    keep delayed packets (the JAX nodes' first XLA compiles take seconds
    on a loaded host)."""
    import opendht_tpu.runtime.runner as jrunner
    from opendht_tpu.core.value import Value as JValue
    from opendht_tpu.infohash import InfoHash as JHash
    from opendht_tpu.proxy import DhtProxyServer as JServer
    from opendht_tpu_torch.proxy import DhtProxyServer
    from opendht_tpu_torch.runtime import DhtRunner
    import opendht_tpu_torch.runtime.runner as prunner
    mp = pytest.MonkeyPatch()
    mp.setattr(jrunner, "RX_QUEUE_MAX_DELAY", 60.0)
    mp.setattr(prunner, "RX_QUEUE_MAX_DELAY", 60.0)
    port_nodes = [DhtRunner() for _ in range(3)]
    jax_nodes = [jrunner.DhtRunner() for _ in range(3)]
    servers = []
    try:
        for r in port_nodes:
            r.run(0, device=CPU)
        for r in jax_nodes:
            r.run(0)
        seed = port_nodes[0].get_bound_port()
        for r in port_nodes[1:] + jax_nodes:
            r.bootstrap("127.0.0.1", seed)
        everyone = port_nodes + jax_nodes
        assert wait_for(lambda: all(r.get_status().name == "CONNECTED"
                                    for r in everyone), 2 * WAIT)
        # warm-up on keys of its own (every node's first lookups and, on
        # the JAX nodes, their compiles), unchecked
        for i, r in enumerate(everyone):
            H, V = (InfoHash, Value) if r in port_nodes else (JHash, JValue)
            r.put_sync(H.get("monitor-warm-%d" % i), V(b"w"), timeout=WAIT)
        for i, r in enumerate(everyone):
            H, V = (InfoHash, Value) if r in port_nodes else (JHash, JValue)
            key = "monitor-pair-%d" % i
            assert r.put_sync(H.get(key), V(b"v%d" % i, value_id=i + 1),
                              timeout=WAIT)
        for i, r in enumerate(everyone):
            H = InfoHash if r in port_nodes else JHash
            key = "monitor-pair-%d" % ((i + 1) % len(everyone))
            got = r.get_sync(H.get(key), timeout=WAIT)
            assert [v.data for v in got] == [b"v%d" % ((i + 1)
                                                       % len(everyone))]
        servers = [DhtProxyServer(r, port=0) for r in port_nodes] + \
            [JServer(r, port=0) for r in jax_nodes]
        eps = ["127.0.0.1:%d" % s.port for s in servers]
        time.sleep(2.5)          # the history recorders' next frames
        yield {"port": eps[:3], "jax": eps[3:]}
    finally:
        for s in servers:
            s.stop()
        for r in port_nodes + jax_nodes:
            r.join()
        mp.undo()


GATES = dict(require_ready=True, min_success=0.5, alerts={95.0: 30.0},
             max_stage={"rpc_wait": 30.0, "queue_wait": 30.0},
             max_imbalance=1e9, min_cache_hit=0.0, max_listener_lag=30.0,
             since=3600.0)
CLI = ["--require-ready", "--min-success", "0.5", "--alert", "p95=30",
       "--max-stage", "rpc_wait=30", "--since", "3600", "--json"]


class FrozenFront:
    """An HTTP front for one node's REST proxy that forwards the first
    GET of each path and answers every later GET of it with the same
    status and bytes: two monitors reading a live node through it read
    one moment of that node (its maintenance traffic and health ticks
    go on between their scrapes)."""

    def __init__(self, upstream: str):
        import threading
        import urllib.error
        import urllib.request
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        cache, lock = {}, threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                with lock:
                    if self.path not in cache:
                        url = "http://%s%s" % (upstream, self.path)
                        try:
                            with urllib.request.urlopen(url,
                                                        timeout=WAIT) as r:
                                got = (r.status, r.headers, r.read())
                        except urllib.error.HTTPError as e:
                            got = (e.code, e.headers, e.read())
                        cache[self.path] = (got[0], got[1].get(
                            "Content-Type", "text/plain"), got[2])
                    code, ctype, body = cache[self.path]
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.endpoint = "127.0.0.1:%d" % self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


def _both_dhtmons(eps, capsys) -> dict:
    """Each package's run_checks and CLI over the same endpoints, read
    through one FrozenFront each."""
    from opendht_tpu.tools import dhtmon as jdhtmon
    fronts = [FrozenFront(ep) for ep in eps]
    feps = [f.endpoint for f in fronts]
    out = {}
    try:
        for pkg, mod in (("jax", jdhtmon), ("port", dhtmon)):
            violations, doc = mod.run_checks(feps, **GATES)
            capsys.readouterr()
            rc = mod.main(["--nodes", ",".join(feps)] + CLI)
            cli = json.loads(capsys.readouterr().out)
            out[pkg] = (violations, norm(doc), rc, norm(cli))
    finally:
        for f in fronts:
            f.stop()
    return out


@pytest.mark.parametrize("nodes", ["port", "jax"])
def test_both_dhtmons_agree_over_one_packages_endpoints(nodes,
                                                        mixed_cluster,
                                                        capsys):
    """The JAX dhtmon over the port nodes' endpoints and the port's over
    the JAX nodes', each beside the other package's on the same
    endpoints (one moment of each, through a FrozenFront): the same
    violations, report and exit code."""
    out = _both_dhtmons(mixed_cluster[nodes], capsys)
    assert out["port"] == out["jax"]
    violations, _, rc, _ = out["port"]
    assert violations == [] and rc == 0
    doc = dhtmon.run_checks(mixed_cluster[nodes], **GATES)[1]
    assert doc["window_source"] == "history"
    assert [n["ready"] for n in doc["nodes"]] == [True] * 3
    assert doc["lookup_success"]["ops"] >= 3
