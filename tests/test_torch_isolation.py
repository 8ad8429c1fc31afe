"""The port stands alone: importing every module of ``opendht_tpu_torch``
pulls in neither JAX, ``opendht_tpu`` nor the ``msgpack`` wheel (the port
carries its own codec), and every module but ``crypto`` leaves out
``cryptography`` and ``argon2``; nor does a node whose planes (keyspace
sketch, hot-value cache, listener table) are at work; a signed put through the port's
``SecureDht`` loads no JAX module; its entry points called with
``device=None`` on a machine without a card raise instead of running on
the CPU (the tools' ``setup_node`` without ``--cpu`` among them); the
periphery (a REST proxy server and client, a PHT over the port's
``VirtualNet``, the dhtnode REPL) loads no JAX module; nor does
``dhtmon.run_checks`` over a ``DhtNetwork`` with its coverage probe; and
``chip_smoke.py`` fails without a card and rehearses every phase on the
CPU, the proxy and monitor phases included, without claiming a chip
run."""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import opendht_tpu_torch
from opendht_tpu_torch import convert
from opendht_tpu_torch.core.search import simulate_lookups
from opendht_tpu_torch.core.table import NodeTable
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.ops import ids as TK
from opendht_tpu_torch.ops import radix
from opendht_tpu_torch import bench, chaos, profiling, telemetry
from opendht_tpu_torch.ops import swarm
from opendht_tpu_torch.parallel import make_mesh
from opendht_tpu_torch.testing import (DhtNetwork, VirtualNet, benchmark,
                                       dhtcluster, http_server,
                                       network_monitor, pingpong, scanner,
                                       subproc_cluster, telemetry_smoke)
from opendht_tpu_torch.tools.common import make_arg_parser, setup_node
from opendht_tpu_torch.waterfall import OpenBoundTracker

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import opendht_tpu_torch
names = [m.name for m in pkgutil.walk_packages(opendht_tpu_torch.__path__,
                                               "opendht_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "opendht_tpu",
                                    "msgpack"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_importing_the_port_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    want = {m.name for m in pkgutil.walk_packages(
        opendht_tpu_torch.__path__, "opendht_tpu_torch.")}
    assert set(res["modules"]) == want
    assert "opendht_tpu_torch.ops.window_select" in want
    for mod in ("_msgpack", "utils", "net.engine", "runtime.dht",
                "runtime.wave_builder", "runtime.live_search", "waterfall",
                "keyspace", "hotcache", "listeners", "chaos", "ops.sketch",
                "ops.cache_probe", "ops.listener_match", "parallel",
                "parallel.partition", "parallel.sharded", "reshard",
                "profiling", "perf_gate", "bench", "ops.swarm", "proxy",
                "proxy.server", "proxy.client", "proxy.json_codec",
                "proxy.push", "indexation", "indexation.pht", "testing",
                "testing.virtual_net", "testing.trace_assembler", "tools",
                "tools.common", "tools.dhtnode", "tools.dhtchat",
                "tools.dhtscanner", "tools.compat_check",
                "testing.telemetry_smoke", "testing.health_monitor",
                "testing.timeline_assembler", "testing.wiremap_assembler",
                "testing.network", "testing.scenarios", "testing.benchmark",
                "testing.pingpong", "tools.dhtmon", "testing.dhtcluster",
                "testing.subproc_cluster", "testing.netns_net",
                "testing.scanner", "testing.http_server",
                "testing.network_monitor"):
        assert f"opendht_tpu_torch.{mod}" in want


_PLANES_PROBE = """
import json, sys
from opendht_tpu_torch.core.value import Value
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.runtime import Config, Dht
from opendht_tpu_torch.scheduler import Scheduler
from opendht_tpu_torch.sockaddr import SockAddr
clock = [0.0]
dht = Dht(lambda d, a: 0, Config(), Scheduler(clock=lambda: clock[0]),
          has_v6=False, device="cpu")
for i in range(12):
    dht.insert_node(InfoHash.get("peer-%d" % i),
                    SockAddr("127.0.0.2", 4000 + i))
key = InfoHash.get("planes-probe")
heard = []
dht.listen(key, lambda vals, exp: heard.extend(vals) or True)
dht.storage_store(key, Value(b"v", value_id=1), 0.0)
for _ in range(60):
    dht.get(key, lambda vals: True)
    clock[0] += 0.05
    dht.periodic(None, None)
print(json.dumps({
    "heard": len(heard),
    "observed": dht.keyspace.snapshot()["observed_total"],
    "cached": dht.hotcache.snapshot()["occupancy"],
    "listeners": dht.listener_table.snapshot()["matches"],
    "bad": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "opendht_tpu",
                                         "msgpack", "cryptography",
                                         "argon2"))}))
"""


def test_a_node_with_its_planes_at_work_loads_no_jax_module():
    """A default node whose keyspace sketch, hot-value cache and listener
    table all run loads neither JAX, ``opendht_tpu`` nor the crypto
    wheels."""
    out = subprocess.run([sys.executable, "-c", _PLANES_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["heard"] == 1 and res["listeners"] == 1
    assert res["observed"] > 0 and res["cached"] == 1


_SCALE_PROBE = """
import json, sys
import numpy as np
from opendht_tpu_torch import parallel, reshard
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.runtime import Config, Dht
from opendht_tpu_torch.scheduler import Scheduler
from opendht_tpu_torch.sockaddr import SockAddr
rng = np.random.default_rng(0)
ids = rng.integers(0, 2 ** 32, size=(512, 5), dtype=np.uint32)
q = rng.integers(0, 2 ** 32, size=(16, 5), dtype=np.uint32)
mesh = parallel.make_mesh(4, q=2, t=2, devices="cpu")
d, i = parallel.sharded_lookup(mesh, q, ids, k=8, window=32)
s = ids[np.lexsort(ids.T[::-1])]
out = parallel.tp_simulate_lookups(mesh, s, 512, q, seed=1)
clock = [0.0]
dht = Dht(lambda d, a: 0, Config(resolve_mesh_t=4),
          Scheduler(clock=lambda: clock[0]), has_v6=False, device="cpu")
dht.tables[2].bulk_load(rng.integers(0, 2 ** 32, size=(5000, 5),
                                     dtype=np.uint32), 0.0,
                        addrs=SockAddr("127.0.0.2", 4000))
res = dht.find_closest_nodes_batched([InfoHash.get_random()
                                      for _ in range(100)], 2, 8)
for _ in range(30):
    clock[0] += 1.0
    dht.periodic(None, None)
print(json.dumps({
    "rows": int((i >= 0).sum()), "hops": int(out["hops"].max()),
    "shard_t": dht.last_resolve_shard_t, "answers": len(res),
    "ticks": dht.reshard.snapshot()["ticks"],
    "bad": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "opendht_tpu",
                                         "msgpack"))}))
"""


def test_scale_out_and_the_resharder_load_no_jax_module():
    """The ``parallel`` package (a sharded lookup and the table-parallel
    engine on a virtual CPU mesh) and ``reshard.py`` (a node with
    ``resolve_mesh_t=4`` serving a batched resolve through the sharded
    snapshot while its resharder ticks) load neither JAX nor
    ``opendht_tpu``."""
    out = subprocess.run([sys.executable, "-c", _SCALE_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["rows"] == 16 * 8 and res["hops"] > 0
    assert res["shard_t"] == 4 and res["answers"] == 100
    assert res["ticks"] >= 5


_NO_CRYPTO_PROBE = """
import importlib, json, pkgutil, sys
import opendht_tpu_torch
names = [m.name for m in pkgutil.walk_packages(opendht_tpu_torch.__path__,
                                               "opendht_tpu_torch.")
         if m.name != "opendht_tpu_torch.crypto"]
for n in names:
    importlib.import_module(n)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("cryptography", "argon2"))))
"""


def test_only_crypto_imports_the_crypto_wheels():
    out = subprocess.run([sys.executable, "-c", _NO_CRYPTO_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    for path in (REPO / "opendht_tpu_torch").rglob("*.py"):
        if path.name == "crypto.py":
            continue
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import cryptography",
                                     "from cryptography",
                                     "import argon2", "from argon2")), path


_SIGNED_PUT_PROBE = """
import json, sys
from opendht_tpu_torch import crypto
from opendht_tpu_torch.core.value import Value
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.runtime import Config, Dht, SecureDht
from opendht_tpu_torch.runtime.secure_dht import secure_node_id
from opendht_tpu_torch.scheduler import Scheduler
clock = [0.0]
ident = crypto.generate_identity("probe", key_length=1024)
dht = Dht(lambda d, a: 0, Config(node_id=secure_node_id(ident.second)),
          Scheduler(clock=lambda: clock[0]), has_v6=False, device="cpu")
sd = SecureDht(dht, ident)
v = Value(b"signed in the port")
done = []
sd.put_signed(InfoHash.get("probe-key"), v, lambda ok, ns: done.append(ok))
while not done and clock[0] < 120:
    clock[0] += 0.5
    dht.periodic(None, None)
print(json.dumps({"signed": v.is_signed() and v.check_signature(),
                  "done": len(done),
                  "crypto": "cryptography" in sys.modules,
                  "bad": sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib",
                                                       "opendht_tpu"))}))
"""


def test_a_signed_put_loads_no_jax_module():
    """The secure layer reaches the port's own crypto module, never the
    JAX package's (``lazy_module("opendht_tpu_torch.crypto")``)."""
    out = subprocess.run([sys.executable, "-c", _SIGNED_PUT_PROBE],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=180, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"signed": True, "done": 1, "crypto": True, "bad": []}


_PERIPHERY_PROBE = """
import builtins, contextlib, io, json, sys
from opendht_tpu_torch.core.value import Value
from opendht_tpu_torch.indexation.pht import Pht
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.proxy import DhtProxyClient, DhtProxyServer
from opendht_tpu_torch.runtime import Config, DhtRunner
from opendht_tpu_torch.testing import VirtualNet
from opendht_tpu_torch.tools.dhtnode import cmd_loop
a, b = DhtRunner(), DhtRunner()
a.run(0, device="cpu")
b.run(0, device="cpu")
b.bootstrap("127.0.0.1", a.get_bound_port())
server = DhtProxyServer(b, port=0)
client = DhtProxyClient("127.0.0.1", server.port)
key = InfoHash.get("periphery-probe")
put = a.put_sync(key, Value(b"v", value_id=3), timeout=60)
got = [v.data for v in client.get_sync(key, timeout=60)]
script = iter(["p repl-probe from the repl", "g repl-probe", "x"])
builtins.input = lambda prompt="": next(script)
out = io.StringIO()
with contextlib.redirect_stdout(out):
    cmd_loop(b, None)
client.join(); server.stop(); a.join(); b.join()
net = VirtualNet(device="cpu")
nodes = [net.add_node(Config(max_req_per_sec=100000), host="127.0.0.%d" % i)
         for i in (1, 2, 3)]
net.bootstrap_all(nodes[0])
net.run(90, net.all_connected)
pht, done = Pht("probe", {"k": 2}, nodes[0]), {}
pht.insert({"k": b"ab"}, (InfoHash.get("x"), 1), lambda ok: done.update(i=ok))
net.run(120, lambda: "i" in done)
pht.lookup({"k": b"ab"}, lambda vals, p: done.update(v=len(vals)),
           lambda ok: done.update(l=ok))
net.run(120, lambda: "l" in done)
print(json.dumps({
    "put": put, "got": [g.decode() for g in got],
    "repl": "Put: True" in out.getvalue()
            and "from the repl" in out.getvalue(),
    "pht": [done.get("i"), done.get("l"), done.get("v")],
    "bad": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "opendht_tpu"))}))
"""


def test_the_periphery_loads_no_jax_module():
    """A proxy server and client over two port runners, the dhtnode
    REPL's ``cmd_loop`` and a ``Pht`` over the port's ``VirtualNet``
    load neither JAX nor ``opendht_tpu``."""
    out = subprocess.run([sys.executable, "-c", _PERIPHERY_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=240,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"put": True, "got": ["v"], "repl": True,
                   "pht": [True, True, 1], "bad": []}


_MONITOR_PROBE = """
import json, sys
from opendht_tpu_torch.core.value import Value
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.proxy import DhtProxyServer
from opendht_tpu_torch.runtime import Config
from opendht_tpu_torch.testing import DhtNetwork
from opendht_tpu_torch.testing import timeline_assembler, wiremap_assembler
from opendht_tpu_torch.tools import dhtmon
net = DhtNetwork(4, config=Config(max_req_per_sec=100000), device="cpu")
servers = [DhtProxyServer(r, port=0) for r in net.nodes]
try:
    connected = net.wait_connected(120)
    net.put(InfoHash.get("monitor-probe-warm"), Value(b"w"), timeout=60)
    put = net.put(InfoHash.get("monitor-probe"), Value(b"v"), timeout=60)
    eps = ["127.0.0.1:%d" % s.port for s in servers]
    violations, doc = dhtmon.run_checks(eps, runners=net.nodes,
                                        require_ready=True, device="cpu")
    wm = wiremap_assembler.assemble_wiremap(
        [wiremap_assembler.scrape_peers(ep) for ep in eps])
    tl = timeline_assembler.assemble_timeline(
        [r.dump_bundle() for r in net.nodes])
finally:
    for s in servers:
        s.stop()
    net.shutdown()
print(json.dumps({
    "connected": connected, "put": put, "violations": violations,
    "keys": doc["replica_coverage"]["keys"], "nodes": len(wm["nodes"]),
    "timeline": len(tl["nodes"]),
    "bad": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "opendht_tpu",
                                         "msgpack"))}))
"""


def test_dhtmon_over_a_dhtnetwork_loads_no_jax_module():
    """``dhtmon.run_checks`` with its coverage probe over a
    ``device="cpu"`` ``DhtNetwork`` behind REST proxies, and both
    assemblers over it, load neither JAX nor ``opendht_tpu``."""
    out = subprocess.run([sys.executable, "-c", _MONITOR_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=240,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"connected": True, "put": True, "violations": [],
                   "keys": 2, "nodes": 4, "timeline": 4, "bad": []}


def test_port_sources_name_no_jax_import():
    for path in (REPO / "opendht_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), path
            assert not s.startswith(("import opendht_tpu ",
                                     "from opendht_tpu ",
                                     "from opendht_tpu.",
                                     "import opendht_tpu.")), path
            assert not s.startswith(("import msgpack", "from msgpack")), \
                path


def _entry_points():
    ids = np.zeros((4, 5), np.uint32)
    state = {"ids": ids, "valid": np.ones(4, bool),
             "expired": np.zeros(4, bool), "time_reply": np.zeros(4),
             "time_seen": np.zeros(4), "auth_err": np.zeros(4, np.int8),
             "bucket": np.zeros(4, np.int16),
             "bucket_count": np.zeros(160, np.int32)}
    return {
        "NodeTable": lambda: NodeTable(InfoHash.get("me")),
        "node_table_from_numpy": lambda: convert.node_table_from_numpy(
            bytes(20), state),
        "snapshot_from_numpy": lambda: convert.snapshot_from_numpy(
            ids, np.arange(4, dtype=np.int32), 4),
        "to_keys": lambda: TK.to_keys(ids),
        "resolve_device": lambda: opendht_tpu_torch.resolve_device(None),
        "simulate_lookups": lambda: simulate_lookups(ids, 4, ids[:1]),
        "maintenance_sweep": lambda: radix.maintenance_sweep(
            ids[0], ids, np.ones(4, bool), np.zeros(4), 0.0, 600.0),
        "NodeTable.maintenance_sweep": lambda: NodeTable(
            InfoHash.get("me")).maintenance_sweep(0.0),
        "NodeTable.stale_buckets": lambda: NodeTable(
            InfoHash.get("me")).stale_buckets(0.0),
        "NodeTable.refresh_targets": lambda: NodeTable(
            InfoHash.get("me")).refresh_targets([0]),
        "NodeTable.network_size_estimate": lambda: NodeTable(
            InfoHash.get("me")).network_size_estimate(),
        "Dht": lambda: opendht_tpu_torch.Dht(lambda data, addr: 0),
        "make_mesh": lambda: make_mesh(2),
        "DhtRunner.run": lambda: opendht_tpu_torch.DhtRunner().run(0),
        "SwarmSim": lambda: swarm.SwarmSim(chaos.FaultPlan([]), n_nodes=16,
                                           n_keys=4),
        "swarm.state_to_device": lambda: swarm.state_to_device(
            swarm.init_swarm(1, 16, 4)),
        "KernelLedger.compute": lambda: profiling.KernelLedger().compute(
            ["cache_probe"]),
        "KernelLedger.measure": lambda: profiling.KernelLedger().measure(
            ["cache_probe"]),
        "bench.measure": lambda: bench.measure(),
        "OpenBoundTracker": lambda: OpenBoundTracker(
            reg=telemetry.MetricsRegistry()),
        "tools.setup_node": lambda: setup_node(
            make_arg_parser("t").parse_args([])),
        "VirtualNet": lambda: VirtualNet(),
        "DhtNetwork": lambda: DhtNetwork(1),
        "benchmark.main": lambda: benchmark.main(["-t", "delete", "-n",
                                                  "4"]),
        "pingpong.main": lambda: pingpong.main(["-n", "1"]),
        "telemetry_smoke.main": lambda: telemetry_smoke.main([]),
        "NodeCluster": lambda: dhtcluster.NodeCluster(),
        "ClusterSubProcess": lambda: subproc_cluster.ClusterSubProcess(1),
        "network_monitor.Monitor": lambda: network_monitor.Monitor(
            None, 1, 1.0),
        "dhtcluster.main": lambda: dhtcluster.main(["-n", "1", "-s"]),
        "scanner.main": lambda: scanner.main(["--local", "1"]),
        "http_server.main": lambda: http_server.main(["-hp", "0"]),
        "network_monitor.main": lambda: network_monitor.main(
            ["--local", "--rounds", "1"]),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda_and_raise_without_it(name,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_entry_points_run_on_the_cpu_when_asked():
    t = NodeTable(InfoHash.get("me"), device="cpu")
    assert t.device == torch.device("cpu")
    assert TK.to_keys(np.zeros((1, 5), np.uint32), "cpu").device.type == "cpu"
    ids = np.random.default_rng(0).integers(0, 2**32, (64, 5), np.uint32)
    ids = ids[np.lexsort(ids.T[::-1])]
    out = simulate_lookups(ids, 64, ids[:3], device="cpu")
    assert out["nodes"].device.type == "cpu"
    _, _, stale, _ = radix.maintenance_sweep(
        ids[0], ids, np.ones(64, bool), np.zeros(64), 0.0, 600.0,
        device="cpu")
    assert stale.device.type == "cpu"
    t.bulk_load(ids, now=0.0)
    assert t.maintenance_sweep(1.0)[0].size == len(t.stale_buckets(1.0))


_CHILD_FRAMES = """
import msgpack, sys
sys.stdout.buffer.write(b"".join(msgpack.packb(r, use_bin_type=True) for r in
                                 ({"op": "launch", "n": 1}, {"op": "quit"})))
"""


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_cluster_child_loads_no_jax_module(device):
    """A subprocess-cluster child, card-default (which here answers
    "no CUDA device") or on the CPU (which starts a node), run under
    ``-X importtime``: no JAX, ``opendht_tpu`` or ``msgpack`` module."""
    frames = subprocess.run([sys.executable, "-c", _CHILD_FRAMES],
                            capture_output=True, timeout=60,
                            check=True).stdout
    argv = subproc_cluster.child_argv(device)
    out = subprocess.run([argv[0], "-X", "importtime", *argv[1:]],
                         input=frames, capture_output=True, timeout=120,
                         env=subproc_cluster.child_env(), check=True)
    from opendht_tpu_torch import _msgpack
    up = _msgpack.Unpacker(raw=True)
    up.feed(out.stdout)
    launch, quit_ = list(up)
    assert quit_ == {b"ok": True}
    if device == "cuda":
        assert not launch[b"ok"] and b"no CUDA device" in launch[b"error"]
    else:
        assert launch[b"ok"] and len(launch[b"ports"]) == 1
    mods = [l.split("|")[-1].strip() for l in
            out.stderr.decode().splitlines() if l.startswith("import time:")]
    assert "torch" in mods
    assert "opendht_tpu_torch.testing.dhtcluster" in mods
    assert not [m for m in mods if m.split(".")[0] in
                ("jax", "jaxlib", "opendht_tpu", "msgpack")]


def _chip_smoke(*args, records=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    if records is not None:
        env["OPENDHT_TPU_SMOKE_RECORD_DIR"] = str(records)
    return subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    out = _chip_smoke()
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_rehearses_every_phase_on_the_cpu(tmp_path):
    out = _chip_smoke("--cpu", "--n", "5000", "--q", "128",
                      "--search-n", "20000", "--search-q", "256",
                      "--search-waves", "2", "--churn-n", "20000",
                      "--churn-q", "256", "--churn-dcap", "2048",
                      "--churn-e", "64", "--churn-table-n", "20000",
                      "--serve-n", "8192", "--serve-q", "16",
                      "--serve-gets", "100", "--planes-keys", "200",
                      "--planes-gets", "600", "--scale-n", "20000",
                      "--scale-q", "256", "--swarm-n", "2048",
                      "--proxy-keys", "64", "--pht-entries", "17",
                      "--monitor-runners", "8", "--monitor-keys", "128",
                      # every phase but cluster, which
                      # tests/test_torch_cluster_phase.py rehearses
                      "--phases", "search,maintenance,churn,serve,runner,"
                      "proxy,monitor,planes,scale,ledger,swarm,bench",
                      records=tmp_path)
    assert out.returncode == 3, out.stderr[-2000:]
    lines = [json.loads(l) for l in out.stdout.splitlines()
             if l.startswith("{")]
    phases = [l.get("phase") for l in lines]
    assert phases[:-1] == ["device", "main", "parity", "timing", "profile",
                           "memory", "search", "maintenance", "churn",
                           "serve", "runner", "proxy", "monitor", "planes",
                           "scale",
                           "ledger",
                           "ledger_q1_split", "swarm", "swarm_oracle",
                           "bench", "timing_gate"]
    # the records perf_gate's soft checks read
    assert {"bench.json", "ledger.json", "swarm_storm.json"} <= {
        p.name for p in tmp_path.iterdir()}
    search = lines[phases.index("search")]
    assert search["lookups"] == 2 * 256
    assert search["checks"]["goldens"] == ["lut_l5", "lut_l2", "exact_l5"]
    assert search["checks"]["recall"] >= 0.95
    churn = lines[phases.index("churn")]
    assert churn["checks"]["tomb_heavy_rows"] == 64
    assert churn["table"]["swaps"] >= 1
    assert churn["sustained_lookups_per_s"] > 0
    serve = lines[phases.index("serve")]
    assert serve["config1"]["gets"] == 100
    assert serve["config1"]["routes"]["snapshot"] == serve["config1"]["waves"]
    assert serve["live_node"]["first_half"]["routes"]["snapshot"] >= 8
    assert serve["live_node"]["second_half"]["routes"]["churn"] >= 8
    assert serve["batched_resolve"]["routes"] == {"snapshot": 1, "churn": 0}
    assert serve["ingest_wave_failures"] == 0
    assert serve["error_records"] == 0
    runner = lines[phases.index("runner")]
    assert runner["native_engine"] and runner["load"]["rows"] == 8192
    assert runner["load"]["thread"] == "dht"
    assert runner["burst"]["exact"] == 16
    assert runner["burst"]["routes"]["snapshot"] >= 16
    assert runner["churn"]["exact"] == 8
    assert runner["churn"]["routes"]["churn"] >= 8
    assert runner["across_compaction"]["exact"] == 8
    assert runner["cluster"]["values"] == 64
    assert runner["cluster"]["listen"] == "heard"
    assert (runner["error_records"], runner["delay_drops"],
            runner["ingest_wave_failures"]) == (0, 0, 0)
    assert runner["datagrams_sent"]["off_loopback"] == 0
    assert runner["crypto_modules"] == runner["live_runner_threads"] == []
    proxy = lines[phases.index("proxy")]
    assert proxy["rows"] == 8192 and proxy["rest"]["equal_to_direct_get"] == 64
    assert proxy["rest"]["listen_streams"] == {"streams": 16, "values_each": 2}
    assert proxy["rest"]["open_bounds"] == {"platform": "cpu",
                                            "status": "unsettled"}
    assert proxy["rest"]["kernel_gauges"] > 0
    assert proxy["swap"]["puts_heard_once"] == 3
    assert proxy["pht"]["entries"] == proxy["pht"]["exact_lookups"] == 17
    assert proxy["dhtnode"] == {**proxy["dhtnode"], "device": "cpu",
                                "kernels_named": 16, "jax_modules": []}
    assert proxy["farm"]["errors"] == 0 and proxy["farm"]["requests"] > 0
    assert (proxy["error_records"], proxy["ingest_wave_failures"]) == (0, 0)
    assert proxy["datagrams_sent"]["off_loopback"] == 0
    assert proxy["live_threads"] == []
    monitor = lines[phases.index("monitor")]
    assert (monitor["runners"], monitor["keys"]) == (8, 128)
    assert monitor["traffic"]["equal_gets"] == 32
    assert monitor["dhtmon"]["keys"] == 128
    assert monitor["dhtmon"]["closest8_equal_numpy"] == 128
    assert monitor["timeline"]["nodes"] == 8
    assert monitor["timeline"]["violations"] == []
    assert monitor["removal"]["nodes"] == 6
    for child in ("dhtmon_cli", "benchmark", "pingpong"):
        assert monitor[child]["jax_modules"] == [], child
    assert monitor["benchmark"]["doc"]["count"] == 16
    assert monitor["error_records"] == 0 and monitor["live_threads"] == []
    planes = lines[phases.index("planes")]
    assert planes["puts"]["keys"] == 200
    assert planes["gets"]["gets"] == 600
    assert planes["gets"]["cache"]["hits"] > 0
    assert planes["gets"]["sketch"]["equal_to_numpy"]
    assert planes["gets"]["cache_off_replay"]["equal"]
    assert planes["listeners"]["overflow"] == 64
    assert planes["listeners"]["listener_match_calls"] >= 1
    assert all(planes["planes_enabled"].values())
    assert (planes["error_records"], planes["planes_dark_records"],
            planes["ingest_wave_failures"]) == (0, 0, 0)
    assert set(planes["ops"]) == {
        "listener_match_S64_L1024", "listener_match_S64_L8192",
        "cache_probe_Q64_C64", "sketch_update_Q64", "sketch_query_Q64",
        "sketch_decay"}
    scale = lines[phases.index("scale")]
    assert scale["config5"]["sample"] == 256
    assert set(scale["virtual_mesh"]) >= {"2", "4", "8"}
    assert scale["tp_engine"]["t"] == 4
    assert scale["node_layout"]["q"] == 256
    assert scale["reshard_tick"]["result"]["mode"] == "virtual"
    ledger = lines[phases.index("ledger")]
    assert len(ledger["specs"]) == 16 and ledger["gate_failures"] == []
    split = lines[phases.index("ledger_q1_split")]
    assert split["churn"]["dispatched_ops_per_call"] > \
        split["snapshot"]["dispatched_ops_per_call"] > 0
    swarm = lines[phases.index("swarm")]
    assert swarm["nodes"] == 2048 and len(swarm["strip"]) == 22
    assert swarm["strip"][-1]["verdict"] == "healthy"
    assert lines[phases.index("swarm_oracle")]["equal"]
    bench = lines[phases.index("bench")]
    assert bench["exact"] and bench["N"] == 5000 and bench["Q"] == 128
    kernels = lines[-1]["kernels"]
    assert [k["name"] for k in kernels] == ["window_select",
                                            "lex_topk_select"]
    assert all(k["max_abs_err"] == 0 for k in kernels)
    assert not any("ok" in l for l in lines)
