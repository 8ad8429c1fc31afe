"""The port stands alone: importing every module of ``opendht_tpu_torch``
pulls in neither JAX, ``opendht_tpu`` nor the ``msgpack`` wheel (the port
carries its own codec), and every module but ``crypto`` leaves out
``cryptography`` and ``argon2``; nor does a node whose planes (keyspace
sketch, hot-value cache, listener table) are at work; a signed put through the port's
``SecureDht`` loads no JAX module; its entry points called with
``device=None`` on a machine without a card raise instead of running on
the CPU, and ``chip_smoke.py`` fails without a card and rehearses every
phase on the CPU without claiming a chip run."""

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
                "ops.cache_probe", "ops.listener_match"):
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
        "DhtRunner.run": lambda: opendht_tpu_torch.DhtRunner().run(0),
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


def _chip_smoke(*args):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    out = _chip_smoke()
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_rehearses_every_phase_on_the_cpu():
    out = _chip_smoke("--cpu", "--n", "5000", "--q", "128",
                      "--search-n", "20000", "--search-q", "256",
                      "--search-waves", "2", "--churn-n", "20000",
                      "--churn-q", "256", "--churn-dcap", "2048",
                      "--churn-e", "64", "--churn-table-n", "20000",
                      "--serve-n", "8192", "--serve-q", "16",
                      "--serve-gets", "100", "--planes-keys", "200",
                      "--planes-gets", "600")
    assert out.returncode == 3, out.stderr[-2000:]
    lines = [json.loads(l) for l in out.stdout.splitlines()
             if l.startswith("{")]
    phases = [l.get("phase") for l in lines]
    assert phases[:-1] == ["device", "main", "parity", "timing", "profile",
                           "memory", "search", "maintenance", "churn",
                           "serve", "runner", "planes"]
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
    kernels = lines[-1]["kernels"]
    assert [k["name"] for k in kernels] == ["window_select",
                                            "lex_topk_select"]
    assert all(k["max_abs_err"] == 0 for k in kernels)
    assert not any("ok" in l for l in lines)
