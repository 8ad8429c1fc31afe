"""The port stands alone: importing every module of ``opendht_tpu_torch``
pulls in neither JAX, ``opendht_tpu`` nor the ``msgpack`` wheel (the port
carries its own codec), its entry points called with
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
                "runtime.wave_builder", "runtime.live_search", "waterfall"):
        assert f"opendht_tpu_torch.{mod}" in want


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
                      "--serve-gets", "100")
    assert out.returncode == 3, out.stderr[-2000:]
    lines = [json.loads(l) for l in out.stdout.splitlines()
             if l.startswith("{")]
    phases = [l.get("phase") for l in lines]
    assert phases[:-1] == ["device", "main", "parity", "timing", "profile",
                           "memory", "search", "maintenance", "churn",
                           "serve"]
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
    kernels = lines[-1]["kernels"]
    assert [k["name"] for k in kernels] == ["window_select",
                                            "lex_topk_select"]
    assert all(k["max_abs_err"] == 0 for k in kernels)
    assert not any("ok" in l for l in lines)
