"""Every cell, configuration, driver and metric of BENCHMARK.json resolves
by name; every cell rehearses on the CPU against its reference; a cell
added as new files runs without an edit; a run loads nothing of JAX."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from rehearse import ROOT, argv, run_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "dhtbench"
HELD = [w["name"] for w in BENCH["workloads"]]
#: every cell with a file: the held ones and those measured but not held
CELLS = sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def _load(kind, name):
    sys.path.insert(0, str(ROOT))
    try:
        from dhtbench.run import load
        return load(kind, name)
    finally:
        sys.path.remove(str(ROOT))


def test_every_name_resolves_to_its_file():
    for conf in BENCH["configs"]:
        assert conf["file"] == f"dhtbench/configs/{conf['name']}.json"
        data = json.loads((ROOT / conf["file"]).read_text())
        assert data["name"] == conf["name"]
        assert data["source"] == conf["source"]
        assert data["reduced"] == conf["reduced"]
    for cell in BENCH["workloads"]:
        spec = json.loads((HERE / "workloads" / f"{cell['name']}.json")
                          .read_text())
        assert spec["config"] == cell["config"]
        assert spec["why"] == cell["why"]
        assert hasattr(_load("drivers", spec["driver"]), "Driver")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(_load("metrics", m["name"]).read)
        assert set(m.get("workloads", HELD)) <= set(HELD)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        # each cell a per-layer metric lists reports the metric it moves
        for cell in m["workloads"]:
            assert any(cell in e.get("workloads", HELD)
                       for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    configs = {c["name"] for c in BENCH["configs"]}
    assert configs == {w["config"] for w in BENCH["workloads"]}


def test_every_cell_reports_setup_and_a_layer():
    for cell in HELD:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if cell in m.get("workloads", HELD)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in m.get("workloads", HELD)
                   for m in BENCH["per_layer"])


KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_every_entry_has_exactly_the_contracts_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    name = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
    for group, keys in KEYS.items():
        for entry in BENCH[group]:
            extra = {"workloads"} if group in ("end_to_end", "per_layer") \
                else set()
            assert keys <= set(entry) <= keys | extra, (group, entry)
            assert name.fullmatch(entry["name"])
            for text in ("why", "layer", "source"):
                if text in entry and group != "end_to_end":
                    assert 1 <= len(entry[text]) <= 200
                    assert "\n" not in entry[text] and "\t" not in entry[text]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearses_correct_on_the_cpu(cell, trace):
    rc, line, err = run_cell(argv(cell, trace=trace))
    assert rc == 0, err
    assert line["correct"] is True, err
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert err.strip().splitlines()[-1].startswith("check ")
    group = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[group]
            if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= want
    if not trace:
        # host-clock metrics: a CPU rehearsal reads them all
        assert set(line["metrics"]) == want
    else:
        assert "breakdown" in line and line["device"]["window_s"] > 0
    assert line["device"]["platform"] == "cpu"


def test_same_seed_same_inputs():
    sys.path.insert(0, str(ROOT))
    try:
        from dhtbench.reference import inputs
    finally:
        sys.path.remove(str(ROOT))
    seed = 2**31 + 12345
    a, sa = inputs.call_targets(seed, 7, 64)
    b, sb = inputs.call_targets(seed, 7, 64)
    c, _ = inputs.call_targets(seed, 8, 64)
    assert (a == b).all() and sa == sb and not (a == c).all()
    import torch
    d1 = inputs.network_draw(seed, 100, torch.device("cpu"))
    d2 = inputs.network_draw(seed, 100, torch.device("cpu"))
    assert torch.equal(d1, d2)


def _copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "dhtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_a_cell_added_as_new_files_runs(tmp_path):
    root = _copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    name = "resolve.node1m.q4k8"
    (root / "dhtbench" / "workloads" / f"{name}.json").write_text(json.dumps({
        "config": "node1m", "driver": "node_resolve",
        "traffic": {"batch": 4096, "k": 8, "depth": 2, "inserts": 0,
                    "removes": 0, "capture_every": 1, "rows_sample": 16,
                    "warm_calls": 2, "trace_warm": 1, "trace_calls": 3},
        "why": "a test cell"}))
    (root / "dhtbench" / "metrics" / "answers_per_call.py").write_text(
        "def read(run):\n"
        "    w = run.window\n"
        "    return w.attempted / len(w.calls) if w.calls else None\n")
    bench["workloads"].append({"name": name, "config": "node1m",
                               "traffic": "q4k8", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({
        "name": "answers_per_call", "unit": "answers", "better": "higher",
        "source": "host_clock", "layer": "node table",
        "moves": "lookups_per_s", "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {"PYTHONPATH": str(ROOT)}     # the program, from the repository
    rc, line, err = run_cell(argv(name, root=root, trace=1,
                                  extra={"batch": 256}),
                             cwd=root, env=env)
    assert rc == 0, err
    assert line["correct"] is True
    assert line["metrics"]["answers_per_call"]["value"] == 256
    rc, line, err = run_cell(argv(name, root=root, extra={"batch": 256}),
                             cwd=root, env=env)
    assert rc == 0, err
    assert set(line["metrics"]) == {"lookups_per_s", "lookup_p95_ms",
                                    "setup_s"}


def test_without_the_program_no_result(tmp_path):
    root = _copy(tmp_path)
    rc, line, err = run_cell(argv(HELD[0], root=root), cwd=root,
                             env={"PYTHONPATH": ""})
    assert rc != 0 and line is None


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, line, err = run_cell(["--workload", HELD[0], "--seed", "1",
                              "--seconds", "1", "--trace", "0"])
    assert rc == 2 and line is None
    assert "CUDA" in err


def test_forbidden_modules_compare_whole_top_level_names():
    sys.path.insert(0, str(ROOT))
    try:
        from dhtbench.run import forbidden_modules
    finally:
        sys.path.remove(str(ROOT))
    names = {"jax", "jax.numpy", "jaxlib", "flax.linen", "opendht_tpu",
             "opendht_tpu.core.search", "benchmarks.baseline_configs",
             "chip_smoke", "opendht_tpu_torch", "opendht_tpu_torch.core",
             "opendht_tpu_torch.bench", "jaxtyping", "benchmarks_x",
             "bench_util"}
    assert forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib", "flax.linen", "opendht_tpu",
         "opendht_tpu.core.search", "benchmarks.baseline_configs",
         "chip_smoke", "opendht_tpu_torch.bench"])


def test_a_run_loads_no_jax():
    """A run's own process ends with the module check; a run that loaded
    JAX would exit 3 without a result."""
    code = ("import runpy, sys, json\n"
            "sys.argv = ['dhtbench.run'] + json.loads(sys.argv[1])\n"
            "try:\n"
            "    runpy.run_module('dhtbench.run', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'opendht_tpu',\n"
            "              'benchmarks', 'chip_smoke'))\n"
            "print('LOADED', json.dumps(bad))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, json.dumps(argv(HELD[0]))],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = [ln for ln in proc.stdout.splitlines() if ln.startswith("LOADED")]
    assert loaded == ["LOADED []"]


def test_every_metric_file_has_a_reader():
    for path in sorted((HERE / "metrics").glob("*.py")):
        if not path.stem.startswith("_"):
            assert callable(_load("metrics", path.stem).read)


def test_window_select_count_at_the_resolve_shapes():
    counts = _load("metrics", "window_select_roofline").counts
    nbytes, ops = counts(1_000_000, 131072, 16)
    # 15,623 window rows of 3,880 B, all but a few read by 131,072
    # uniform queries, and 580 B a query
    assert 15615 * 3880 + 131072 * 580 < nbytes <= 15623 * 3880 + 131072 * 580
    assert ops == 131072 * (5 * 192 + 10 * 192 + 16 * (10 * 6 + 64))


def test_exact_topk_matches_the_numpy_copy():
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    try:
        from dhtbench.reference.topk import exact_topk, exact_topk_np
    finally:
        sys.path.remove(str(ROOT))
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 2**32, size=(5000, 5), dtype=np.uint32)
    ids[100:110, :2] = ids[99, :2]          # ties on the top 64 bits
    targets = rng.integers(0, 2**32, size=(300, 5), dtype=np.uint32)
    targets[:10] = ids[100:110] ^ np.uint32(1)
    want = exact_topk_np(ids, targets, 16)
    assert (exact_topk(ids, targets, 16, torch.device("cpu"),
                       block_elems=4096) == want).all()
