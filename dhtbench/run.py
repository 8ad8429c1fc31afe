"""Run one cell of the benchmark once.

    python3 -m dhtbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout of the repository.  The cell's file
(``dhtbench/workloads/<cell>.json``) names its configuration
(``dhtbench/configs/<config>.json``), its traffic and the driver
(``dhtbench/drivers/<driver>.py``) that drives ``opendht_tpu_torch``
with it; each metric that ``BENCHMARK.json`` gives the cell is read by
``dhtbench/metrics/<metric>.py``.  A run sets up (counted as
``setup_s``), measures for ``--seconds``, with ``--trace 1`` traces a
few more calls, then checks the answers of the captured calls against the
plain reference and prints one JSON line: the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics.

A run needs the card and exits 2 without one.  ``--cpu`` is the CPU
rehearsal of the harness's tests (sizes from ``--set key=value``): its
line names the CPU and holds no device figure.  ``--control <name>``
runs one of the driver's controls, which the check has to find wrong.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent

#: top-level modules that a run may not load: JAX and the JAX package,
#: and the drivers of the JAX package's benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "opendht_tpu", "benchmarks",
             "chip_smoke", "bench")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole, and the port's own bench."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN
                  or m == "opendht_tpu_torch.bench")


def load(kind: str, name: str):
    """``dhtbench/<kind>/<name>.py`` as a module."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"dhtbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_setting(bench: dict, cell: str, overrides: list) -> tuple:
    """(the cards the cell needs, its file, its parameters: the
    configuration's with the traffic's over them and ``overrides``).  A
    cell with a file but no entry in BENCHMARK.json (one measured but not
    held, ``PERF.md`` §7) takes one card."""
    path = HERE / "workloads" / f"{cell}.json"
    if not path.is_file():
        raise SystemExit(f"no workload {cell!r} in dhtbench/workloads")
    spec = json.loads(path.read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == cell), {})
    params = {**json.loads((HERE / "configs" / f"{spec['config']}.json")
                           .read_text()),
              **spec["traffic"]}
    for item in overrides:
        key, _, value = item.partition("=")
        params[key] = json.loads(value)
    return entry.get("chips", 1), spec, params


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


class Run:
    """What the metric readers read."""

    def __init__(self, params, setup_s, window, trace):
        self.params = params
        self.setup_s = setup_s
        self.window = window
        self.trace = trace


def card(device, torch) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu (rehearsal)", "count": 0,
                "memory_peak_bytes": 0}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "not read"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "power_limit": limit,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


def program_readings() -> dict:
    """The program's telemetry: each counter series by name, and each
    histogram series' ``<name>:count`` and ``<name>:sum``."""
    from opendht_tpu_torch import telemetry
    snap = telemetry.get_registry().snapshot()
    out = dict(snap["counters"])
    for name, h in snap["histograms"].items():
        out[name + ":count"] = h["count"]
        out[name + ":sum"] = h["sum"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="CPU rehearsal: no card, no device figures")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                    help="override a parameter of the cell (rehearsal)")
    ap.add_argument("--control", default=None,
                    help="run a control of the cell's driver")
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips, spec, params = cell_setting(bench, args.workload, args.set)
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    import torch
    if args.cpu:
        device = torch.device("cpu")
        torch.set_num_threads(2)
    else:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            print(f"dhtbench: {args.workload} needs {chips} CUDA "
                  "card(s); none or too few are available", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    print(f"dhtbench: {args.workload} seed {args.seed} on "
          f"{torch.cuda.get_device_name(0) if device.type == 'cuda' else 'cpu'}"
          f", {torch.cuda.device_count()} card(s)", file=sys.stderr)

    from dhtbench.trace import traced
    from dhtbench.window import Window
    driver = load("drivers", spec["driver"]).Driver(
        params, args.seed, device, control=args.control)
    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T_START

    before = program_readings()
    window = Window(capture=True)
    driver.run(window, until=window.start + args.seconds)
    after = program_readings()
    window.program = {k: v - before.get(k, 0) for k, v in after.items()}
    trace = None
    if args.trace:
        trace = traced(driver, Window, warm=params["trace_warm"],
                       calls=params["trace_calls"], device=device)
    device_info = card(device, torch)
    if trace is not None:
        device_info.update(busy_s=trace.busy_s, window_s=trace.window_s)

    run = Run(params, setup_s, window, trace)
    metrics = {}
    for m in metrics_of(bench, args.workload, bool(args.trace)):
        value = load("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, compared = driver.verify()
    check_s = time.perf_counter() - t_check
    correct = bool(window.calls) and all(v <= lim
                                         for v, lim in checks.values())

    bad = forbidden_modules()
    if bad:
        print("dhtbench: modules that a run may not load: " + ", ".join(bad),
              file=sys.stderr)
        return 3

    line = {"correct": correct, "attempted": window.attempted,
            "failed": window.attempted - window.ok, "metrics": metrics,
            "device": device_info}
    if trace is not None:
        line["breakdown"] = trace.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, (v, lim) in checks.items()}
    print(f"dhtbench: {window.attempted} lookups in {len(window.calls)} "
          f"calls over {window.seconds:.3f} s; setup {setup_s:.3f} s; "
          f"card {device_info['kind']}, power limit "
          f"{device_info.get('power_limit', 'not read')}", file=sys.stderr)
    print(f"dhtbench: compared {compared} in {check_s:.3f} s",
          file=sys.stderr)
    for name, (v, lim) in checks.items():
        print(f"check {name} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
