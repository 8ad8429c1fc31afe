"""Small sizes at which the tests rehearse each cell on the CPU, and a
helper that runs the harness and reads its line."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: per driver: the ``--set`` overrides of a CPU rehearsal
SMALL = {
    "search_waves": {"nodes": 20000, "wave": 256, "lut_bits": 16,
                     "capture_every": 1},
    "node_resolve": {"nodes": 20000, "batch": 512, "capture_every": 1},
}


def driver_of(cell: str, root: Path = ROOT) -> str:
    spec = json.loads((root / "dhtbench" / "workloads" / f"{cell}.json")
                      .read_text())
    return spec["driver"]


def argv(cell: str, *, seed: int = 3000000001, seconds: float = 1.0,
         trace: int = 0, extra=None, root: Path = ROOT) -> list:
    sets = {**SMALL[driver_of(cell, root)], **(extra or {})}
    out = ["--workload", cell, "--seed", str(seed), "--seconds",
           str(seconds), "--trace", str(trace), "--cpu"]
    for k, v in sets.items():
        out += ["--set", f"{k}={json.dumps(v)}"]
    return out


def run_cell(args: list, *, cwd: Path = ROOT, env=None, timeout=300):
    """(exit code, the last stdout line as JSON or None, stderr)."""
    proc = subprocess.run([sys.executable, "-m", "dhtbench.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout,
                          env={**os.environ, **(env or {})})
    lines = proc.stdout.strip().splitlines()
    line = None
    if lines:
        try:
            line = json.loads(lines[-1])
        except json.JSONDecodeError:
            line = None
    return proc.returncode, line, proc.stderr
