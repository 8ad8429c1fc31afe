"""The per-layer metrics that read the program's own spans and counters
report a number in a traced CPU rehearsal of every cell that lists them."""

import json

import pytest

from rehearse import ROOT, argv, run_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM = [m for m in BENCH["per_layer"]
           if m["source"] in ("program_span", "program_counter")]
CELLS = sorted({c for m in PROGRAM
                for c in m.get("workloads",
                               [w["name"] for w in BENCH["workloads"]])})


@pytest.mark.parametrize("cell", CELLS)
def test_traced_rehearsal_reads_every_program_metric(cell):
    rc, line, err = run_cell(argv(cell, trace=1))
    assert rc == 0, err
    assert line["correct"] is True, err
    want = {m["name"] for m in PROGRAM
            if cell in m.get("workloads", [cell])}
    assert want <= set(line["metrics"]), want - set(line["metrics"])
    assert all(line["metrics"][m]["value"] is not None for m in want)
