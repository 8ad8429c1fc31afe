"""The check finds what it has to find: each cell's control, and runs with
the timed path broken underneath (a call that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced), rehearsed on the CPU.  The controls at the cells' own sizes
run on the card (``card`` marker)."""

import json
import sys

import numpy as np
import pytest
import torch

from rehearse import ROOT, argv, run_cell

sys.path.insert(0, str(ROOT))
from dhtbench import run as harness  # noqa: E402

SEARCH = "search.mainline10m.wave64k"
RESOLVE = "resolve.node1m.q131k"
SMALL_RESOLVE = "resolve.node1m.q4096"
CHURN = "churn.node1m.e512"

#: (cell, control, sizes at which the control differs from the model)
CONTROLS = [
    (SEARCH, "lut16", {"nodes": 200000, "k": 2, "lut_bits": 20,
                       "wave": 128}),
    (RESOLVE, "rank32", {"nodes": 200000, "batch": 4096}),
    (CHURN, "rank32", {"nodes": 200000, "batch": 4096}),
    (CHURN, "stale_table", {}),
]


@pytest.mark.parametrize("cell,control,sizes", CONTROLS)
def test_control_is_not_correct(cell, control, sizes):
    rc, line, err = run_cell(argv(cell, extra=sizes) + ["--control", control])
    assert rc == 0, err
    assert line["correct"] is False
    assert sum(c["value"] for c in line["checks"].values()) > 0


@pytest.mark.card
@pytest.mark.parametrize("cell,control", [(SEARCH, "lut16"),
                                          (RESOLVE, "rank32"),
                                          (SMALL_RESOLVE, "rank32"),
                                          (CHURN, "stale_table")])
@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12, 2**31 + 13])
def test_control_at_the_cells_size_is_not_correct(card, cell, control, seed):
    rc, line, err = run_cell(["--workload", cell, "--seed", str(seed),
                              "--seconds", "5", "--trace", "0",
                              "--control", control,
                              "--set", "capture_every=8"], timeout=600)
    assert rc == 0, err
    assert line["correct"] is False


# -------------------------------------------------------------- faults
def _run_in_process(cell, capsys, monkeypatch, extra=None):
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    assert harness.main(argv(cell, extra=extra)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _search_fault(kind):
    from opendht_tpu_torch.core import search
    real = search.simulate_lookups

    def broken(sorted_ids, n_valid, targets, **kw):
        if kind == "unchanged":
            # no round runs: the bootstrap's state comes back
            return real(sorted_ids, n_valid, targets, **{**kw, "max_hops": 0})
        if kind == "half":
            half = len(targets) // 2
            out = real(sorted_ids, n_valid, targets[:half], **kw)
            return {k: torch.cat([v, v[:len(targets) - half]])
                    for k, v in out.items()}
        out = real(sorted_ids, n_valid, targets, **kw)
        i = int(targets[0, 0]) % len(targets)
        out["nodes"][i, 0] = (out["nodes"][i, 0] + 1) % n_valid
        return out
    return search, "simulate_lookups", broken


def _resolve_fault(kind):
    from opendht_tpu_torch.core.table import NodeTable, PendingLookup
    real = NodeTable.find_closest_launch
    last = {}

    def broken(self, targets, **kw):
        if kind == "half":
            half = len(targets) // 2
            rows, dist = real(self, targets[:half], **kw).consume()
            fill = len(targets) - half
            return PendingLookup.resolved(np.concatenate([rows, rows[:fill]]),
                                          np.concatenate([dist, dist[:fill]]))
        rows, dist = real(self, targets, **kw).consume()
        if kind == "unchanged":
            prev = last.get("answer", (rows, dist))
            last["answer"] = (rows, dist)
            return PendingLookup.resolved(*prev)
        i = int(targets[0, 0]) % len(targets)
        dist = dist.copy()
        dist[i, 0, 4] ^= 1
        return PendingLookup.resolved(rows, dist)
    return NodeTable, "find_closest_launch", broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell,fault", [(SEARCH, _search_fault),
                                        (RESOLVE, _resolve_fault),
                                        (CHURN, _resolve_fault)])
def test_broken_timed_path_is_not_correct(cell, fault, kind, capsys,
                                          monkeypatch):
    owner, name, broken = fault(kind)
    monkeypatch.setattr(owner, name, broken)
    line = _run_in_process(cell, capsys, monkeypatch)
    assert line["correct"] is False, line["checks"]


def test_sound_path_in_process_is_correct(capsys, monkeypatch):
    line = _run_in_process(RESOLVE, capsys, monkeypatch)
    assert line["correct"] is True
