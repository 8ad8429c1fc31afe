"""``chip_smoke.py``'s hops phase and its two calls of their own
(hops_ladder, soak), rehearsed on the CPU.

``--phases hops,hops_ladder,soak`` at a small size (phases 1-7 at 5,000
ids; a 256-node net for hops, the ladder at 256 and 512 nodes, a 12 s
soak), each phase in its process, in a file of its own beside the other
phase rehearsals.  Each checks what the card run checks, but the card's
own bytes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_chip_smoke_rehearses_the_hop_and_soak_phases_on_the_cpu(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "OPENDHT_TPU_SMOKE_RECORD_DIR": str(tmp_path)}
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--cpu", "--n", "5000",
         "--q", "128", "--phases", "hops,hops_ladder,soak", "--hops-n",
         "256", "--hops-ladder", "512", "--soak-secs", "12"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3, out.stderr[-2000:]
    lines = [json.loads(l) for l in out.stdout.splitlines()
             if l.startswith("{")]
    phases = [l.get("phase") for l in lines]
    assert phases[:-1] == ["device", "main", "parity", "timing", "profile",
                           "memory", "hops", "hops_ladder", "hops_ladder",
                           "soak"]
    kernels = lines[-1]["kernels"]
    assert [k["name"] for k in kernels] == ["window_select",
                                            "lex_topk_select"]
    assert all(k["max_abs_err"] == 0 for k in kernels)
    assert not any("ok" in l for l in lines)

    hops, soak = (lines[phases.index(p)] for p in ("hops", "soak"))
    ladder = [l for l in lines if l.get("phase") == "hops_ladder"]
    for rec, n in ((hops, 256), (ladder[0], 256), (ladder[1], 512)):
        assert rec["n"] == n and rec["lookups"] == 6
        assert rec["every_get_ok"]
        assert sorted(rec["recall"])[3] >= 7
        assert abs(rec["sim"]["p50"] - rec["live_rounds_p50"]) <= 1.0
        assert rec["sim"]["targets"] == 512 and rec["card_mib"] == \
            "not measured"
    # the CPU net's leg runs in the ladder, at the hops phase's size too
    assert hops["cpu_twin"] == "in the hops_ladder call"
    for rec in ladder:
        assert rec["cpu_twin"]["equal"]
        assert rec["cpu_twin"]["hops"] == rec["hops"]
    assert ladder[0]["hops"] == hops["hops"]
    assert hops["search_phase_hops"] == "not run in this call"
    assert hops["launches"] == {"window_select": 0, "lex_topk_select": 0}
    assert soak["secs"] == 12 and soak["puts"] > 0 and soak["gets"] > 0
    assert soak["listen_hits"] > 0 and soak["partials_drained"]
    assert soak["listeners_left"] == 0 and soak["error_records"] == 0
    assert soak["rss_mib"]["growth"] < soak["rss_mib"]["limit"]
    assert soak["sched_heap"]["max"] < soak["sched_heap"]["limit"]
    assert soak["cuda_allocated"] == "not measured"
