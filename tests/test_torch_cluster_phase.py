"""``chip_smoke.py``'s cluster phase, rehearsed on the CPU.

``--phases cluster`` at a small size (phases 1-7 at 5,000 ids, then two
subprocess children of four nodes and 72 keys) in a file of its own, so
that a run under ``-n 6 --dist loadfile`` gives it a worker of its own
beside tests/test_torch_isolation.py's rehearsal of the other phases.
It checks what the card run checks: every get equal to its put, the
crawl equal to the children's ids (and the parent, if it found it), the
census's closest-8 lists equal to numpy through the device route, the
killed child's keys got back, the monitor's exit code and rounds, the
HTTP round trip, the netns leg where namespaces can be made, no JAX
library in any child, no ERROR record and no thread left.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_chip_smoke_rehearses_the_cluster_phase_on_the_cpu(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "OPENDHT_TPU_SMOKE_RECORD_DIR": str(tmp_path)}
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--cpu", "--n", "5000",
         "--q", "128", "--phases", "cluster", "--cluster-children", "2",
         "--cluster-nodes", "4", "--cluster-keys", "72"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 3, out.stderr[-2000:]
    lines = [json.loads(l) for l in out.stdout.splitlines()
             if l.startswith("{")]
    phases = [l.get("phase") for l in lines]
    assert phases[:-1] == ["device", "main", "parity", "timing", "profile",
                           "memory", "cluster"]
    c = lines[phases.index("cluster")]
    assert (c["children_n"], c["nodes_per_child"], c["keys"]) == (2, 4, 72)
    assert [ch["nodes"] for ch in c["children"]] == [4, 4]
    assert all(ch["jax_libraries"] == [] for ch in c["children"])
    assert c["traffic"]["stored"] == c["traffic"]["equal_gets"] == 72
    crawl = c["crawl"]
    assert crawl["ids"] == 8 and crawl["extra"] == 0
    assert crawl["missing"] == 0 and crawl["found"] in (8, 9)
    assert c["census"] == {**c["census"], "ids": 9, "keys": 72,
                           "closest8_equal_numpy": 72, "route": "snapshot"}
    assert c["kill"]["keys"] == c["kill"]["got_back"] == 36
    assert c["monitor"]["rc"] == 0 and len(c["monitor"]["rounds"]) == 2
    assert c["http"]["post"] == {"success": True} and c["http"]["equal"]
    assert c["netns"] == "unavailable" or c["netns"]["equal"]
    assert c["shutdown"]["graceful"] == 1
    assert c["children_exited"] == [-9, 0]
    assert c["error_records"] == 0 and c["live_threads"] == []
    kernels = lines[-1]["kernels"]
    assert [k["name"] for k in kernels] == ["window_select",
                                            "lex_topk_select"]
    assert all(k["max_abs_err"] == 0 for k in kernels)
    assert not any("ok" in l for l in lines)
