"""``chip_smoke.py``'s smokes phase, rehearsed on the CPU.

``--phases smokes`` at a small size (phases 1-7 at 5,000 ids, then two
of the thirteen smokes, ``--smokes ledger_smoke,waterfall_smoke``, side
by side) in a file of its own, so that a run under ``-n 6 --dist
loadfile`` gives it a worker of its own beside
tests/test_torch_isolation.py's rehearsal of the other phases, which
leaves the smokes out (the full run does).  It checks what the card run
checks, in both passes: each child exited 0 with the smoke's OK line
last, loaded no JAX library or module, printed no traceback and logged
no ERROR and no dark-plane record; the kernels line; and no ok line
(exit 3).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_chip_smoke_rehearses_the_smokes_phase_on_the_cpu(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "OPENDHT_TPU_SMOKE_RECORD_DIR": str(tmp_path)}
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--cpu", "--n", "5000",
         "--q", "128", "--phases", "smokes", "--smokes",
         "ledger_smoke,waterfall_smoke"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 3, out.stderr[-2000:]
    lines = [json.loads(l) for l in out.stdout.splitlines()
             if l.startswith("{")]
    phases = [l.get("phase") for l in lines]
    assert phases[:-1] == ["device", "main", "parity", "timing", "profile",
                           "memory", "smokes"]
    s = lines[phases.index("smokes")]
    # the longest first (chip_smoke.SMOKES), side by side
    assert [d["smoke"] for d in s["smokes"]] == ["waterfall_smoke",
                                                 "ledger_smoke"]
    assert s["smokes_n"] == 2 and s["parallel"] >= 2
    assert set(s["pass_s"]) == {"plain", "profiled"}
    for d in s["smokes"]:
        prof = d["profiled"]
        assert d["ok"] and d["exit"] == prof["exit"] == prof["rc"] == 0, d
        for line in (d["last_line"], prof["last_line"]):
            assert line.startswith(d["smoke"]), d
        assert d["jax_libraries"] == prof["jax_libraries"] \
            == prof["jax_modules"] == []
        assert d["tracebacks"] == prof["n_error_records"] == 0
        assert d["dark_lines"] == prof["dark"] == []
        assert prof["device"]["kernels"] == "not measured"
        for tag in ("plain", "profiled"):
            for ext in (".out", ".err"):
                assert (tmp_path / "smokes" / f"{d['smoke']}.{tag}{ext}"
                        ).is_file()
    assert "waterfall_smoke: OK" in s["smokes"][0]["last_line"]
    assert "ledger_smoke ok: 3 kernels exported" in \
        s["smokes"][1]["last_line"]
    assert s["failed"] == s["with_error_records"] == s["dark"] \
        == s["jax_loaded"] == []
    kernels = lines[-1]["kernels"]
    assert [k["name"] for k in kernels] == ["window_select",
                                            "lex_topk_select"]
    assert all(k["max_abs_err"] == 0 for k in kernels)
    assert not any("ok" in l for l in lines)

