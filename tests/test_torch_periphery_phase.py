"""``chip_smoke.py``'s proxy and monitor phases, rehearsed on the CPU.

``--phases proxy`` and ``--phases monitor``, each at a small size
(phases 1-7 at 5,000 ids; a live node of 8,192 rows behind the proxy,
64 REST keys, a 17-entry PHT; 8 runners and 128 keys for the monitor),
in a file of its own, so that a run under ``-n 6 --dist loadfile`` gives
these two phase processes a worker beside tests/test_torch_isolation.py's
rehearsal of the in-process phases, which ran within a few seconds of
its 300 s limit with them.  Each checks what the card run checks.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _rehearse(tmp_path, phase: str, *flags) -> list:
    """``chip_smoke.py --cpu --phases <phase>``: its JSON lines, after
    the checks every partial rehearsal shares."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "OPENDHT_TPU_SMOKE_RECORD_DIR": str(tmp_path)}
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--cpu", "--n", "5000",
         "--q", "128", *flags, "--phases", phase],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3, out.stderr[-2000:]
    lines = [json.loads(l) for l in out.stdout.splitlines()
             if l.startswith("{")]
    assert [l.get("phase") for l in lines][:-1] == [
        "device", "main", "parity", "timing", "profile", "memory", phase]
    kernels = lines[-1]["kernels"]
    assert [k["name"] for k in kernels] == ["window_select",
                                            "lex_topk_select"]
    assert all(k["max_abs_err"] == 0 for k in kernels)
    assert not any("ok" in l for l in lines)
    return lines


def test_chip_smoke_rehearses_the_proxy_phase_on_the_cpu(tmp_path):
    lines = _rehearse(tmp_path, "proxy", "--serve-n", "8192",
                      "--proxy-keys", "64", "--pht-entries", "17")
    phases = [l.get("phase") for l in lines]
    proxy = lines[phases.index("proxy")]
    assert proxy["rows"] == 8192 and proxy["rest"]["equal_to_direct_get"] == 64
    assert proxy["rest"]["listen_streams"] == {"streams": 16, "values_each": 2}
    assert proxy["rest"]["open_bounds"] == {"platform": "cpu",
                                            "status": "unsettled"}
    assert proxy["rest"]["kernel_gauges"] > 0
    assert proxy["swap"]["puts_heard_once"] == 3
    assert proxy["pht"]["entries"] == proxy["pht"]["exact_lookups"] == 17
    assert proxy["dhtnode"] == {**proxy["dhtnode"], "device": "cpu",
                                "kernels_named": 16, "jax_modules": []}
    assert proxy["farm"]["errors"] == 0 and proxy["farm"]["requests"] > 0
    assert (proxy["error_records"], proxy["ingest_wave_failures"]) == (0, 0)
    assert proxy["datagrams_sent"]["off_loopback"] == 0
    assert proxy["live_threads"] == []


def test_chip_smoke_rehearses_the_monitor_phase_on_the_cpu(tmp_path):
    lines = _rehearse(tmp_path, "monitor", "--monitor-runners", "8",
                      "--monitor-keys", "128")
    phases = [l.get("phase") for l in lines]
    monitor = lines[phases.index("monitor")]
    assert (monitor["runners"], monitor["keys"]) == (8, 128)
    assert monitor["traffic"]["equal_gets"] == 32
    assert monitor["dhtmon"]["keys"] == 128
    assert monitor["dhtmon"]["closest8_equal_numpy"] == 128
    assert monitor["timeline"]["nodes"] == 8
    assert monitor["timeline"]["violations"] == []
    assert monitor["removal"]["nodes"] == 6
    for child in ("dhtmon_cli", "benchmark", "pingpong"):
        assert monitor[child]["jax_modules"] == [], child
    assert monitor["benchmark"]["doc"]["count"] == 16
    assert monitor["error_records"] == 0 and monitor["live_threads"] == []
