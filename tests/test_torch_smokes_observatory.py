"""The port's end-to-end smokes (``opendht_tpu_torch/testing/*_smoke.py``)
against the JAX package's, on the CPU: the observatory smokes here
(``ledger``, ``health``, ``history``, ``waterfall``, ``peer``), the
planes' in tests/test_torch_smokes_planes.py and the pipeline's and
chaos' in tests/test_torch_smokes_pipeline.py, which import the helpers
of this file.

- Each smoke runs in a fresh process of its own, as a CLI runs it (the
  metrics registry and the tracer are process-wide): the JAX ``main()``
  with JAX on the CPU, the port's ``main(["--cpu"])`` with no card
  visible and two torch threads.  Each process has its own limit of
  ``SMOKE_S`` seconds.  The JAX nodes keep delayed packets (their
  runner's ``RX_QUEUE_MAX_DELAY`` raised from 0.5 s to 60 s, as
  tests/test_torch_monitor.py's mixed cluster does): on a loaded host a
  JAX node's DHT thread sits in its first XLA compiles for over 0.5 s,
  drops the packets queued meanwhile, and ``pipeline_smoke``'s puts then
  fail.  The port's smokes run as a user runs them.
- Both exit 0, and their OK lines are equal once hex ids and measured
  quantities (timings, ratios, wave and hit counts) are masked
  (:func:`masked`): both equal ``REPORTS``, each smoke's masked lines as
  the JAX copy prints them.  What the smokes print from their own
  constants or as literals stays exact (``_KEPT``): keys, gets, listens,
  nodes, listeners, kernels, limits, HTTP codes and dhtmon's
  thresholds.  The dhtmon exit codes the lines quote
  (:func:`dhtmon_codes`) and the names of the checks are compared
  exactly.  The port's process
  has loaded no ``jax``, ``jaxlib`` or ``opendht_tpu`` module.
- The JAX copies' timing gates fail on a loaded host (ROADMAP C.3;
  seen beside this suite's other real-UDP files under ``-n 6``:
  ``keyspace_smoke``'s flood headroom, ``listener_smoke``'s 0.25 s lag
  gate, ``ingest_smoke``'s storage equivalence and ``pipeline_smoke``'s
  puts), most of all at a JAX node's first XLA compiles, which hold
  its DHT thread for seconds.  So the JAX reference is run up to
  ``JAX_ATTEMPTS`` times until it passes, its compiled programs kept in
  a directory of the case's own (``jax_compilation_cache_dir``) so that
  a rerun loads what an earlier run compiled; the port's smoke runs
  once and must pass.  A case whose JAX reference passes in none of its
  runs fails: the port's lines are never held to ``REPORTS`` alone.
- At most ``SMOKE_SLOTS`` smoke processes of these files run at once,
  across the run's xdist workers (:func:`smoke_slot`): in a loaded run
  of the whole suite under ``-n 6`` the JAX ``pipeline_smoke`` failed
  all its attempts, and the port's ``history_smoke`` and
  ``chaos_smoke`` their one run, each on a race that load widens
  (ROADMAP C.3).
- Two JAX copies fail on their own (ROADMAP C.3), and are pinned so:
  ``waterfall_smoke`` reads the stage key ``device_launch``, which the
  scraped exposition no longer carries (``KeyError: 'device_launch'``),
  and ``chaos_smoke``'s chaos-off pin races its put against its get, so
  its two runs of one seeded scenario may disagree.  The port's copies
  exit 0.
- Each smoke's helpers that depend only on their arguments equal the
  JAX copies' on the same inputs, tolerance 0.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
#: each smoke process's own limit
SMOKE_S = 240
#: runs of a JAX smoke until one passes (its timing gates on a loaded host)
JAX_ATTEMPTS = 5
#: smoke processes of these files that run at once, across every xdist
#: worker of the run (file locks in the temporary directory)
SMOKE_SLOTS = 2

_JAX_CHILD = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", {cache!r})
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
import opendht_tpu.runtime.runner
opendht_tpu.runtime.runner.RX_QUEUE_MAX_DELAY = 60.0
from opendht_tpu.testing import {name} as smoke
sys.exit(smoke.main([]))
"""

_PORT_CHILD = """
import json, sys
import torch
torch.set_num_threads(2)
from opendht_tpu_torch.testing import {name} as smoke
rc = smoke.main(["--cpu"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "opendht_tpu"))
print("SMOKE_MODULES " + json.dumps(bad), file=sys.stderr)
sys.exit(rc)
"""


@contextlib.contextmanager
def smoke_slot():
    """Hold one of ``SMOKE_SLOTS`` slots, shared by every process of the
    test run through file locks, while a smoke process runs: the smoke
    twins' files run side by side under ``-n 6 --dist loadfile``, and
    each smoke process beside the others' made the smokes' timing gates
    fail on a loaded host (ROADMAP C.3).  The wait for a slot is not
    part of a smoke's ``SMOKE_S``."""
    d = Path(tempfile.gettempdir()) / "opendht-tpu-smoke-slots"
    d.mkdir(exist_ok=True)
    while True:
        for i in range(SMOKE_SLOTS):
            f = open(d / f"slot{i}.lock", "w")
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                f.close()
                continue
            try:
                yield i
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)
                f.close()
            return
        time.sleep(0.2)


def run_smoke(pkg: str, name: str,
              cache=None) -> subprocess.CompletedProcess:
    """``name``'s ``main`` in a fresh process, in a slot of its own
    (:func:`smoke_slot`): the JAX package's on the CPU, its compiled
    programs kept in the directory ``cache`` for the next run, or the
    port's with ``--cpu`` and no card visible."""
    # one device and one XLA thread a program, as the JAX CI's own smoke
    # runs have one device (tests/conftest.py's eight virtual devices
    # stay in the test process)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    if pkg == "port":
        env["CUDA_VISIBLE_DEVICES"] = ""
        code = _PORT_CHILD.format(name=name)
    else:
        code = _JAX_CHILD.format(name=name, cache=str(cache))
    with smoke_slot():
        return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=SMOKE_S)


def ok_lines(name: str, stdout: str) -> list:
    """The smoke's own report lines (dhtmon's reports share stdout)."""
    return [ln for ln in stdout.splitlines() if ln.startswith(name)]


# 8 or more hex digits: a node id or its prefix (which may hold no letter)
_HEX = re.compile(r"\b[0-9a-f]{8,40}\b")
_NUM = re.compile(r"\d+(?:\.\d+)?(?:e[-+]?\d+)?")
# a swarm's verdict mid-partition: the port draws its swarm's random bits
# from a torch generator, not the JAX stream (tests/test_torch_swarm.py
# holds the two steps equal on the same bits)
_LEVEL = re.compile(r"degraded to (healthy|degraded|unhealthy)")
# the dhtmon exit codes an OK line quotes ("dhtmon 0 then 1", "dhtmon
# --since 1", "dhtmon 0/1", "dhtmon 0 at 0.95 -> 1 at 0.05", "lag gate
# 0 -> 1")
_CODES = re.compile(r"(?:dhtmon(?: --[a-z-]+)?|then|lag gate"
                    r"|(?<=dhtmon [01])/|-> (?=[01] (?:at|under)))"
                    r"\s*([01])(?![.\d])")


# the numbers a smoke prints from its constants or as literals, kept:
# keys, gets, listens, nodes, listeners, kernels, limits, HTTP codes
# and dhtmon's thresholds
_KEPT = re.compile("|".join((
    r"healthz [\d>-]+", r"closest-\d+", r"over \d+ keys",
    r"\d+ kernels exported", r"/\d+ bounds", r"folded\+\d+", r"p95",
    r"\d+ live listeners", r"under a [\d.]+s",
    r"p-ops \d+", r"\b\d+ sheds", r"\b\d+ swaps", r"depth\d == depth\d",
    r"\d+ gets / \d+ listens / \d+ nodes", r"\bt=\d+", r"< gate [\d.]+",
    r"all \d+ keys", r"\d+-node swarm", r"lag gate [01] -> [01]",
    r"dhtmon(?: --[a-z-]+)? [01](?:/[01]| then [01]| at (?:0\.95|1e-9) "
    r"-> [01] at (?:0\.05|0\.999))?")))


def masked(line: str) -> str:
    """``line`` with hex ids and every number masked but those of
    ``_KEPT``."""
    line = _LEVEL.sub("degraded to <level>", _HEX.sub("<id>", line))
    out, at = [], 0
    for m in _KEPT.finditer(line):
        out += [_NUM.sub("<n>", line[at:m.start()]), m.group()]
        at = m.end()
    return "".join(out) + _NUM.sub("<n>", line[at:])


def dhtmon_codes(line: str) -> list:
    return _CODES.findall(line)


#: each smoke's report lines with hex ids and numbers masked, and the
#: dhtmon codes they quote, as the JAX copies print them
REPORTS = {
    "ledger_smoke": [("ledger_smoke ok: 3 kernels exported, <n> exposition "
                      "series parsed",
                      [])],
    "health_smoke": [("health_smoke: OK — healthz 503->200->503, verdict "
                      "healthy->unhealthy (causes ['get_availability', "
                      "'ingest_queue']), coverage <n> over 12 keys (one "
                      "batched closest-8 launch), dhtmon 0 then 1",
                      ["0", "1"])],
    "history_smoke": [("history_smoke: OK — windows via history (pinned "
                       "equal), bundle captured on burn (<n> failed-get deltas"
                       " in frames), dhtmon --since 1 then 0, timeline <n> "
                       "frames/<n> transition events, ring+spill bounded",
                       ["1", "0"])],
    # the port's alone: the JAX copy stops at its stale stage key
    "waterfall_smoke": [("waterfall_smoke: OK — stages advanced (device +<n>),"
                         " /profile json+folded+400, exemplar <id> -> <n> "
                         "spans, dhtmon --max-stage 0 then 1 (gate <n>s, "
                         "stalled p95 <n>s), <n>/7 bounds measured unsettled",
                         ["0", "1"])],
    "peer_smoke": [("peer_smoke: OK — spurious retransmits <n> fixed -> <n> "
                    "adaptive (lag srtt <n>s rto <n>s; quiet rto <n>s), loss "
                    "edge <id>-><id> fail <n>, dhtmon 0 at 0.95 -> 1 at 0.05",
                    ["0", "1"])],
    "keyspace_smoke": [("keyspace_smoke: OK — hot key <id> detected (est <n>, "
                        "share <n>%, hot_key_emerged in ring), imbalance <n> "
                        "-> dhtmon 0 at gate <n>, flood -> <n> -> dhtmon 1",
                        ["0", "1"])],
    "cache_smoke": [("cache_smoke: OK — hot key <id> admitted+served (hits "
                     "<n>, flood ratio <n> -> dhtmon 0/1), put invalidated "
                     "(<n> invalidations) with fresh values on all surfaces",
                     ["0", "1"])],
    "listener_smoke": [("listener_smoke: OK — 544 live listeners, <n> Zipf "
                        "puts batched==off on runner/stream/push surfaces, "
                        "series advanced (occupancy <n>, flushes <n>), lag "
                        "gate 0 -> 1 under a 0.8s drain stall",
                        ["0", "1"])],
    "ingest_smoke": [("ingest_smoke: OK — <n> waves, mean occupancy <n> (p-ops"
                      " 34), 0 sheds, batched == per-op on 16 gets / 2 listens"
                      " / 3 nodes",
                      [])],
    "pipeline_smoke": [("pipeline_smoke: OK — <n> waves, inflight peak <n>, 0 "
                        "sheds, depth2 == depth1 on 16 gets / 2 listens / 3 "
                        "nodes",
                        [])],
    "pipeline_util_smoke": [("pipeline_util_smoke: OK — occupancy <n> over <n>"
                             " waves (<n> device-stage samples), queue_empty "
                             "choke attributed, dhtmon 0 at 1e-9 -> 1 at "
                             "0.999, top bubble 'queue_empty'",
                             ["0", "1"])],
    "reshard_smoke": [("reshard_smoke: OK — burst held (<n> hysteresis skips, "
                       "0 swaps, dhtmon 1), sustained flood swapped gen=<n> "
                       "t=8 (post refold <n>), live imbalance <n> < gate 2.0 "
                       "-> dhtmon 0, get/put/listen identical across the swap",
                       ["1", "0"])],
    "chaos_smoke": [("chaos_smoke[udp]: OK — partition burned the SLO (healthz"
                     " 503, bundle captured, dhtmon --since 1), heal recovered"
                     " (healthz 200, dhtmon --since 0)",
                     ["1", "0"]),
                    ("chaos_smoke[vnet]: OK — chaos-off == baseline pinned, "
                     "storm dropped {'loss': <n>, 'partition:cut': <n>}, all 4"
                     " keys survived",
                     []),
                    ("chaos_smoke[swarm]: OK — 4096-node swarm degraded to "
                     "<level> mid-partition, healed to success=<n> "
                     "coverage=<n>",
                     [])],
}

def report(lines: list) -> list:
    """Report lines as ``REPORTS`` holds them: masked, with their codes."""
    return [(masked(ln), dhtmon_codes(ln)) for ln in lines]


def port_modules(stderr: str) -> list:
    line = [ln for ln in stderr.splitlines()
            if ln.startswith("SMOKE_MODULES ")]
    assert line, stderr[-2000:]
    return json.loads(line[-1].split(" ", 1)[1])


def smoke_twin(name: str, cache) -> None:
    """Run ``name`` on both packages and hold them to each other (the
    module docstring); ``cache``: a directory for the JAX runs' compiled
    programs."""
    tries = []      # each JAX run's exit code and last stderr line
    for _ in range(JAX_ATTEMPTS):
        jax = run_smoke("jax", name, cache)
        tries.append((jax.returncode,
                      (jax.stderr.strip().splitlines() or [""])[-1]))
        if jax.returncode == 0 or name == "waterfall_smoke":
            break
    port = run_smoke("port", name)
    assert port.returncode == 0, port.stderr[-3000:]
    assert port_modules(port.stderr) == []
    port_lines = ok_lines(name, port.stdout)
    assert report(port_lines) == REPORTS[name], port_lines
    if name == "waterfall_smoke":
        # the JAX copy's stale stage key (ROADMAP C.3)
        assert jax.returncode == 1, jax.stderr[-3000:]
        assert jax.stderr.strip().splitlines()[-1] \
            == "KeyError: 'device_launch'", jax.stderr[-3000:]
        assert ok_lines(name, jax.stdout) == []
        return
    if name == "chaos_smoke" and jax.returncode != 0:
        # the JAX copy's chaos-off pin raced its put (ROADMAP C.3): the
        # real-UDP tier before it passed and printed its line
        assert "assert base == armed and base[1] == 0" in jax.stderr, \
            jax.stderr[-3000:]
        assert jax.stderr.strip().splitlines()[-1].startswith(
            "AssertionError: (("), jax.stderr[-3000:]
    else:
        assert jax.returncode == 0, (tries, jax.stderr[-3000:])
    # the JAX copy's lines (the udp tier's alone after a raced pin)
    jax_lines = ok_lines(name, jax.stdout)
    assert jax_lines and report(jax_lines) \
        == REPORTS[name][:len(jax_lines)], jax_lines


# ------------------------------------------------------ this file's smokes
OBSERVATORY = ("ledger_smoke", "health_smoke", "history_smoke",
               "waterfall_smoke", "peer_smoke")


@pytest.mark.parametrize("name", OBSERVATORY)
def test_smoke_twin(name, tmp_path):
    smoke_twin(name, tmp_path)


# ----------------------------------------------------------- the masking
def test_every_smoke_has_its_report():
    import pkgutil
    import opendht_tpu.testing as J
    smokes = {m.name for m in pkgutil.iter_modules(J.__path__)
              if m.name.endswith("_smoke") and m.name != "telemetry_smoke"}
    assert set(REPORTS) == smokes and len(smokes) == 13


def test_masking_keeps_the_checks_and_dhtmon_codes():
    a = ("peer_smoke: OK — spurious retransmits 13 fixed -> 4 adaptive "
         "(lag srtt 1.050s rto 1.336s; quiet rto 0.250s), loss edge "
         "96677b61->e9dbc7bd fail 0.23, dhtmon 0 at 0.95 -> 1 at 0.05")
    b = ("peer_smoke: OK — spurious retransmits 13 fixed -> 1 adaptive "
         "(lag srtt 1.032s rto 2.210s; quiet rto 0.250s), loss edge "
         "e7e592a8->9c74667e fail 0.23, dhtmon 0 at 0.95 -> 1 at 0.05")
    assert masked(a) == masked(b)
    assert dhtmon_codes(a) == dhtmon_codes(b) == ["0", "1"]
    assert dhtmon_codes("dhtmon 0 at 0.95 -> 0 at 0.05") == ["0", "0"]
    assert dhtmon_codes("hits 3, flood ratio 1.00 -> dhtmon 0/1") \
        == ["0", "1"]
    assert dhtmon_codes("dhtmon --since 1 then 0, lag gate 0 -> 1 under") \
        == ["1", "0", "0", "1"]
    assert dhtmon_codes("imbalance 1.05 -> dhtmon 1, flood -> 1.5") == ["1"]
    # an all-digit id prefix is an id
    assert masked("loss edge 47893005->40da5bad fail 0.23") \
        == masked("loss edge a6647126->b3adf335 fail 0.23")
    assert masked("verdict healthy->unhealthy") \
        != masked("verdict healthy->degraded")
    # what the smokes print from their constants stays exact
    for a, b in (("on 16 gets / 2 listens / 3 nodes",
                  "on 15 gets / 2 listens / 3 nodes"),
                 ("544 live listeners, 130 Zipf puts",
                  "543 live listeners, 130 Zipf puts"),
                 ("coverage 1.00 over 12 keys", "coverage 1.00 over 11 keys"),
                 ("3 kernels exported", "2 kernels exported"),
                 ("dhtmon 0 at 0.95 -> 1 at 0.05",
                  "dhtmon 0 at 0.9 -> 1 at 0.05"),
                 ("all 4 keys survived", "all 3 keys survived"),
                 ("4096-node swarm", "2048-node swarm")):
        assert masked(a) != masked(b), a
    assert masked("imbalance 4.00 -> dhtmon 0 at gate 4.75, flood -> 6.89") \
        == "imbalance <n> -> dhtmon 0 at gate <n>, flood -> <n>"
    assert masked("gen=1 t=8 (post refold 1.11)") \
        == "gen=<n> t=8 (post refold <n>)"


# ---------------------------------------------------- the pure helpers
def _modules(name: str) -> tuple:
    import importlib
    return (importlib.import_module("opendht_tpu.testing." + name),
            importlib.import_module("opendht_tpu_torch.testing." + name))


def test_constants_equal_the_jax_copies():
    for name, attrs in (("ledger_smoke", ("SMOKE_KERNELS",)),
                        ("health_smoke", ("N_NODES", "N_KEYS",
                                          "OP_TIMEOUT")),
                        ("history_smoke", ("N_NODES", "N_KEYS", "TICK")),
                        ("waterfall_smoke", ("N_NODES", "N_KEYS", "TICK",
                                             "STALL_S", "STAGES",
                                             "OPEN_BOUND_KEYS")),
                        ("peer_smoke", ("ONE_WAY_DELAY", "ONE_WAY_JITTER",
                                        "MIN_REQUESTS", "OP_TIMEOUT"))):
        jmod, pmod = _modules(name)
        for a in attrs:
            assert getattr(pmod, a) == getattr(jmod, a), (name, a)


def test_stage_counts_read_the_canonical_stages():
    jmod, pmod = _modules("waterfall_smoke")
    rng = np.random.default_rng(41)
    series = {'dht_stage_seconds_count{stage="%s"}' % s: float(v)
              for s, v in zip(pmod.STAGES,
                              rng.integers(0, 1000, len(pmod.STAGES)))}
    series['dht_other_total{stage="queue_wait"}'] = 5.0
    assert pmod._stage_counts(series) == jmod._stage_counts(series)
    assert pmod.DEVICE_STAGES == ("device_compile", "device_wait")
    counts = pmod._stage_counts(series)
    # the key the JAX copy reads is not among the scraped stages
    assert "device_launch" not in counts


def test_peer_rows_equal():
    jmod, pmod = _modules("peer_smoke")
    rng = np.random.default_rng(43)
    ids = ["%040x" % int(x) for x in rng.integers(0, 2**62, 6)]
    snap = {"peers": [{"id": i, "sent": int(s)} for i, s in
                      zip(ids, rng.integers(0, 50, 6))]}
    for pid in ids + ["0" * 40]:
        assert pmod._row(snap, pid) == jmod._row(snap, pid)
    assert pmod._row({}, ids[0]) is jmod._row({}, ids[0]) is None


def test_waits_equal():
    for name in ("health_smoke", "history_smoke", "waterfall_smoke"):
        jmod, pmod = _modules(name)
        for pred in (lambda: True, lambda: 0, lambda: [1]):
            assert pmod._wait(pred, timeout=0.05, step=0.01) \
                == jmod._wait(pred, timeout=0.05, step=0.01)


def test_history_ring_and_spill_stay_bounded_in_both():
    jmod, pmod = _modules("history_smoke")
    assert jmod.ring_spill_bounded_check() is None
    assert pmod.ring_spill_bounded_check() is None


def test_ledger_exports_read_the_port_fields():
    """The port's ledger names its fields apart from the JAX ledger's;
    the smoke reads each exported gauge from the field it is made of."""
    from opendht_tpu_torch import profiling, telemetry
    _, pmod = _modules("ledger_smoke")
    led = profiling.KernelLedger()
    entries = led.compute(pmod.SMOKE_KERNELS, device="cpu")
    reg = telemetry.MetricsRegistry()
    assert led.export_to_registry(reg) == len(pmod.SMOKE_KERNELS)
    gauges = reg.snapshot()["gauges"]
    for name, e in entries.items():
        for fam, v in pmod.exported(e).items():
            assert gauges['dht_kernel_%s{kernel="%s"}' % (fam, name)] == v


@pytest.mark.parametrize("order", ["jax", "port"])
def test_history_smoke_choke_lands_in_a_frame_before_the_health_tick(order):
    """``history_smoke``'s step 2 on one port runner whose health tick
    runs at every pump and whose recorder never ticks on its own: in the
    JAX copy's order (``queue_max`` set from the calling thread, then the
    gets) the tick reads the live ``ingest_queue`` signal, turns
    unhealthy and captures a bundle whose frames hold no failed get (the
    port's run failed so in a loaded run of the whole suite: "burn not
    visible in the bundle's frames", ROADMAP C.3); the port's
    ``choke_ingest`` records the frame in the same pump as the choke and
    the gets."""
    from opendht_tpu_torch.infohash import InfoHash
    from opendht_tpu_torch.runtime import Config, DhtRunner, RunnerConfig
    _, H = _modules("history_smoke")
    cfg = Config()
    cfg.health.period = 0.01
    cfg.history.period = 3600.0
    r, peer = DhtRunner(), DhtRunner()
    r.run(0, RunnerConfig(dht_config=cfg), device="cpu")
    peer.run(0, device="cpu")
    try:
        peer.bootstrap("127.0.0.1", r.get_bound_port())
        # not unhealthy: a transition to unhealthy captures the bundle
        # (a loaded host may leave degrade-only signals degraded)
        assert H._wait(lambda: r.get_health()["verdict"]
                       in ("healthy", "degraded"), timeout=30), \
            r.get_health()
        pre = len(r.get_bundles())
        # the recorder's baseline (its first tick records no frame)
        ticked = []
        r._post(lambda _dht: ticked.append(r._history.tick()), prio=True)
        assert H._wait(lambda: ticked) and ticked == [None]
        keys = [InfoHash.get("choke-%d" % i) for i in range(4)]
        fails = []
        if order == "jax":
            r._dht.wave_builder.queue_max = 0
            for i in range(10):
                r.get(keys[i % 4], lambda vals: True,
                      lambda ok, ns: fails.append(ok))
        else:
            H.choke_ingest(r, keys, 10, fails)
        assert H._wait(lambda: len(fails) == 10
                       and len(r.get_bundles()) > pre, timeout=30)
        assert not any(fails)
        bundle = r.get_bundles()[-1]
        assert bundle["transition"]["to"] == "unhealthy"
        burn = sum(f["counters"].get('dht_ops_total{ok="false",op="get"}', 0)
                   for f in bundle["history"]["frames"])
        assert burn == (0 if order == "jax" else 10), burn
    finally:
        r.join()
        peer.join()
