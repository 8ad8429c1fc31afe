"""End-to-end per-op latency waterfall smoke.

Boots a 3-node real-UDP cluster + REST proxy, runs mixed put/get
traffic, and asserts what the unit tier cannot:

1. **The always-on stage histograms advance under real traffic**:
   ``dht_stage_seconds{stage=}`` counts for the admission queue, the
   device launch (compile or execute) and the scatter-back all move on
   the scraped ``GET /stats`` exposition, and the network hop stage
   (``rpc_wait``) moves off the real UDP RTTs.
2. **``GET /profile`` serves the waterfall over the proxy**: the JSON
   snapshot (stages + budgets + per-op records + live OPEN-bound
   comparison), the ``?fmt=folded`` flamegraph stacks as text, and a
   400 on an unknown ``fmt``.
3. **A hot-bucket exemplar resolves through the trace assembler**: a
   trace id stamped on a stage bucket by serving traffic reassembles
   into a span tree via :func:`trace_assembler.assemble_trace` — the
   histogram-to-trace pivot.
4. **dhtmon gates on stage p95s**: with the threshold set strictly
   above the measured healthy baseline, ``--max-stage scatter_back=``
   exits 0; after an injected scatter-path stall (sleeping wave
   callbacks inflate the real per-wave scatter-back span — no clock
   mocking), the SAME threshold exits 1.
5. **The OPEN-bound tracker drops a well-formed settling record**:
   ``refresh()`` measures live series, every bound reports
   ``status="unsettled"`` on the CPU (``"candidate"`` on the card), and
   ``write_record`` round-trips through JSON with metric + settle fields
   per bound.

The device stages are read under the waterfall's canonical names
(:data:`~opendht_tpu_torch.waterfall.STAGES`): the scraped exposition
carries no ``device_launch`` series, the in-process alias of
``device_wait``, so the JAX copy's read of that name fails with a
KeyError; and ``GET /profile`` lists the alias beside the canonical
stages (marked ``alias_of``), so its stage set is compared without
it.

Run directly::

    python -m opendht_tpu_torch.testing.waterfall_smoke [--cpu]

Its nodes run on the CUDA card unless ``--cpu`` is given; without a card
(and without ``--cpu``) it raises before any socket is bound.

The port's copy of the JAX package's ``testing/waterfall_smoke.py``,
behaviour unchanged but for the nodes' device.
"""

from __future__ import annotations

import json
import socket
import sys
import tempfile
import time
import urllib.error
import urllib.request

from ..core.value import Value
from .._device import resolve_device
from ..infohash import InfoHash
from ..runtime.config import Config, NodeStatus
from ..runtime.runner import DhtRunner, RunnerConfig
from ..tools import dhtmon
from ..waterfall import OPEN_BOUND_KEYS, STAGES
from . import health_monitor as hm
from . import trace_assembler as tra

N_NODES = 3
N_KEYS = 10
OP_TIMEOUT = 30.0
TICK = 0.25
STALL_S = 2.0


def _wait(pred, timeout=30.0, step=0.05) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(step)
    return pred()


#: the device stages of the waterfall (compile, and the blocking wait
#: the old ``device_launch`` stage is an alias of)
DEVICE_STAGES = tuple(s for s in STAGES if s.startswith("device_"))


def _stage_counts(series: dict) -> dict:
    return {s: series.get('dht_stage_seconds_count{stage="%s"}' % s, 0.0)
            for s in STAGES}


def main(argv=None) -> int:
    from ..proxy import DhtProxyServer
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    resolve_device(device)        # no card and no --cpu: raise here
    # the OPEN-bound tracker's status follows the nodes' device
    settle = "unsettled" if device == "cpu" else "candidate"

    runners = []
    proxy = None
    try:
        for i in range(N_NODES):
            cfg = Config(node_id=InfoHash.get("waterfall-smoke-node-%d" % i))
            cfg.health.period = TICK
            cfg.waterfall.open_bound_period = TICK
            r = DhtRunner()
            r.run(0, RunnerConfig(dht_config=cfg), device=device)
            runners.append(r)
            if i == 0:
                proxy = DhtProxyServer(r, 0)
            else:
                r.bootstrap("127.0.0.1", runners[0].get_bound_port())
        assert _wait(lambda: all(
            r.get_status() is NodeStatus.CONNECTED for r in runners)), \
            "cluster failed to connect"
        ep = "127.0.0.1:%d" % proxy.port

        before = _stage_counts(hm.scrape_node(ep)["series"])

        # --- mixed traffic so every serving stage sees real work
        keys = [InfoHash.get("waterfall-smoke-%d" % i)
                for i in range(N_KEYS)]
        for i, key in enumerate(keys):
            assert runners[1 + i % (N_NODES - 1)].put_sync(
                key, Value(b"wf-%d" % i, value_id=i + 1),
                timeout=OP_TIMEOUT)
        for key in keys:
            assert runners[0].get_sync(key, timeout=OP_TIMEOUT)

        # --- 1: the stage histograms advanced on the scrape
        series = hm.scrape_node(ep)["series"]
        after = _stage_counts(series)
        assert after["queue_wait"] > before["queue_wait"], (before, after)
        assert after["scatter_back"] > before["scatter_back"], \
            (before, after)
        dev = sum(after[s] - before[s] for s in DEVICE_STAGES)
        assert dev > 0, "device stage never observed: %r" % (after,)
        assert after["rpc_wait"] > before["rpc_wait"], \
            "real-UDP hops left rpc_wait untouched: %r" % (after,)

        # --- 2: GET /profile over the proxy: JSON, folded, 400
        with urllib.request.urlopen(
                "http://%s/profile" % ep, timeout=10) as r:
            prof = json.loads(r.read().decode())
        assert prof["enabled"] is True
        # the snapshot mirrors each alias beside its canonical stage,
        # marked ``alias_of``
        canonical = {s for s, d in prof["stages"].items()
                     if "alias_of" not in d}
        assert canonical == set(STAGES), sorted(prof["stages"])
        assert prof["ops"], "no per-op decomposition records"
        for op in prof["ops"]:
            s = sum(op["stages"].values())
            assert s <= op["end_to_end"] + 1e-6, op
        ob = prof.get("open_bounds")
        assert ob and set(ob["bounds"]) == set(OPEN_BOUND_KEYS), ob
        with urllib.request.urlopen(
                "http://%s/profile?fmt=folded" % ep, timeout=10) as r:
            assert r.headers.get_content_type() == "text/plain"
            folded = r.read().decode()
        assert any(ln.startswith("dht;op;") for ln in folded.splitlines()), \
            folded
        try:
            urllib.request.urlopen(
                "http://%s/profile?fmt=bogus" % ep, timeout=10)
            raise AssertionError("bad fmt did not 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400, e.code

        # --- 3: a stage-bucket exemplar pivots into a full trace
        tid = None
        for s in STAGES:
            for _le, _v, t in prof["stages"][s].get("exemplars", []):
                if t:
                    tid = t
                    break
            if tid:
                break
        assert tid, "no stage bucket carried an exemplar trace id"
        trace = tra.assemble_trace(runners, tid)
        assert trace["spans"] >= 1, trace
        assert trace["roots"], "exemplar trace did not reassemble: %r" % (
            trace,)

        # --- 4: dhtmon --max-stage: 0 healthy, 1 under an injected
        # stall.  The healthy baseline is NOT tiny on cold runs (the
        # first waves' one-time work runs inside the scatter callbacks),
        # so the gate sits strictly above the measured baseline — the
        # 0 -> 1 flip is then attributable to the stall alone.
        def _scatter_p95() -> float:
            p95s = dhtmon._stage_p95s(hm.scrape_node(ep)["series"])
            return p95s.get("scatter_back") or 0.0

        gate = _scatter_p95() + STALL_S / 2.0
        rc = dhtmon.main(["--nodes", ep, "--min-success", "0.5",
                          "--max-stage", "scatter_back=%g" % gate])
        assert rc == 0, "healthy cluster tripped the stage gate (rc=%d)" \
            % rc
        # stall the scatter path for real: sleeping wave callbacks run
        # inside the scatter loop, so the per-wave scatter_back span
        # genuinely inflates — no clock mocking.  Each stall entry rides
        # its own wave; inject until the scraped p95 crosses the gate.
        wb = runners[0]._dht.wave_builder
        for i in range(12):
            if _scatter_p95() > gate:
                break
            done = []
            wb.submit(InfoHash.get("waterfall-stall-%d" % i),
                      socket.AF_INET, 8,
                      lambda nodes, done=done: (time.sleep(STALL_S),
                                                done.append(1)),
                      kind="stall")
            assert _wait(lambda: done, timeout=15.0), \
                "stall wave %d never scattered" % i
        assert _scatter_p95() > gate, \
            "injected stalls never moved the scatter_back p95"
        rc = dhtmon.main(["--nodes", ep, "--min-success", "0.5",
                          "--max-stage", "scatter_back=%g" % gate])
        assert rc == 1, "dhtmon missed the scatter stall (rc=%d)" % rc

        # --- 5: OPEN-bound settling record, live off this traffic
        tracker = runners[0]._open_bounds
        assert tracker is not None
        measured = tracker.refresh()
        # live serving traffic lights up the op-latency and ingest
        # bounds; the mode="single"/"tp" wave bounds only measure under
        # the benchmark drivers and stay at the -1 "no data" sentinel
        assert measured["cache_flood_p50"]["value"] is not None, measured
        assert measured["ingest_wave_occupancy"]["value"] is not None, \
            measured
        n_live = sum(1 for b in measured.values()
                     if b["value"] is not None)
        assert n_live >= 2, measured
        with tempfile.TemporaryDirectory(prefix="odt-wf-smoke-") as d:
            path = tracker.write_record(d)
            assert path, "settling record not written"
            with open(path) as f:
                doc = json.load(f)
        assert doc["name"] == "open_bounds"
        assert doc["status"] == settle, doc["status"]
        assert doc["bounds"], doc
        for k, b in doc["bounds"].items():
            assert k in OPEN_BOUND_KEYS, k
            assert b["metric"] and b["settle"], b
            assert b["status"] == settle, b
        n_gauges = sum(1 for name in series
                       if name.startswith("dht_open_bound{"))
        assert n_gauges == len(OPEN_BOUND_KEYS), \
            "expected %d open-bound gauges, scraped %d" % (
                len(OPEN_BOUND_KEYS), n_gauges)

        print("waterfall_smoke: OK — stages advanced (device +%d), "
              "/profile json+folded+400, exemplar %s -> %d spans, "
              "dhtmon --max-stage 0 then 1 (gate %.3fs, stalled p95 "
              "%.3fs), %d/%d bounds measured %s"
              % (int(dev), tid[:8], trace["spans"], gate,
                 _scatter_p95(), len(doc["bounds"]),
                 len(OPEN_BOUND_KEYS), settle))
        return 0
    finally:
        if proxy is not None:
            proxy.stop()
        for r in runners:
            r.join()


if __name__ == "__main__":
    sys.exit(main())
