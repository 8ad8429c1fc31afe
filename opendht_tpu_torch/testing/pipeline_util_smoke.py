"""Pipeline-utilization CI smoke.

Boots the same real-UDP 3-node cluster + REST proxy as
``pipeline_smoke`` and drives a Zipf-skewed get flood through the
depth-2 wave pipeline, then asserts the three things only a live
cluster can about the utilization observatory:

1. **The occupancy plane measures real serving**: after the flood the
   ``dht_pipeline_occupancy`` gauge is a known value > 0 that is
   CONSISTENT with the stage histograms (every dispatched wave
   observed exactly one device-stage sample, so device-stage count <=
   observatory waves, both > 0; busy seconds stay under the wall
   window), ``GET /pipeline`` serves the snapshot (occupancy, bubble
   ledger, overlap ratio) with ``?fmt=trace`` returning a Perfetto
   document whose lane pids are populated, and both
   ``dht_pipeline_occupancy`` and ``dht_pipeline_waves_total`` ride
   the proxy's Prometheus ``GET /stats`` exposition.
2. **An admission choke is attributed, not lost**: traffic pauses (the
   forced choke — the queue stays empty while the device idles), then
   a single op fires; the idle gap must land in the bubble ledger as
   ``queue_empty`` — healthy idleness, classified, never starving the
   health signal.
3. **dhtmon gates on the measured occupancy**: ``--min-occupancy``
   exits 0 at a floor below the measured gauge and flips to 1 at an
   impossible floor (0.999) — the same per-node worst / unknown-never-
   violates contract as the other gauge gates.

Run directly::

    python -m opendht_tpu_torch.testing.pipeline_util_smoke [--cpu]

Its nodes run on the CUDA card unless ``--cpu`` is given; without a card
(and without ``--cpu``) it raises before any socket is bound.

The port's copy of the JAX package's ``testing/pipeline_util_smoke.py``,
behaviour unchanged but for the nodes' device.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.request

from .. import telemetry, waterfall
from ..core.value import Value
from .._device import resolve_device
from ..infohash import InfoHash
from ..pipeline_observatory import BUBBLE_CAUSES
from ..runtime.config import Config, NodeStatus
from ..runtime.runner import DhtRunner, RunnerConfig
from ..tools import dhtmon

N_NODES = 3
N_COLD = 16
ZIPF_ROUNDS = 6
OP_TIMEOUT = 30.0


def _wait(pred, timeout=30.0, step=0.05) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _get_json(port: int, path: str) -> dict:
    with urllib.request.urlopen(
            "http://127.0.0.1:%d%s" % (port, path), timeout=10) as r:
        return json.loads(r.read().decode())


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    resolve_device(device)        # no card and no --cpu: raise here
    reg = telemetry.get_registry()
    reg.reset()
    runners = []
    proxy = None
    try:
        for i in range(N_NODES):
            cfg = Config(node_id=InfoHash.get("pipeutil-smoke-node-%d" % i),
                         ingest_pipeline_depth=2)
            r = DhtRunner()
            r.run(0, RunnerConfig(dht_config=cfg), device=device)
            if runners:
                r.bootstrap("127.0.0.1", runners[0].get_bound_port())
            runners.append(r)
        assert _wait(lambda: all(
            r.get_status() is NodeStatus.CONNECTED for r in runners[1:])), \
            "cluster failed to connect"

        from ..proxy import DhtProxyServer
        proxy = DhtProxyServer(runners[0], 0)

        hot = InfoHash.get("pipeutil-hot")
        cold = [InfoHash.get("pipeutil-cold-%d" % i) for i in range(N_COLD)]
        assert runners[1].put_sync(hot, Value(b"pu-hot", value_id=1),
                                   timeout=OP_TIMEOUT)
        for i, k in enumerate(cold[:4]):
            assert runners[1].put_sync(k, Value(b"pu-%d" % i,
                                                value_id=i + 2),
                                       timeout=OP_TIMEOUT)

        # ---- Zipf-skewed flood through node 0's wave builder: per
        # round, 8 hot gets interleaved with every cold key once (~33%
        # hot share), all ops posted concurrently so the builder fires
        # real coalesced waves back to back
        def drive_round():
            done = []
            ev = threading.Event()
            seq = []
            for j in range(8):
                seq.append(hot)
                seq.extend(cold[j * 2:(j + 1) * 2])
            total = len(seq)

            def fire(k):
                runners[0].get(
                    k, lambda vs: True,
                    lambda ok, ns: (done.append(ok),
                                    ev.set() if len(done) >= total
                                    else None))
            threads = [threading.Thread(target=fire, args=(k,))
                       for k in seq]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert ev.wait(OP_TIMEOUT), "zipf round stalled"

        for _ in range(ZIPF_ROUNDS):
            drive_round()

        # ---- 1: the occupancy plane measured the flood, consistently
        # with the stage histograms
        obs = runners[0]._dht.wave_builder.observatory
        assert obs.enabled
        g_occ = reg.gauge("dht_pipeline_occupancy")
        assert _wait(lambda: g_occ.value >= 0.0, timeout=10), \
            "occupancy gauge stayed unknown under live traffic"
        occ = float(g_occ.value)
        assert 0.0 < occ <= 1.0, "implausible occupancy %r" % occ

        pipe = _get_json(proxy.port, "/pipeline")
        assert pipe["enabled"] and pipe["waves_total"] > 0, pipe
        wf_snap = waterfall.get_profiler().snapshot()["stages"]
        dev_count = (wf_snap["device_compile"]["count"]
                     + wf_snap["device_wait"]["count"])
        assert 0 < dev_count <= pipe["waves_total"], (
            "stage histograms inconsistent with the observatory: "
            "%d device-stage samples vs %d waves"
            % (dev_count, pipe["waves_total"]))
        acct = runners[0]._dht.wave_builder.observatory.account()
        assert acct["busy_s"] <= acct["span_s"] + 1e-6, acct
        assert set(pipe["bubbles"]) == set(BUBBLE_CAUSES)

        trace = _get_json(proxy.port, "/pipeline?fmt=trace")
        lanes = {e["args"]["name"] for e in trace["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
        assert {"lane:fill", "lane:device", "lane:drain"} <= lanes, lanes

        with urllib.request.urlopen(
                "http://127.0.0.1:%d/stats" % proxy.port, timeout=10) as r:
            prom = r.read().decode()
        for series in ("dht_pipeline_occupancy", "dht_pipeline_waves_total"):
            assert series in prom, "proxy /stats missing %s" % series

        # ---- 2: the forced admission choke — no traffic while the
        # device idles, then one op; the gap lands as queue_empty.
        # Fresh (never-cached) keys so the op really dispatches, and a
        # throwaway first cycle so any cache/backpressure flag still
        # pending from the flood's last event is consumed at its
        # dispatch instead of naming the measured gap.
        h_qe = reg.histogram("dht_pipeline_bubble_seconds",
                             cause="queue_empty")

        def choke_get(tag):
            ev = threading.Event()
            runners[0].get(InfoHash.get(tag), lambda vs: True,
                           lambda ok, ns: ev.set())
            assert ev.wait(OP_TIMEOUT), "choke op %s stalled" % tag

        time.sleep(0.4)
        choke_get("pipeutil-choke-flush")
        qe0 = h_qe.count
        time.sleep(0.4)                       # the choke: device idle
        choke_get("pipeutil-choke")
        assert _wait(lambda: h_qe.count > qe0, timeout=10), \
            "admission choke never attributed a queue_empty bubble"

        # ---- 3: dhtmon gates on the measured occupancy, both verdicts
        ep = ["--nodes", "127.0.0.1:%d" % proxy.port]
        rc = dhtmon.main(ep + ["--min-occupancy", "1e-9"])
        assert rc == 0, \
            "dhtmon flagged a busy pipeline (rc=%d, occupancy %r)" \
            % (rc, float(g_occ.value))
        rc = dhtmon.main(ep + ["--min-occupancy", "0.999"])
        assert rc == 1, \
            "dhtmon missed the occupancy floor (rc=%d, occupancy %r)" \
            % (rc, float(g_occ.value))

        print("pipeline_util_smoke: OK — occupancy %.3f over %d waves "
              "(%d device-stage samples), queue_empty choke attributed, "
              "dhtmon 0 at 1e-9 -> 1 at 0.999, top bubble %r"
              % (occ, pipe["waves_total"], dev_count,
                 pipe["top_bubble_cause"]))
        return 0
    finally:
        if proxy is not None:
            proxy.stop()
        for r in runners:
            r.join()


if __name__ == "__main__":
    sys.exit(main())
