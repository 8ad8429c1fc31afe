"""End-to-end health observatory smoke.

Boots a 3-node real-UDP cluster + REST proxy and asserts the four
things the unit tier cannot:

1. **Readiness flips through bootstrap**: the first node's
   ``GET /healthz`` is 503 while it is alone/disconnected and flips to
   200 (verdict healthy/degraded) once the cluster connects.
2. **Cluster invariants hold when healthy**: ``dhtmon`` exits 0 with
   ``--require-ready --min-success``, and the batched replica-coverage
   probe (ONE closest-8 launch for the whole sampled key set) reports
   full coverage of the stored keys on the live cluster.
3. **A real degradation degrades the verdict**: choking ingest
   admission (queue bound to zero — every new op sheds, the
   backpressure failure mode of the ingest queue) drives the availability SLO
   into fast burn; the verdict leaves ``healthy``, a
   ``health_transition`` event (and an ``slo_violation``) lands in the
   flight recorder, and ``/healthz`` answers 503 again.
4. **dhtmon exits non-zero on the violated cluster invariant** (global
   lookup success below threshold).

Run directly::

    python -m opendht_tpu_torch.testing.health_smoke [--cpu]

Its nodes run on the CUDA card unless ``--cpu`` is given; without a card
(and without ``--cpu``) it raises before any socket is bound.

The port's copy of the JAX package's ``testing/health_smoke.py``,
behaviour unchanged but for the nodes' device.
"""

from __future__ import annotations

import json
import sys
import time
import urllib.error
import urllib.request

from ..core.value import Value
from .._device import resolve_device
from ..infohash import InfoHash
from ..runtime.config import Config, NodeStatus
from ..runtime.runner import DhtRunner, RunnerConfig
from ..tools import dhtmon
from . import health_monitor as hm

N_NODES = 3
N_KEYS = 12
OP_TIMEOUT = 30.0


def _wait(pred, timeout=30.0, step=0.05) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _healthz(port: int):
    """(status_code, body_dict) of GET /healthz."""
    try:
        with urllib.request.urlopen(
                "http://127.0.0.1:%d/healthz" % port, timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def main(argv=None) -> int:
    from ..proxy import DhtProxyServer
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    resolve_device(device)        # no card and no --cpu: raise here

    # fast health cadence so the smoke converges in seconds; the SLO
    # set stays the default (99% availability on get/put/listen)
    runners = []
    proxy = None
    try:
        for i in range(N_NODES):
            cfg = Config(node_id=InfoHash.get("health-smoke-node-%d" % i))
            cfg.health.period = 0.25
            r = DhtRunner()
            r.run(0, RunnerConfig(dht_config=cfg), device=device)
            runners.append(r)
            if i == 0:
                proxy = DhtProxyServer(r, 0)
                # --- 1a: alone + disconnected => not ready (503)
                assert _wait(lambda: _healthz(proxy.port)[0] == 503,
                             timeout=10.0), \
                    "lone node reported ready before bootstrap"
                code, body = _healthz(proxy.port)
                assert body["ready"] is False, body
                assert body["verdict"] in ("unknown", "unhealthy"), body
            else:
                r.bootstrap("127.0.0.1", runners[0].get_bound_port())
        assert _wait(lambda: all(
            r.get_status() is NodeStatus.CONNECTED for r in runners)), \
            "cluster failed to connect"

        # --- 1b: connected => readiness flips to 200
        assert _wait(lambda: _healthz(proxy.port)[0] == 200), \
            "healthz did not flip to 200 after bootstrap: %r" \
            % (_healthz(proxy.port),)
        code, body = _healthz(proxy.port)
        assert body["ready"] is True and \
            body["verdict"] in ("healthy", "degraded"), body
        # readiness (200) flips at "degraded" already; the connectivity
        # signal itself recovers to "healthy" one hysteresis tick later
        # — wait for the level, don't assert one snapshot
        assert _wait(lambda: _healthz(proxy.port)[1]["health"]["signals"]
                     ["connectivity"]["level"] == "healthy"), \
            "connectivity signal never recovered: %r" \
            % (_healthz(proxy.port)[1]["health"]["signals"],)

        # --- traffic so the SLOs and the coverage probe have data
        keys = [InfoHash.get("health-smoke-%d" % i) for i in range(N_KEYS)]
        for i, key in enumerate(keys):
            assert runners[1 + i % (N_NODES - 1)].put_sync(
                key, Value(b"hv-%d" % i, value_id=i + 1),
                timeout=OP_TIMEOUT)
        for key in keys:
            assert runners[0].get_sync(key, timeout=OP_TIMEOUT)

        # --- 2a: replica coverage on the live cluster — every stored
        # key's true closest-8 (one batched launch; 3 nodes < 8, so
        # every node is an expected replica) actually holds the value
        cov = hm.replica_coverage(runners, sample_max=N_KEYS,
                                  device=device)
        assert cov["keys"] > 0, "probe sampled no stored keys"
        assert cov["mean_coverage"] is not None \
            and cov["mean_coverage"] >= 0.5, cov
        # --- 2b: dhtmon green on the healthy cluster
        rc = dhtmon.main(["--nodes", "127.0.0.1:%d" % proxy.port,
                          "--min-success", "0.99", "--require-ready",
                          "--alert", "p99=%g" % (OP_TIMEOUT * 4)])
        assert rc == 0, "dhtmon flagged a healthy cluster (rc=%d)" % rc

        # --- 3: inject a real degradation — choke ingest admission on
        # node 0 so every NEW op sheds at the ingest backpressure
        # boundary (the queue-bound failure mode), which fails the ops
        # and fast-burns the availability SLO
        wb = runners[0]._dht.wave_builder
        saved_max = wb.queue_max
        wb.queue_max = 0
        fails = []
        for i in range(10):
            runners[0].get(keys[i % N_KEYS], lambda vals: True,
                           lambda ok, ns: fails.append(ok))
        assert _wait(lambda: len(fails) == 10), "shed gets never completed"
        assert not any(fails), "gets unexpectedly succeeded while choked"
        # wait for the SPECIFIC injected failure — the get-availability
        # SLO fast-burning to unhealthy — not just any verdict motion
        # (an unrelated signal wobble must not satisfy this check)
        assert _wait(lambda: runners[0].get_health()["slo"].get(
            "get_availability", {}).get("level") == "unhealthy",
            timeout=15.0), \
            "get SLO never fast-burned: %r" % (runners[0].get_health(),)
        rep = runners[0].get_health()
        assert rep["verdict"] == "unhealthy", rep
        assert "get_availability" in rep["causes"], rep
        # the degradation is trace-correlatable: health_transition and
        # slo_violation events in the flight recorder (name-filtered
        # dump)
        fr = runners[0].get_flight_recorder(name="health_transition")
        assert any(e["attrs"].get("to") == "unhealthy"
                   for e in fr["events"]), fr["events"]
        fr = runners[0].get_flight_recorder(name="slo_violation")
        assert fr["events"], "no slo_violation event recorded"
        code, body = _healthz(proxy.port)
        assert code == 503 and body["verdict"] == "unhealthy", (code, body)

        # --- 4: dhtmon exits non-zero on the violated cluster
        # invariant (global lookup success dropped below threshold)
        rc = dhtmon.main(["--nodes", "127.0.0.1:%d" % proxy.port,
                          "--min-success", "0.99"])
        assert rc == 1, "dhtmon missed the success-rate violation " \
            "(rc=%d)" % rc
        wb.queue_max = saved_max
        # windowed invariant (review finding): the since-boot ratio
        # remembers the choke forever, but a windowed dhtmon evaluates
        # only recent traffic.  The window reads the
        # LAST 1 s of each node's history frames (no wait inside
        # dhtmon), so first let the burn roll out of that window —
        # with the choke lifted and no failures left in it, dhtmon no
        # longer alerts
        time.sleep(2.5)
        rc = dhtmon.main(["--nodes", "127.0.0.1:%d" % proxy.port,
                          "--min-success", "0.99", "--window", "1.0"])
        assert rc == 0, "windowed dhtmon alerted on a recovered " \
            "cluster (rc=%d)" % rc

        print("health_smoke: OK — healthz 503->200->503, verdict "
              "healthy->unhealthy (causes %s), coverage %.2f over %d "
              "keys (one batched closest-8 launch), dhtmon 0 then 1"
              % (rep["causes"], cov["mean_coverage"], cov["keys"]))
        return 0
    finally:
        if proxy is not None:
            proxy.stop()
        for r in runners:
            r.join()


if __name__ == "__main__":
    sys.exit(main())
