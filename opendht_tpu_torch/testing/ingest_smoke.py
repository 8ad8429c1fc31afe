"""Burst-ingest CI smoke.

Boots a real-UDP cluster + REST proxy, fires concurrent gets/puts/
listens from threads — the traffic shape the continuous-batching wave
builder exists for — and asserts the three things the unit tier cannot:

1. **Live coalescing actually happens**: the mean of the new
   ``dht_ingest_wave_occupancy`` histogram is > 1 under concurrent
   load (ops genuinely shared device launches; nothing was shed), and
   the ``dht_ingest_*`` series ride the proxy's Prometheus ``GET
   /stats`` exposition (satellite 6's export surface).
2. **Result equivalence**: the identical workload rerun with
   ``ingest_batching="off"`` (the per-op dispatch escape hatch, on the
   same deterministic node ids) returns the same values to every get,
   delivers the same values to every listener, and leaves the same
   per-node storage state.
3. **Backpressure discipline**: nothing was dropped mid-search — the
   shed counter stayed zero for the whole admitted workload.

Run directly::

    python -m opendht_tpu_torch.testing.ingest_smoke [--cpu]

Its nodes run on the CUDA card unless ``--cpu`` is given; without a card
(and without ``--cpu``) it raises before any socket is bound.

The port's copy of the JAX package's ``testing/ingest_smoke.py``,
behaviour unchanged but for the nodes' device.
"""

from __future__ import annotations

import sys
import threading
import time
import urllib.request

from .. import telemetry
from ..core.value import Value
from .._device import resolve_device
from ..infohash import InfoHash
from ..runtime.config import Config, NodeStatus
from ..runtime.runner import DhtRunner, RunnerConfig

N_NODES = 3
N_KEYS = 16
OP_TIMEOUT = 30.0


def _wait(pred, timeout=30.0, step=0.05) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _run_phase(batching: str, device=None) -> dict:
    """One full cluster lifecycle under the given ingest mode; returns
    the result-equivalence record (get results, listen deliveries,
    per-node storage) plus the phase's ingest telemetry.  The nodes run
    on ``device`` (None = the CUDA card)."""
    reg = telemetry.get_registry()
    reg.reset()
    keys = [InfoHash.get("ingest-smoke-%d" % i) for i in range(N_KEYS)]
    listen_keys = keys[:2]

    runners = []
    proxy = None
    try:
        for i in range(N_NODES):
            cfg = Config(node_id=InfoHash.get("ingest-smoke-node-%d" % i),
                         ingest_batching=batching)
            r = DhtRunner()
            r.run(0, RunnerConfig(dht_config=cfg), device=device)
            if runners:
                r.bootstrap("127.0.0.1", runners[0].get_bound_port())
            runners.append(r)
        assert _wait(lambda: all(
            r.get_status() is NodeStatus.CONNECTED for r in runners[1:])), \
            "cluster failed to connect (batching=%s)" % batching

        from ..proxy import DhtProxyServer
        proxy = DhtProxyServer(runners[0], 0)

        # standing listeners (registered before the burst; their values
        # must flow regardless of ingest mode)
        heard: dict = {}
        heard_lock = threading.Lock()

        def on_values(vals, expired):
            if not expired:
                with heard_lock:
                    for v in vals:
                        heard[v.data] = True
            return True

        tokens = [runners[1].listen(k, on_values) for k in listen_keys]
        for t in tokens:
            assert t.result(OP_TIMEOUT) != 0, "listen shed at admission"

        # ---- concurrent burst: every op posted before any completes,
        # from several threads, so the runner drains them in shared
        # pumps and the wave builder sees real concurrency
        put_done = {i: threading.Event() for i in range(N_KEYS)}
        put_ok = {}

        def fire_put(i):
            src = runners[1 + (i % (N_NODES - 1))]
            src.put(keys[i], Value(b"ingest-%d" % i, value_id=i + 1),
                    lambda ok, ns, _i=i: (put_ok.setdefault(_i, ok),
                                          put_done[_i].set()))

        threads = [threading.Thread(target=fire_put, args=(i,))
                   for i in range(N_KEYS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(N_KEYS):
            assert put_done[i].wait(OP_TIMEOUT), "put %d stalled" % i
            assert put_ok[i], "put %d failed (batching=%s)" % (i, batching)

        got: dict = {}
        get_done = {i: threading.Event() for i in range(N_KEYS)}

        def fire_get(i):
            vals: list = []
            runners[0].get(
                keys[i], lambda vs, _a=vals: _a.extend(vs) or True,
                lambda ok, ns, _i=i, _a=vals: (
                    got.setdefault(_i, sorted(v.data for v in _a)),
                    get_done[_i].set()))

        threads = [threading.Thread(target=fire_get, args=(i,))
                   for i in range(N_KEYS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(N_KEYS):
            assert get_done[i].wait(OP_TIMEOUT), "get %d stalled" % i
            assert got[i] == [b"ingest-%d" % i], \
                "get %d returned %r (batching=%s)" % (i, got[i], batching)

        assert _wait(lambda: len(heard) >= len(listen_keys)), \
            "listeners missed burst values: %r" % sorted(heard)

        # ---- phase telemetry + the proxy export surface
        snap = reg.snapshot()
        with urllib.request.urlopen(
                "http://127.0.0.1:%d/stats" % proxy.port, timeout=10) as r:
            prom = r.read().decode()
        import json as _json
        with urllib.request.urlopen(
                "http://127.0.0.1:%d/" % proxy.port, timeout=10) as r:
            node_info = _json.loads(r.read().decode())

        # ---- per-node storage state (created stamps differ run to
        # run; the packed value payloads must not)
        storage = []
        for r in runners:
            exported = sorted(
                (key.hex(), sorted(bytes(p) for _c, p in vals))
                for key, vals in r.export_values())
            storage.append(exported)
        return {
            "gets": got,
            "heard": sorted(heard),
            "storage": storage,
            "snapshot": snap,
            "prometheus": prom,
            "node_info": node_info,
        }
    finally:
        if proxy is not None:
            proxy.stop()
        for r in runners:
            r.join()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    resolve_device(device)        # no card and no --cpu: raise here
    batched = _run_phase("on", device)

    occ = batched["snapshot"]["histograms"].get(
        "dht_ingest_wave_occupancy", {"count": 0, "sum": 0.0})
    assert occ["count"] > 0, "no ingest waves fired under load"
    mean_occ = occ["sum"] / occ["count"]
    assert mean_occ > 1.0, (
        "no live coalescing: mean wave occupancy %.3f <= 1 over %d waves"
        % (mean_occ, occ["count"]))
    sheds = sum(v for k, v in batched["snapshot"]["counters"].items()
                if k.startswith("dht_ingest_sheds_total"))
    assert sheds == 0, "admitted workload was shed (%d drops)" % sheds
    for series in ("dht_ingest_queue_depth", "dht_ingest_wave_occupancy",
                   "dht_ingest_queue_seconds", "dht_ingest_waves_total"):
        assert series in batched["prometheus"], \
            "proxy /stats missing %s" % series
    assert batched["node_info"].get("ingest", {}).get("batching") == "on", \
        "proxy GET / missing the ingest section"

    off = _run_phase("off", device)
    occ_off = off["snapshot"]["histograms"].get(
        "dht_ingest_wave_occupancy", {"count": 0})
    assert occ_off["count"] == 0, "batching=off must never build waves"

    # ---- the acceptance-criteria equivalence: same values returned,
    # same listener deliveries, same storage state
    assert batched["gets"] == off["gets"], "get results diverged"
    assert batched["heard"] == off["heard"], "listen deliveries diverged"
    assert batched["storage"] == off["storage"], (
        "per-node storage state diverged between batched and per-op "
        "dispatch")

    waves = int(batched["snapshot"]["counters"].get(
        "dht_ingest_waves_total", 0))
    print("ingest_smoke: OK — %d waves, mean occupancy %.2f (p-ops %d), "
          "0 sheds, batched == per-op on %d gets / %d listens / %d nodes"
          % (waves, mean_occ, N_KEYS * 2 + len(batched["heard"]),
             N_KEYS, len(batched["heard"]), N_NODES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
