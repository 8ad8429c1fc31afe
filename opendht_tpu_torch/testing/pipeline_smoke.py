"""Wave-pipeline CI smoke.

Boots the same real-UDP 3-node cluster + REST proxy as
``ingest_smoke`` and runs the same concurrent mixed burst (puts, gets,
standing listeners), but exercises the double-buffered wave
pipeline and asserts the three things only a live cluster can:

1. **The pipeline actually holds waves in flight**: with
   ``ingest_pipeline_depth=2`` the ``dht_ingest_pipeline_inflight_peak``
   gauge reaches ≥ 2 under sustained traffic (a slow-ready shim on one
   node's launch handle makes the deferral deterministic — live
   cluster tables are host-scan sized, so real handles materialize
   before the next fire), and both pipeline series ride the proxy's
   Prometheus ``GET /stats`` exposition.
2. **Stage histograms advance with async dispatch**: the always-on
   waterfall still observes queue_wait / device stage / scatter_back
   for pipelined waves (the device stage is measured at *consume*
   — dispatch + blocking wait, see waterfall.py).
3. **Depth-2 equivalence on every surface**: the identical workload
   rerun with ``ingest_pipeline_depth=1`` (the exact pre-pipeline
   serial path) returns the same values to every get, delivers the
   same values to every listener, and leaves the same per-node
   storage state.

Run directly::

    python -m opendht_tpu_torch.testing.pipeline_smoke [--cpu]

Its nodes run on the CUDA card unless ``--cpu`` is given; without a card
(and without ``--cpu``) it raises before any socket is bound.

The port's copy of the JAX package's ``testing/pipeline_smoke.py``,
behaviour unchanged but for the nodes' device and where the in-flight
peak is read: node 0's wave builder's own windowed peak, taken right
after the stack probe.  The exported ``dht_ingest_pipeline_inflight_peak``
gauge is one series that every builder of the process sets at its
history frame (to its own windowed peak), so with three nodes in one
process a frame of node 1 or 2 between the probe and the JAX copy's
read of the gauge sets it to their 0; its presence on ``/stats`` is
still checked.
"""

from __future__ import annotations

import sys
import threading
import time
import urllib.request

from .. import telemetry, waterfall
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


class _SlowReady:
    """Launch-handle wrapper that reports not-ready until a NEWER
    launch exists (or a 50 ms fallback for tail waves with no
    successor).  Cluster tables are host-scan sized, so real handles
    materialize instantly — without this shim a wave always drains
    before the next one fires and the pipeline never visibly stacks.
    Results are untouched: ``consume()`` is the real handle's."""

    def __init__(self, handle, state, idx):
        self._h = handle
        self.shard_t = handle.shard_t
        self._state = state
        self._idx = idx
        self._t0 = time.monotonic()

    def ready(self):
        # our own launch already bumped the counter to idx+1 — a NEWER
        # launch exists only beyond that
        if self._state["launches"] <= self._idx + 1 \
                and time.monotonic() - self._t0 < 0.05:
            return False
        return self._h.ready()

    def consume(self):
        return self._h.consume()


def _slow_launches(runner) -> dict:
    """Shim every launch handle of ``runner``'s inner Dht slow-ready;
    returns the shared launch-counter state (the stack probe watches
    it to time its second op)."""
    inner = runner._dht._dht
    real = inner.find_closest_nodes_launch
    state = {"launches": 0}

    def launch(targets, af, count):
        idx = state["launches"]
        state["launches"] = idx + 1
        return _SlowReady(real(targets, af, count), state, idx)

    inner.find_closest_nodes_launch = launch
    return state


def _run_phase(depth: int, device=None) -> dict:
    """One full cluster lifecycle at the given pipeline depth; returns
    the result-equivalence record (get results, listen deliveries,
    per-node storage) plus the phase's telemetry surfaces.  The nodes
    run on ``device`` (None = the CUDA card)."""
    reg = telemetry.get_registry()
    reg.reset()
    keys = [InfoHash.get("pipeline-smoke-%d" % i) for i in range(N_KEYS)]
    listen_keys = keys[:2]

    runners = []
    proxy = None
    try:
        for i in range(N_NODES):
            cfg = Config(node_id=InfoHash.get("pipeline-smoke-node-%d" % i),
                         ingest_pipeline_depth=depth)
            r = DhtRunner()
            r.run(0, RunnerConfig(dht_config=cfg), device=device)
            if runners:
                r.bootstrap("127.0.0.1", runners[0].get_bound_port())
            runners.append(r)
        assert _wait(lambda: all(
            r.get_status() is NodeStatus.CONNECTED for r in runners[1:])), \
            "cluster failed to connect (depth=%d)" % depth
        states = []
        if depth > 1:
            states = [_slow_launches(r) for r in runners]

        from ..proxy import DhtProxyServer
        proxy = DhtProxyServer(runners[0], 0)

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

        # ---- concurrent burst (same shape as ingest_smoke: every op
        # posted before any completes → the builder fires real waves
        # back to back, which is what keeps the pipeline stacked)
        put_done = {i: threading.Event() for i in range(N_KEYS)}
        put_ok = {}

        def fire_put(i):
            src = runners[1 + (i % (N_NODES - 1))]
            src.put(keys[i], Value(b"pipeline-%d" % i, value_id=i + 1),
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
            assert put_ok[i], "put %d failed (depth=%d)" % (i, depth)

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
            assert got[i] == [b"pipeline-%d" % i], \
                "get %d returned %r (depth=%d)" % (i, got[i], depth)

        assert _wait(lambda: len(heard) >= len(listen_keys)), \
            "listeners missed burst values: %r" % sorted(heard)

        if depth > 1:
            # ---- stack probe: organic localhost traffic serializes
            # per builder (every concurrent refill coalesces into one
            # wave, and the NEXT wave's submits only exist once this
            # wave's results are out), so force the stack explicitly:
            # op A's wave launches and is held by the shim; op B's wave
            # then fires while A is still in flight — the in-flight
            # peak gauge records 2 the moment B's wave is appended.
            st = states[0]
            base = st["launches"]
            ev_a, ev_b = threading.Event(), threading.Event()
            runners[0].get(InfoHash.get("pipeline-stack-a"),
                           lambda vs: True,
                           lambda ok, ns: ev_a.set())
            assert _wait(lambda: st["launches"] > base, step=0.005), \
                "stack probe: op A's wave never launched"
            runners[0].get(InfoHash.get("pipeline-stack-b"),
                           lambda vs: True,
                           lambda ok, ns: ev_b.set())
            assert ev_a.wait(OP_TIMEOUT) and ev_b.wait(OP_TIMEOUT), \
                "stack probe ops stalled"
        # node 0's own windowed peak (the module docstring)
        held = runners[0]._dht.wave_builder.pipeline_snapshot()[
            "inflight_peak"]

        snap = reg.snapshot()
        with urllib.request.urlopen(
                "http://127.0.0.1:%d/stats" % proxy.port, timeout=10) as r:
            prom = r.read().decode()

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
            "inflight_peak": held,
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
    wf_before = {
        s: d.get("count", 0)
        for s, d in waterfall.get_profiler().snapshot()["stages"].items()}

    piped = _run_phase(2, device)

    # 1. the pipeline held ≥ 2 waves in flight, on the export surface
    peak = piped["inflight_peak"]
    assert peak >= 2, (
        "pipeline never held 2 waves in flight (node 0's peak %r, the "
        "shared gauge %r)" % (peak, piped["snapshot"]["gauges"].get(
            "dht_ingest_pipeline_inflight_peak", 0)))
    for series in ("dht_ingest_pipeline_inflight",
                   "dht_ingest_pipeline_inflight_peak"):
        assert series in piped["prometheus"], \
            "proxy /stats missing %s" % series
    sheds = sum(v for k, v in piped["snapshot"]["counters"].items()
                if k.startswith("dht_ingest_sheds_total"))
    assert sheds == 0, "admitted workload was shed (%d drops)" % sheds

    # 2. async dispatch still feeds the waterfall (device stage is
    # observed at consume now — counts must advance, not freeze)
    wf_after = {
        s: d.get("count", 0)
        for s, d in waterfall.get_profiler().snapshot()["stages"].items()}
    for stage in ("queue_wait", "scatter_back"):
        assert wf_after.get(stage, 0) > wf_before.get(stage, 0), (
            "stage %s froze under the pipeline (%r -> %r)"
            % (stage, wf_before.get(stage), wf_after.get(stage)))
    dev = sum(wf_after.get(s, 0) - wf_before.get(s, 0)
              for s in ("device_compile", "device_launch"))
    assert dev > 0, "device stage froze under async dispatch"

    serial = _run_phase(1, device)

    # 3. the acceptance-criteria equivalence: depth 2 == depth 1 on
    # every surface
    assert piped["gets"] == serial["gets"], "get results diverged"
    assert piped["heard"] == serial["heard"], "listen deliveries diverged"
    assert piped["storage"] == serial["storage"], (
        "per-node storage state diverged between depth 2 and depth 1")

    waves = int(piped["snapshot"]["counters"].get(
        "dht_ingest_waves_total", 0))
    print("pipeline_smoke: OK — %d waves, inflight peak %d, 0 sheds, "
          "depth2 == depth1 on %d gets / %d listens / %d nodes"
          % (waves, peak, N_KEYS, len(piped["heard"]), N_NODES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
