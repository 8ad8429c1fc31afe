"""End-to-end flight-data-recorder smoke.

Boots a 3-node real-UDP cluster + REST proxy and asserts what the unit
tier cannot:

1. **dhtmon windows read history, not scrape-diff-scrape**: with every
   node exporting ``GET /history``, ``run_checks(window=...)`` sources
   its windowed invariants from the recorders (``window_source ==
   "history"``, no wait) and the result is PINNED EQUAL to the legacy
   evaluation of the same interval.
2. **An induced SLO burn materializes a black-box bundle**: choking
   ingest admission fast-burns the availability SLO (the health
   failure mode); the unhealthy transition auto-captures a bundle whose
   history frames SHOW the burn (``ok="false"`` get deltas), and
   ``GET /debug/bundle`` serves fresh bundles over the proxy.
3. **dhtmon --since gates on the windowed invariant**: nonzero while
   the burn sits in the history window, 0 again once recovery rolls it
   out — no second scrape, no sleep inside dhtmon.
4. **The bundle round-trips through the cluster timeline assembler**
   with the health transition present and per-node frame monotonicity
   clean.
5. **Ring and spill stay bounded under a 10x flood** (RSS- and
   disk-stable; oldest evicted on both).

Run directly::

    python -m opendht_tpu_torch.testing.history_smoke [--cpu]

Its nodes run on the CUDA card unless ``--cpu`` is given; without a card
(and without ``--cpu``) it raises before any socket is bound.

The port's copy of the JAX package's ``testing/history_smoke.py``,
behaviour unchanged but for the nodes' device and the choke of step 2,
which :func:`choke_ingest` makes in one pump of the node's DHT thread
(the JAX copy's choke races the node's health tick: ROADMAP C.3).
"""

from __future__ import annotations

import json
import sys
import tempfile
import threading
import time

from ..core.value import Value
from .._device import resolve_device
from ..infohash import InfoHash
from ..history import BUNDLE_KIND, HistoryConfig, MetricsHistory
from ..runtime.config import Config, NodeStatus
from ..runtime.runner import DhtRunner, RunnerConfig
from ..telemetry import MetricsRegistry
from ..tools import dhtmon
from . import health_monitor as hm
from . import timeline_assembler as ta

N_NODES = 3
N_KEYS = 10
OP_TIMEOUT = 30.0
TICK = 0.25


def _wait(pred, timeout=30.0, step=0.05) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(step)
    return pred()


def choke_ingest(runner, keys, n: int, fails: list) -> None:
    """Choke ``runner``'s ingest admission (``queue_max`` 0), issue
    ``n`` gets over ``keys``, which it sheds at once (each appends its
    ``ok`` to ``fails``), and record a history frame: all in one pump of
    the runner's DHT thread, held while they are queued, so that no
    health tick runs between the choke and the frame that holds the
    failed gets.  (The JAX copy sets ``queue_max`` from the calling
    thread and then posts the gets: a health tick in between reads the
    ``ingest_queue`` signal live at 1.0, turns unhealthy and captures
    its black-box bundle before any frame holds a failed get.)"""
    wb = runner._dht.wave_builder
    held, release = threading.Event(), threading.Event()

    def hold(_dht):
        held.set()
        release.wait(30.0)
    runner._post(hold, prio=True)
    try:
        assert held.wait(30.0), "the DHT thread never ran the hold op"
        runner._post(lambda _dht: setattr(wb, "queue_max", 0))
        for i in range(n):
            runner.get(keys[i % len(keys)], lambda vals: True,
                       lambda ok, ns: fails.append(ok))
        runner._post(lambda _dht: runner._history.tick())
    finally:
        release.set()


def ring_spill_bounded_check(factor: int = 10) -> None:
    """10x the ring capacity of busy frames: the ring must stay at
    capacity (oldest evicted), the spill at its segment bound (oldest
    segment deleted), and RSS must not retain O(total)."""
    import resource

    cap, seg, max_seg = 128, 16, 3
    reg = MetricsRegistry()
    clock = [0.0]
    with tempfile.TemporaryDirectory(prefix="odt-hist-flood-") as d:
        rec = MetricsHistory(
            HistoryConfig(period=1.0, capacity=cap, spill_dir=d,
                          spill_segment_frames=seg,
                          spill_max_segments=max_seg),
            registry=reg, clock=lambda: clock[0])
        c = reg.counter("flood_total")
        h = reg.histogram("flood_seconds")
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        total = cap * factor
        rec.tick()
        for i in range(total):
            clock[0] += 1.0
            c.inc(i + 1)
            h.observe(float(i % 7) + 0.1)
            rec.tick()
        frames = rec.frames()
        assert len(frames) == cap, \
            "ring grew past capacity: %d" % len(frames)
        assert frames[0]["seq"] == total - cap + 1, \
            "oldest retained is %d, expected %d" % (
                frames[0]["seq"], total - cap + 1)
        assert rec.spill_segments <= max_seg, \
            "spill grew past its bound: %d segments" % rec.spill_segments
        spilled = rec.spilled_frames()
        assert 0 < len(spilled) <= max_seg * seg
        rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        grown_kib = rss1 - rss0
        assert grown_kib < 32 * 1024, \
            "RSS grew %d KiB over a %d-frame flood" % (grown_kib, total)


def main(argv=None) -> int:
    from ..proxy import DhtProxyServer
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    resolve_device(device)        # no card and no --cpu: raise here

    runners = []
    proxy = None
    try:
        for i in range(N_NODES):
            cfg = Config(node_id=InfoHash.get("history-smoke-node-%d" % i))
            cfg.health.period = TICK
            cfg.history.period = TICK
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

        # --- traffic so the windows have data
        keys = [InfoHash.get("history-smoke-%d" % i) for i in range(N_KEYS)]
        for i, key in enumerate(keys):
            assert runners[1 + i % (N_NODES - 1)].put_sync(
                key, Value(b"hv-%d" % i, value_id=i + 1),
                timeout=OP_TIMEOUT)
        for key in keys:
            assert runners[0].get_sync(key, timeout=OP_TIMEOUT)
        # let the recorders tick the traffic into frames, then quiesce
        time.sleep(3 * TICK)

        # --- 1: dhtmon's window comes from history (no wait), pinned
        # equal to the legacy paths over the same interval.  The
        # cluster is quiet now, so (a) a long history window holds
        # exactly the cumulative traffic (all ops happened after the
        # first recorder tick), and (b) a scrape-diff window would
        # measure an empty interval — the history path must agree with
        # each.
        t0 = time.monotonic()
        _v, doc_h = dhtmon.run_checks([ep], min_success=0.5, window=60.0)
        assert doc_h["window_source"] == "history", doc_h
        assert time.monotonic() - t0 < 5.0, \
            "history-backed window should not sleep out the window"
        _v, doc_c = dhtmon.run_checks([ep], min_success=0.5)
        assert doc_h["lookup_success"] == doc_c["lookup_success"], \
            (doc_h["lookup_success"], doc_c["lookup_success"])
        saved_scrape = hm.scrape_history
        try:
            hm.scrape_history = lambda *a, **kw: None   # node "lacks" it
            _v, doc_f = dhtmon.run_checks([ep], min_success=0.5,
                                          window=1.0)
        finally:
            hm.scrape_history = saved_scrape
        assert doc_f["window_source"] == "scrape-diff", doc_f
        _v, doc_q = dhtmon.run_checks([ep], min_success=0.5, window=1.0)
        assert doc_q["window_source"] == "history"
        # both quiet-window evaluations see no traffic: unknown, equal
        assert doc_q["lookup_success"] == doc_f["lookup_success"], \
            (doc_q["lookup_success"], doc_f["lookup_success"])

        # --- 2: induce the SLO burn (ingest backpressure choke) and
        # assert the black box materializes
        assert not runners[0].get_bundles(), \
            "unexpected pre-burn auto bundle"
        wb = runners[0]._dht.wave_builder
        saved_max = wb.queue_max
        fails = []
        choke_ingest(runners[0], keys, 10, fails)
        assert _wait(lambda: len(fails) == 10), "shed gets never completed"
        assert not any(fails), "gets unexpectedly succeeded while choked"
        assert _wait(lambda: runners[0].get_health()["verdict"]
                     == "unhealthy", timeout=20.0), \
            "verdict never reached unhealthy: %r" % (
                runners[0].get_health(),)
        assert _wait(lambda: runners[0].get_bundles(), timeout=10.0), \
            "no auto-captured bundle after the unhealthy transition"
        bundle = runners[0].get_bundles()[-1]
        assert bundle["kind"] == BUNDLE_KIND
        assert bundle["reason"] == "health_transition"
        assert bundle["transition"]["to"] == "unhealthy"
        burn = sum(f["counters"].get(
            'dht_ops_total{ok="false",op="get"}', 0)
            for f in bundle["history"]["frames"])
        assert burn > 0, "burn not visible in the bundle's frames"
        # fresh bundles serve over the proxy and list the auto capture
        import urllib.request
        with urllib.request.urlopen(
                "http://%s/debug/bundle" % ep, timeout=10) as r:
            fresh = json.loads(r.read().decode())
        assert fresh["kind"] == BUNDLE_KIND
        assert fresh["auto_captures"], fresh["auto_captures"]

        # --- 3: dhtmon --since trips on the windowed invariant...
        rc = dhtmon.main(["--nodes", ep, "--min-success", "0.99",
                          "--since", "60"])
        assert rc == 1, "dhtmon --since missed the burn (rc=%d)" % rc
        # ...and clears once recovery rolls it out of the window — the
        # burn stays in the LONG window (the ring remembers), so the
        # short --since is what recovers; no sleep inside dhtmon
        wb.queue_max = saved_max
        time.sleep(8 * TICK)          # let the short window roll clean
        rc = dhtmon.main(["--nodes", ep, "--min-success", "0.99",
                          "--since", "1.0"])
        assert rc == 0, "dhtmon --since alerted on a recovered " \
            "cluster (rc=%d)" % rc

        # --- 4: the bundle round-trips through the timeline assembler
        # with the transition present
        bundle_rt = json.loads(json.dumps(bundle))
        sources = [hm.scrape_history(ep, 120.0),
                   runners[1].get_history(), runners[2].get_history(),
                   bundle_rt]
        assert sources[0] is not None
        tl = ta.assemble_timeline(sources)
        assert not tl["violations"], tl["violations"]
        assert len(tl["frames"]) > 3
        evs = ta.find_events(tl, "health_transition")
        assert any(e["attrs"].get("to") == "unhealthy" for e in evs), evs
        series = ta.window_series(tl)
        assert series.get('dht_ops_total{ok="false",op="get"}', 0) > 0

        # --- 5: bounded under flood
        ring_spill_bounded_check()

        print("history_smoke: OK — windows via %s (pinned equal), "
              "bundle captured on burn (%d failed-get deltas in "
              "frames), dhtmon --since 1 then 0, timeline %d frames/"
              "%d transition events, ring+spill bounded"
              % (doc_h["window_source"], int(burn),
                 len(tl["frames"]), len(evs)))
        return 0
    finally:
        if proxy is not None:
            proxy.stop()
        for r in runners:
            r.join()


if __name__ == "__main__":
    sys.exit(main())
