"""End-to-end wave-scale listen/push smoke.

Boots a 3-node real-UDP cluster + REST proxy (node 0 runs the batched
listener table; node 1 runs ``listen_batching="off"`` — the live half
of the batched == off pin) and asserts the four things the unit tier
cannot:

1. **Scale**: >= 512 live listeners register across runner ops and
   proxy SUBSCRIBE/LISTEN registrations and ALL of them deliver.
2. **Result equivalence on every delivery surface**: a Zipf put flood
   delivers through node 0's batched match with the same per-key value
   sets as node 1's synchronous path — on runner callbacks (every one
   of the key's listeners agrees), on the proxy LISTEN stream, and on
   SUBSCRIBE push dispatches (observed through the injected
   ``push_sender``).
3. **Observability**: ``dht_listener_*`` occupancy/latency series
   advance on the proxy's Prometheus ``GET /stats`` and ``GET
   /listeners`` reflects the table.
4. **The dhtmon gate**: ``--max-listener-lag`` reads 0 on the healthy
   cluster and flips to 1 under an injected drain stall (the flush
   path wedged while puts buffer, then released — the delivery arrives
   LATE and the windowed lag p95 crosses the gate).

Run directly::

    python -m opendht_tpu_torch.testing.listener_smoke [--cpu]

Its nodes run on the CUDA card unless ``--cpu`` is given; without a card
(and without ``--cpu``) it raises before any socket is bound.

The port's copy of the JAX package's ``testing/listener_smoke.py``,
behaviour unchanged but for the nodes' device.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.request

from ..core.value import Value
from .._device import resolve_device
from ..infohash import InfoHash
from ..runtime.config import Config, NodeStatus
from ..runtime.runner import DhtRunner, RunnerConfig
from ..tools import dhtmon

N_NODES = 3
N_KEYS = 24                 # flood keys
PER_KEY = 21                # node-0 runner listeners per key (24*21 = 504)
N_SUBSCRIBE = 15            # proxy push registrations (keys 0..14)
OP_TIMEOUT = 30.0
LAG_GATE = 0.25             # dhtmon --max-listener-lag threshold (s)
STALL_S = 0.8               # injected drain-stall duration


def _wait(pred, timeout=30.0, step=0.05) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _get_text(port: int, path: str) -> str:
    with urllib.request.urlopen(
            "http://127.0.0.1:%d/%s" % (port, path), timeout=10) as r:
        return r.read().decode()


def _series(stats_text: str, prefix: str) -> dict:
    out = {}
    for ln in stats_text.splitlines():
        if ln.startswith(prefix) and " " in ln:
            name, val = ln.rsplit(" ", 1)
            try:
                out[name] = float(val)
            except ValueError:
                pass
    return out


def main(argv=None) -> int:
    from ..proxy import DhtProxyServer
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    resolve_device(device)        # no card and no --cpu: raise here

    runners = []
    proxy = None
    stream_resp = None
    try:
        pushes = []                     # (client_id, payload) dispatches

        for i in range(N_NODES):
            cfg = Config(node_id=InfoHash.get("listener-smoke-node-%d" % i))
            if i == 1:
                cfg.listen_batching = "off"   # the equivalence arm
            if i == 0:
                # slow frame cadence: the lag-p95 gauge holds each
                # completed window long enough for dhtmon to scrape it
                cfg.history.period = 2.0
            r = DhtRunner()
            r.run(0, RunnerConfig(dht_config=cfg), device=device)
            runners.append(r)
            if i == 0:
                proxy = DhtProxyServer(
                    r, 0, push_sender=lambda cid, data:
                        pushes.append((cid, data)))
            else:
                r.bootstrap("127.0.0.1", runners[0].get_bound_port())
        assert _wait(lambda: all(
            r.get_status() is NodeStatus.CONNECTED for r in runners)), \
            "cluster failed to connect"

        keys = [InfoHash.get("listener-smoke-key-%d" % i)
                for i in range(N_KEYS)]

        # --- 1: register the fleet.  node 0: PER_KEY runner listeners
        # per key (each its own collector, so per-listener agreement is
        # checkable); node 1: one off-arm collector per key; proxy: a
        # LISTEN stream + N_SUBSCRIBE push registrations on node 0.
        heard0 = [[set() for _ in range(PER_KEY)] for _ in range(N_KEYS)]
        heard1 = [set() for _ in range(N_KEYS)]

        def collector(sink: set):
            def cb(vals, expired):
                if not expired:
                    sink.update(v.id for v in vals)
                return True
            return cb

        live = 0
        futs = []

        def _drain():
            nonlocal live
            for f in futs:
                tok = f.result(OP_TIMEOUT)
                assert tok != 0, "listen shed by ingest backpressure"
                live += 1
            del futs[:]

        for ki, key in enumerate(keys):
            for li in range(PER_KEY):
                futs.append(runners[0].listen(
                    key, collector(heard0[ki][li])))
            futs.append(runners[1].listen(key, collector(heard1[ki])))
            _drain()                    # chunked: one key's fleet at a time

        # LISTEN stream on key 0 (one JSON line per value; heartbeat
        # lines carry no "id")
        stream_ids: set = set()
        stream_resp = urllib.request.urlopen(urllib.request.Request(
            "http://127.0.0.1:%d/%s" % (proxy.port, keys[0].hex()),
            method="LISTEN"), timeout=120)

        def _drain_stream():
            for ln in stream_resp:
                try:
                    obj = json.loads(ln)
                except ValueError:
                    continue
                if "id" in obj and not obj.get("expired"):
                    stream_ids.add(int(obj["id"]))
        threading.Thread(target=_drain_stream, daemon=True).start()
        live += 1

        for si in range(N_SUBSCRIBE):
            req = urllib.request.Request(
                "http://127.0.0.1:%d/%s" % (proxy.port, keys[si].hex()),
                data=json.dumps({"client_id": "push-client-%d" % si,
                                 "token": si + 1}).encode(),
                method="SUBSCRIBE")
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert json.loads(resp.read())["token"], "subscribe failed"
            live += 1
        assert live >= 512, "only %d live listeners registered" % live

        # let the registration burst's search traffic settle before the
        # flood (the 500-listener spike can briefly backlog the reader)
        time.sleep(2.0)
        assert _wait(lambda: all(
            r.get_status() is NodeStatus.CONNECTED for r in runners)), \
            "cluster lost connectivity under the listener fleet"

        # --- 2: Zipf put flood from node 2 — key i draws ~ 1/(i+1)
        # of the traffic, unique value ids per key
        expect = [set() for _ in range(N_KEYS)]
        vid = 0
        for rank, key in enumerate(keys):
            n_puts = max(1, 36 // (rank + 1))
            for _ in range(n_puts):
                vid += 1
                v = Value(b"flood-%05d" % vid, value_id=vid)
                ok = False
                for _attempt in range(3):     # ride out transient backlog
                    if runners[2].put_sync(key, v, timeout=OP_TIMEOUT):
                        ok = True
                        break
                    time.sleep(0.5)
                assert ok, "put %d failed after retries" % vid
                expect[rank].add(vid)

        # batched == off on every surface, all listeners agree
        def all_delivered() -> bool:
            for ki in range(N_KEYS):
                if heard1[ki] != expect[ki]:
                    return False
                for li in range(PER_KEY):
                    if heard0[ki][li] != expect[ki]:
                        return False
            return stream_ids == expect[0]
        assert _wait(all_delivered, timeout=60.0), \
            "batched/off delivery sets diverged: key0 batched %r off %r " \
            "stream %r expect %r" % (heard0[0][0], heard1[0],
                                     stream_ids, expect[0])
        for si in range(N_SUBSCRIBE):
            want = expect[si]
            got = set()
            for cid, data in list(pushes):
                if cid == "push-client-%d" % si and not data.get("expired"):
                    got.update(int(i) for i in data.get("ids", []))
            assert want <= got, \
                "push surface missed values for key %d: %r vs %r" \
                % (si, sorted(got), sorted(want))

        # --- 3: series advance on the Prometheus surface
        stats = _get_text(proxy.port, "stats")
        occ = _series(stats, "dht_listener_occupancy")
        fl = _series(stats, "dht_listener_flushes_total")
        mt = _series(stats, "dht_listener_matches_total")
        lag = _series(stats, "dht_listener_lag_p95")
        assert occ and max(occ.values()) >= N_KEYS, occ
        assert fl and max(fl.values()) > 0, fl
        assert mt and max(mt.values()) > 0, mt
        assert lag, "no dht_listener_lag_p95 series on /stats"
        lsnap = json.loads(_get_text(proxy.port, "listeners"))
        assert lsnap["enabled"] and lsnap["occupancy"] >= N_KEYS, lsnap

        # --- 4: dhtmon gate — 0 healthy, 1 under an injected drain
        # stall.  Healthy first: nothing above the gate (unknown/-1
        # never violates, live lags sit ~flush_deadline << LAG_GATE).
        node = "127.0.0.1:%d" % proxy.port
        rc = dhtmon.main(["--nodes", node,
                          "--max-listener-lag", str(LAG_GATE)])
        assert rc == 0, "dhtmon flagged a healthy listener path (rc=%d)" \
            % rc

        # stall injection: wedge the drain (flush no-ops while puts
        # buffer), release after STALL_S, kick a wave — the buffered
        # delivery lands LATE and the next lag window crosses the gate
        lt = runners[0]._dht.listener_table
        flipped = False
        for attempt in range(3):
            vid += 1
            lt.pending = lambda: 0            # wedge: flush sees empty
            try:
                assert runners[1].put_sync(
                    keys[0], Value(b"stalled-%d" % vid, value_id=vid),
                    timeout=OP_TIMEOUT)
                time.sleep(STALL_S)
            finally:
                del lt.pending                # release the drain
            runners[0].get_sync(keys[0], timeout=OP_TIMEOUT)  # fire a wave
            if not _wait(lambda: (lt.lag_p95() or -1.0) > LAG_GATE,
                         timeout=8.0, step=0.1):
                continue
            if dhtmon.main(["--nodes", node, "--max-listener-lag",
                            str(LAG_GATE)]) == 1:
                flipped = True
                break
        assert flipped, "dhtmon never flagged the injected drain stall"

        print("listener_smoke: OK — %d live listeners, %d Zipf puts "
              "batched==off on runner/stream/push surfaces, series "
              "advanced (occupancy %d, flushes %d), lag gate 0 -> 1 "
              "under a %.1fs drain stall"
              % (live, vid, int(max(occ.values())),
                 int(max(fl.values())), STALL_S))
        return 0
    finally:
        if stream_resp is not None:
            try:
                stream_resp.close()
            except Exception:
                pass
        if proxy is not None:
            proxy.stop()
        for r in runners:
            r.join()


if __name__ == "__main__":
    sys.exit(main())
