"""End-to-end hot-cache smoke.

Boots a 3-node real-UDP cluster + REST proxy (node 0 caches; nodes 1-2
run cache-off — the live halves of the cache-on == cache-off pin) and
asserts the five things the unit tier cannot:

1. **The observe→act loop closes on live traffic**: a Zipf single-key
   flood through node 0's wave builder surfaces the hot key
   (``hot_key_emerged`` in the ring), the cache ADMITS it off the
   observatory tick (``cache_admit`` event, ``GET /cache`` occupancy),
   and subsequent hot gets SERVE FROM CACHE — ``dht_cache_hits_total``
   advances while the ingest wave occupancy attributable to the hot key
   stays ~0 (the histogram's total barely moves under a pure hot-get
   burst).
2. **Hit ratio under flood**: the windowed ``dht_cache_hit_ratio``
   reaches >= 0.9 and ``dhtmon --min-cache-hit`` exits 0; a cold-key
   miss storm then drags the next window down and the same gate exits 1.
3. **Freshness**: a fresh put to the hot key invalidates the entry
   (``dht_cache_invalidations_total`` advances, occupancy drops) and the
   NEXT get sees the new value — never a stale hit.
4. **Result equivalence on every surface**: the cache-served value set
   on node 0 equals the full-path set on cache-off node 1 (runner ops),
   equals the proxy REST ``GET /{hash}`` stream, before AND after the
   invalidating put.
5. **Listeners are untouched**: a listener on the hot key still
   delivers a post-warm put (listens are never cache-served).

Run directly::

    python -m opendht_tpu_torch.testing.cache_smoke [--cpu]

Its nodes run on the CUDA card unless ``--cpu`` is given; without a card
(and without ``--cpu``) it raises before any socket is bound.

The port's copy of the JAX package's ``testing/cache_smoke.py``,
behaviour unchanged but for the nodes' device.
"""

from __future__ import annotations

import json
import sys
import time
import urllib.request

from ..core.value import Value
from .._device import resolve_device
from ..infohash import InfoHash
from ..runtime.config import Config, NodeStatus
from ..runtime.runner import DhtRunner, RunnerConfig
from ..tools import dhtmon

N_NODES = 3
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
            "http://127.0.0.1:%d/%s" % (port, path), timeout=10) as r:
        return json.loads(r.read().decode())


def _vals(values) -> set:
    return set((v.id, bytes(v.data)) for v in values)


def main(argv=None) -> int:
    from ..proxy import DhtProxyServer
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    resolve_device(device)        # no card and no --cpu: raise here

    runners = []
    proxy = None
    try:
        for i in range(N_NODES):
            cfg = Config(node_id=InfoHash.get("cache-smoke-node-%d" % i))
            # fast observatory cadence so admission converges in
            # seconds (the keyspace-smoke settings); node 0 caches,
            # the others are the cache-off equivalence arm
            cfg.keyspace.tick = 0.5
            cfg.keyspace.decay = 0.98
            cfg.keyspace.sample_stride = 1
            cfg.keyspace.hot_min_count = 16
            cfg.keyspace.min_observed = 24
            cfg.cache.enabled = (i == 0)
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

        hot = InfoHash.get("cache-smoke-hot")
        assert runners[0].put_sync(hot, Value(b"hot-v1", value_id=11),
                                   timeout=OP_TIMEOUT)
        before = _vals(runners[0].get_sync(hot, timeout=OP_TIMEOUT))
        assert before, "hot key unreadable before the flood"

        def metrics() -> dict:
            return runners[0].get_metrics()

        def counter(m, name, default=0.0):
            return float(m.get("counters", {}).get(name, default))

        def gauge(m, name, default=-1.0):
            return float(m.get("gauges", {}).get(name, default))

        node0 = str(runners[0].get_node_id())
        hits_key = 'dht_cache_hits_total{node="%s"}' % node0

        # --- 1: flood until the loop closes (hot detected -> admitted
        # -> a hot get actually SERVES from cache)
        def cache_serving() -> bool:
            return counter(metrics(), hits_key) > 0
        for _ in range(60):
            if cache_serving():
                break
            for _ in range(8):
                runners[0].get_sync(hot, timeout=OP_TIMEOUT)
        assert cache_serving(), \
            "hot gets never served from cache: %r" % (
                runners[0].get_cache(),)
        fr = runners[0].get_flight_recorder(name="hot_key_emerged")
        assert any(e["attrs"].get("key") == hot.hex()
                   for e in fr["events"]), "no hot_key_emerged event"
        fr = runners[0].get_flight_recorder(name="cache_admit")
        assert any(e["attrs"].get("key") == hot.hex()
                   for e in fr["events"]), "no cache_admit event"
        csnap = _get_json(proxy.port, "cache")
        assert csnap["enabled"] and csnap["occupancy"] >= 1, csnap
        assert hot.hex() in [e["key"] for e in csnap["entries"]], csnap

        # --- hot gets skip the [Q] lookup launch: under a pure hot-get
        # burst the hit counter advances ~1:1 while the ingest wave
        # occupancy histogram's total (entries that actually JOINED a
        # launch) stays ~0 — background maintenance may add a few
        m0 = metrics()
        occ_key = "dht_ingest_wave_occupancy"
        occ0 = float(m0.get("histograms", {}).get(occ_key, {})
                     .get("sum", 0.0))
        hits0 = counter(m0, hits_key)
        burst = 24
        for _ in range(burst):
            runners[0].get_sync(hot, timeout=OP_TIMEOUT)
        m1 = metrics()
        occ1 = float(m1.get("histograms", {}).get(occ_key, {})
                     .get("sum", 0.0))
        hits1 = counter(m1, hits_key)
        assert hits1 - hits0 >= burst * 0.9, \
            "burst not cache-served: hits %+g" % (hits1 - hits0)
        assert occ1 - occ0 <= burst * 0.25, \
            "hot gets still joined lookup launches: occupancy %+g " \
            "over a %d-get burst" % (occ1 - occ0, burst)

        # --- 2: hit ratio >= 0.9 under the flood, dhtmon gates on it.
        # Keep hot gets flowing so the NEXT observatory window rolls
        # with a hot-dominated probe mix.
        def ratio() -> float:
            return gauge(metrics(),
                         'dht_cache_hit_ratio{node="%s"}' % node0)
        for _ in range(40):
            if ratio() >= 0.9:
                break
            for _ in range(8):
                runners[0].get_sync(hot, timeout=OP_TIMEOUT)
        flood_ratio = ratio()
        assert flood_ratio >= 0.9, \
            "flood hit ratio %.3f < 0.9" % flood_ratio
        rc = dhtmon.main(["--nodes", "127.0.0.1:%d" % proxy.port,
                          "--min-cache-hit", "0.9"])
        assert rc == 0, "dhtmon flagged a >=0.9 hit ratio (rc=%d)" % rc

        # --- miss storm: eligible cold-key gets drag the next window's
        # ratio down; the same gate violates
        def miss_window() -> bool:
            r_ = ratio()
            return 0.0 <= r_ < 0.5
        i = 0
        for _ in range(40):
            if miss_window():
                break
            for _ in range(8):
                runners[0].get_sync(InfoHash.get("cache-miss-%d" % i),
                                    timeout=OP_TIMEOUT)
                i += 1
        assert miss_window(), "miss storm never dropped the ratio: %r" \
            % ratio()
        rc = dhtmon.main(["--nodes", "127.0.0.1:%d" % proxy.port,
                          "--min-cache-hit", "0.9"])
        assert rc == 1, "dhtmon missed the miss storm (rc=%d)" % rc

        # --- 4a: equivalence before the put — cache-served node 0 ==
        # full-path cache-off node 1 == the proxy REST stream
        v0 = _vals(runners[0].get_sync(hot, timeout=OP_TIMEOUT))
        v1 = _vals(runners[1].get_sync(hot, timeout=OP_TIMEOUT))
        assert v0 == v1 == before, (v0, v1, before)
        req = urllib.request.Request(
            "http://127.0.0.1:%d/%s" % (proxy.port, hot.hex()))
        with urllib.request.urlopen(req, timeout=30) as resp:
            rest = [json.loads(ln) for ln in resp.read().splitlines() if ln]
        assert set(int(o["id"]) for o in rest) \
            == set(i_ for i_, _ in v0), rest

        # --- 5: a listener on the hot key still delivers a fresh put
        # (listens are never cache-served)
        got = []
        tok = runners[0].listen(hot, lambda vals, exp: got.extend(
            v.id for v in vals if not exp) or True)
        tok.result(10.0)

        # --- 3: freshness — a fresh put invalidates; the next get
        # sees the new value on EVERY surface, never the stale set
        m2 = metrics()
        inval0 = counter(m2, 'dht_cache_invalidations_total{node="%s"}'
                         % node0)
        assert runners[1].put_sync(hot, Value(b"hot-v2", value_id=22),
                                   timeout=OP_TIMEOUT)
        assert _wait(lambda: counter(
            metrics(), 'dht_cache_invalidations_total{node="%s"}'
            % node0) > inval0, timeout=15.0), \
            "put never invalidated the cached hot key"
        want = {(11, b"hot-v1"), (22, b"hot-v2")}

        def fresh_visible() -> bool:
            return _vals(runners[0].get_sync(
                hot, timeout=OP_TIMEOUT)) == want
        assert _wait(fresh_visible, timeout=20.0), \
            "stale cache hit after a fresh put: %r" % (
                _vals(runners[0].get_sync(hot, timeout=OP_TIMEOUT)),)
        assert _vals(runners[1].get_sync(hot, timeout=OP_TIMEOUT)) == want
        assert _wait(lambda: 22 in got, timeout=15.0), \
            "listener never saw the post-warm put: %r" % (got,)
        runners[0].cancel_listen(hot, tok)

        csnap = _get_json(proxy.port, "cache")
        print("cache_smoke: OK — hot key %s admitted+served (hits %d, "
              "flood ratio %.2f -> dhtmon 0/1), put invalidated "
              "(%d invalidations) with fresh values on all surfaces"
              % (hot.hex()[:12], csnap["hits"], flood_ratio,
                 csnap["invalidations"]))
        return 0
    finally:
        if proxy is not None:
            proxy.stop()
        for r in runners:
            r.join()


if __name__ == "__main__":
    sys.exit(main())
