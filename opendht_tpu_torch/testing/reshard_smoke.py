"""End-to-end load-aware resharding smoke.

Boots a 3-node real-UDP cluster + REST proxy, floods one hot key so the
keyspace observatory's folded imbalance climbs past the rebalance
threshold, and asserts the closed loop the unit tier cannot:

1. **Hysteresis holds**: while the burst is shorter than the sustain
   window, rebalance ticks fire but ZERO swaps happen — the
   ``dht_reshard_skips_total{reason=hysteresis}`` counter advances and
   ``dhtmon --max-imbalance`` exits 1 on the skewed cluster.
2. **The sustained flood swaps**: once the overload outlives the
   sustain window, exactly the rebalance path runs — ``GET /reshard``
   reports a new layout generation (virtual mode on this unsharded
   cluster), a ``reshard_swap`` event lands in the flight recorder,
   and the ``dht_reshard_*`` series ride the proxy's ``GET /stats``
   exposition.
3. **The imbalance actually drops**: fold attribution follows the new
   traffic-weighted edges, the live ``dht_shard_imbalance`` gauge
   falls back under the gate, and the SAME ``dhtmon --max-imbalance``
   invocation flips 1 -> 0.
4. **Serving is identical across the swap**: every pre-swap get result
   is reproduced post-swap, a fresh put lands, and a listener
   registered BEFORE the swap still delivers a post-swap put.

Run directly::

    python -m opendht_tpu_torch.testing.reshard_smoke [--cpu]

Its nodes run on the CUDA card unless ``--cpu`` is given; without a card
(and without ``--cpu``) it raises before any socket is bound.

The port's copy of the JAX package's ``testing/reshard_smoke.py``,
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
N_COLD = 8
OP_TIMEOUT = 60.0
#: the rebalance threshold doubles as the dhtmon gate: skewed > gate
#: before the swap, refolded < gate after it
GATE = 2.0


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
            cfg = Config(node_id=InfoHash.get("reshard-smoke-node-%d" % i))
            # fast observatory cadence (keyspace_smoke's rationale: the
            # serialized get_sync stream is slow against the tick, so
            # decay gently and sample every id)
            cfg.keyspace.tick = 0.5
            cfg.keyspace.decay = 0.98
            cfg.keyspace.sample_stride = 1
            cfg.keyspace.min_observed = 24
            if i == 0:
                # fast rebalance ticks; the sustain window starts LONG
                # so the flood's first seconds are provably a transient
                # burst (phase 1), then the smoke shortens it to prove
                # the sustained overload swaps (phase 2)
                cfg.reshard.period = 0.4
                cfg.reshard.rebalance_threshold = GATE
                cfg.reshard.sustain = 3600.0
                cfg.reshard.min_interval = 1.0
            else:
                cfg.reshard.enabled = False
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
        rs = runners[0]._dht.reshard

        hot = InfoHash.get("reshard-smoke-hot")
        cold = [InfoHash.get("reshard-smoke-cold-%d" % i)
                for i in range(N_COLD)]
        assert runners[0].put_sync(hot, Value(b"rh", value_id=99),
                                   timeout=OP_TIMEOUT)
        for i, key in enumerate(cold):
            assert runners[1 + i % (N_NODES - 1)].put_sync(
                key, Value(b"rc-%d" % i, value_id=i + 1),
                timeout=OP_TIMEOUT)

        # pre-swap serving baseline + a listener that must survive the
        # swap (get/put/listen identical across the boundary rebuild)
        pre = {k: _vals(runners[0].get_sync(k, timeout=OP_TIMEOUT))
               for k in [hot] + cold}
        assert pre[hot] == {(99, b"rh")}, pre[hot]
        heard: list = []
        tok = runners[0].listen(cold[0], lambda vals, exp: heard.extend(
            v.id for v in vals if not exp) or True)
        tok.result(OP_TIMEOUT)

        def flood(rounds: int) -> None:
            for _ in range(rounds):
                runners[0].get_sync(hot, timeout=OP_TIMEOUT)
                # yield the DHT loop so the scheduler's observatory/
                # reshard ticks aren't starved by the serialized get
                # stream on a loaded CI box
                time.sleep(0.02)

        # --- phase 1: the flood trips the imbalance but the sustain
        # window (still huge) holds — ticks skip with reason=hysteresis
        # and ZERO swaps happen
        def burst_proven() -> bool:
            snap = _get_json(proxy.port, "reshard")
            ks = _get_json(proxy.port, "keyspace")["shards"]
            return (snap["skips"].get("hysteresis", 0) >= 2
                    and ks["imbalance"] is not None
                    and ks["imbalance"] > GATE)
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline and not burst_proven():
            flood(8)
        assert burst_proven(), \
            "flood never armed the latch: %r / %r" % (
                _get_json(proxy.port, "reshard"),
                _get_json(proxy.port, "keyspace")["shards"])
        snap = _get_json(proxy.port, "reshard")
        assert snap["swaps"] == 0 and snap["gen"] == 0, \
            "transient burst swapped: %r" % (snap,)
        rc = dhtmon.main(["--nodes", "127.0.0.1:%d" % proxy.port,
                          "--max-imbalance", "%g" % GATE])
        assert rc == 1, "dhtmon missed the pre-swap skew (rc=%d)" % rc

        # --- phase 2: the overload is now SUSTAINED — shorten the
        # window (the latch has been armed since phase 1) and a tick
        # landing a sustain-width past an above-threshold tick swaps.
        # 0.8 s keeps the latch mechanism in play while tolerating a
        # loaded box where ticks starve seconds apart and a stall can
        # reset the latch mid-phase (the flood re-arms it).
        rs.cfg.sustain = 0.8

        def swapped() -> bool:
            return _get_json(proxy.port, "reshard")["swaps"] >= 1
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline and not swapped():
            flood(4)
        snap = _get_json(proxy.port, "reshard")
        assert swapped(), "sustained flood never swapped: %r / %r" % (
            snap, _get_json(proxy.port, "keyspace")["shards"])
        assert snap["gen"] >= 1 and snap["mode"] == "virtual", snap
        lay = snap["layout"]
        assert lay["t"] >= 2 and len(lay["edges"]) == lay["t"] - 1
        assert all(a <= b for a, b in zip(lay["edges"], lay["edges"][1:]))
        # the refold of the swap-time histogram at the solved edges is
        # balanced — the number the gauge converges to
        assert snap["post_imbalance"] is not None \
            and snap["post_imbalance"] < GATE, snap
        fr = runners[0].get_flight_recorder(name="reshard_swap")
        assert any(e["attrs"].get("gen") == snap["gen"]
                   for e in fr["events"]), \
            "no reshard_swap flight event: %r" % (fr["events"],)

        # --- phase 3: fold attribution follows the new edges — the
        # LIVE gauge drops under the gate and dhtmon flips to 0
        def rebalanced() -> bool:
            imb = _get_json(proxy.port, "keyspace")["shards"]["imbalance"]
            return imb is not None and imb < GATE
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline and not rebalanced():
            flood(4)
        ks = _get_json(proxy.port, "keyspace")["shards"]
        assert rebalanced(), \
            "imbalance never dropped after the swap: %r" % (ks,)
        assert ks["t"] == lay["t"] and ks["virtual"] is True, ks
        rc = dhtmon.main(["--nodes", "127.0.0.1:%d" % proxy.port,
                          "--max-imbalance", "%g" % GATE])
        assert rc == 0, \
            "dhtmon still red after the rebalance (rc=%d): %r" % (rc, ks)

        # the dht_reshard_* series ride the Prometheus exposition
        node0 = str(runners[0].get_node_id())
        with urllib.request.urlopen(
                "http://127.0.0.1:%d/stats" % proxy.port, timeout=10) as r:
            text = r.read().decode()
        for series in ("dht_reshard_swaps_total", "dht_reshard_gen",
                       "dht_reshard_post_imbalance",
                       "dht_reshard_skips_total"):
            assert any(ln.startswith(series) and node0 in ln
                       for ln in text.splitlines()), \
                "%s missing from /stats" % series

        # --- phase 4: serving identity across the swap — every
        # pre-swap get reproduces, a fresh put lands, the pre-swap
        # listener delivers a post-swap put
        for k in [hot] + cold:
            got = _vals(runners[0].get_sync(k, timeout=OP_TIMEOUT))
            assert got == pre[k], (str(k), got, pre[k])
        assert runners[1].put_sync(cold[0], Value(b"rc-post", value_id=77),
                                   timeout=OP_TIMEOUT)
        assert _wait(lambda: 77 in heard, timeout=20.0), \
            "pre-swap listener never saw the post-swap put: %r" % (heard,)
        want = pre[cold[0]] | {(77, b"rc-post")}
        assert _wait(lambda: _vals(runners[0].get_sync(
            cold[0], timeout=OP_TIMEOUT)) == want, timeout=20.0), \
            "post-swap put not visible on get"
        runners[0].cancel_listen(cold[0], tok)

        print("reshard_smoke: OK — burst held (%d hysteresis skips, 0 "
              "swaps, dhtmon 1), sustained flood swapped gen=%d t=%d "
              "(post refold %.2f), live imbalance %.2f < gate %.1f -> "
              "dhtmon 0, get/put/listen identical across the swap"
              % (snap["skips"].get("hysteresis", 0), snap["gen"],
                 lay["t"], snap["post_imbalance"],
                 ks["imbalance"], GATE))
        return 0
    finally:
        if proxy is not None:
            proxy.stop()
        for r in runners:
            r.join()


if __name__ == "__main__":
    sys.exit(main())
