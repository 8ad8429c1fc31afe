"""End-to-end keyspace-observatory smoke.

Boots a 3-node real-UDP cluster + REST proxy and asserts the four
things the unit tier cannot:

1. **The hot key is detected on live traffic**: Zipf-skewed gets driven
   through the wave builder (the hottest key carries ~25% of the
   stream, the tail is uniform) surface the hot key at the top of the
   ``GET /keyspace`` heavy-hitter list with ``hot: true``, and a
   ``hot_key_emerged`` event lands in the flight recorder.
2. **The imbalance gauge exports**: ``dht_shard_imbalance`` appears in
   the proxy's ``GET /stats`` Prometheus exposition with a real
   (non-unknown) value once the window has traffic.
3. **dhtmon gates green on balanced-enough traffic**:
   ``--max-imbalance`` exits 0 while the Zipf mix keeps the folded
   per-shard loads inside the gate.  The gate is set ABOVE the
   measured mixed-phase imbalance (which includes honest maintenance
   traffic concentrated near the node's own id — bucket-refresh
   targets are real keyspace load, not noise to filter) and well
   below the single-key-flood ceiling, so the check is robust to
   timing-dependent traffic composition.
4. **A single-key flood trips the gate**: gets on ONLY the hot key
   concentrate the window into one histogram bin; after the decay
   ticks wash out the mixed phase, the same ``dhtmon
   --max-imbalance`` invocation exits 1.

Run directly::

    python -m opendht_tpu_torch.testing.keyspace_smoke [--cpu]

Its nodes run on the CUDA card unless ``--cpu`` is given; without a card
(and without ``--cpu``) it raises before any socket is bound.

The port's copy of the JAX package's ``testing/keyspace_smoke.py``,
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
N_COLD = 24
OP_TIMEOUT = 30.0
#: gate margin over the measured mixed-phase imbalance; the flood must
#: clear gate + margin so both dhtmon verdicts have headroom
GATE_MARGIN = 0.75


def _wait(pred, timeout=30.0, step=0.05) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _keyspace(port: int) -> dict:
    with urllib.request.urlopen(
            "http://127.0.0.1:%d/keyspace" % port, timeout=10) as r:
        return json.loads(r.read().decode())


def main(argv=None) -> int:
    from ..proxy import DhtProxyServer
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    resolve_device(device)        # no card and no --cpu: raise here

    runners = []
    proxy = None
    try:
        for i in range(N_NODES):
            cfg = Config(node_id=InfoHash.get("keyspace-smoke-node-%d" % i))
            # fast observatory cadence so the smoke converges in
            # seconds; gentle decay so a drive phase survives until
            # its read; stride 1 = every observed id is a candidate
            cfg.keyspace.tick = 0.5
            # phase 1-3 run near-cumulative (the serialized get_sync
            # stream is slow against the tick cadence — a fast decay
            # would make the window a noisy tail of the last round);
            # the flood phase flips node 0 to a fast decay so the
            # mixed residue washes out in a few ticks
            cfg.keyspace.decay = 0.98
            cfg.keyspace.sample_stride = 1
            cfg.keyspace.hot_min_count = 16
            # the smoke's serialized get_sync stream is slow against
            # the fast decay cadence; two dozen windowed ids is plenty
            # of evidence at this scale
            cfg.keyspace.min_observed = 24
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

        hot = InfoHash.get("keyspace-smoke-hot")
        # cold keys chosen (deterministically) to spread EXACTLY 3 per
        # 8-way virtual shard — hashed names clump (the first candidate
        # set put 8 of 24 cold keys in the hot key's shard), and the
        # mixed phase's imbalance must sit well below the gate so only
        # the flood trips it
        cold = []
        per_shard: dict = {}
        i = 0
        while len(cold) < N_COLD:
            k = InfoHash.get("keyspace-smoke-cold-%d" % i)
            i += 1
            s = bytes(k)[0] * 8 // 256
            if per_shard.get(s, 0) < N_COLD // 8:
                per_shard[s] = per_shard.get(s, 0) + 1
                cold.append(k)
        for i, key in enumerate(cold):
            assert runners[1 + i % (N_NODES - 1)].put_sync(
                key, Value(b"kc-%d" % i, value_id=i + 1),
                timeout=OP_TIMEOUT)
        assert runners[0].put_sync(hot, Value(b"kh", value_id=99),
                                   timeout=OP_TIMEOUT)

        # --- phase 1: Zipf-skewed mix through node 0's wave builder —
        # per round, 8 hot gets INTERLEAVED with every cold key once
        # (~25% hot share; interleaving keeps the window's composition
        # stable whenever a tick samples it)
        def drive_mixed(rounds: int) -> None:
            for _ in range(rounds):
                for i, key in enumerate(cold):
                    if i % 3 == 0:
                        runners[0].get_sync(hot, timeout=OP_TIMEOUT)
                    runners[0].get_sync(key, timeout=OP_TIMEOUT)

        drive_mixed(3)

        # --- 1: the hot key surfaces in GET /keyspace as HOT
        def hot_detected() -> bool:
            try:
                doc = _keyspace(proxy.port)
            except Exception:
                return False
            return hot.hex() in doc.get("hot_keys", [])
        # keep a trickle flowing so decay doesn't wash the window out
        # while we wait for a tick to publish
        for _ in range(20):
            if hot_detected():
                break
            drive_mixed(1)
        doc = _keyspace(proxy.port)
        assert hot.hex() in doc["hot_keys"], \
            "hot key not detected: %r" % (doc["top"],)
        top0 = doc["top"][0]
        assert top0["key"] == hot.hex() and top0["hot"], doc["top"]
        fr = runners[0].get_flight_recorder(name="hot_key_emerged")
        assert any(e["attrs"].get("key") == hot.hex()
                   for e in fr["events"]), \
            "no hot_key_emerged event for the hot key"

        # --- 2: the imbalance gauge exports on GET /stats with a
        # known (>= 0) value — keep traffic flowing so decay doesn't
        # drop the window below min_observed between tick and scrape
        node0 = str(runners[0].get_node_id())

        def imbalance_known():
            with urllib.request.urlopen(
                    "http://127.0.0.1:%d/stats" % proxy.port,
                    timeout=10) as r:
                text = r.read().decode()
            mine = [ln for ln in text.splitlines()
                    if ln.startswith("dht_shard_imbalance")
                    and node0 in ln]
            assert mine, "dht_shard_imbalance missing from /stats"
            return float(mine[0].rsplit(" ", 1)[1])
        for _ in range(20):
            if imbalance_known() >= 1.0:
                break
            drive_mixed(1)
        assert imbalance_known() >= 1.0, \
            "imbalance gauge stayed unknown under live traffic"

        # --- 3: dhtmon green under the mixed load.  The gate sits one
        # margin above the measured mixed imbalance (sanity-bounded:
        # the mix must stay clearly under the 8x single-shard ceiling
        # so the flood has room to trip it)
        imb_mixed = _keyspace(proxy.port)["shards"]["imbalance"]
        assert imb_mixed is not None and imb_mixed < 8.0 - 2 * GATE_MARGIN, \
            "mixed-phase imbalance leaves no flood headroom: %r" % imb_mixed
        gate = imb_mixed + GATE_MARGIN
        rc = dhtmon.main(["--nodes", "127.0.0.1:%d" % proxy.port,
                          "--max-imbalance", "%g" % gate])
        assert rc == 0, \
            "dhtmon flagged the balanced cluster (rc=%d): %r" \
            % (rc, _keyspace(proxy.port)["shards"])

        # --- 4: single-key flood — every get targets the hot key; node
        # 0's observatory flips to a fast decay so the mixed residue
        # washes out in a few ticks and the whole window lands in one
        # histogram bin -> imbalance ~= shard count
        runners[0]._dht.keyspace.cfg.decay = 0.5

        def flooded() -> bool:
            doc = _keyspace(proxy.port)
            imb = doc["shards"]["imbalance"]
            return imb is not None and imb > gate + GATE_MARGIN
        for _ in range(40):
            if flooded():
                break
            for _ in range(24):
                runners[0].get_sync(hot, timeout=OP_TIMEOUT)
        doc = _keyspace(proxy.port)
        assert flooded(), "flood never tripped the imbalance: %r" \
            % (doc["shards"],)
        rc = dhtmon.main(["--nodes", "127.0.0.1:%d" % proxy.port,
                          "--max-imbalance", "%g" % gate])
        assert rc == 1, \
            "dhtmon missed the single-key flood (rc=%d): %r" \
            % (rc, doc["shards"])

        print("keyspace_smoke: OK — hot key %s detected (est %d, share "
              "%.0f%%, hot_key_emerged in ring), imbalance %.2f -> "
              "dhtmon 0 at gate %.2f, flood -> %.2f -> dhtmon 1"
              % (hot.hex()[:12], top0["estimate"], top0["share"] * 100,
                 imb_mixed, gate, doc["shards"]["imbalance"] or 0.0))
        return 0
    finally:
        if proxy is not None:
            proxy.stop()
        for r in runners:
            r.join()


if __name__ == "__main__":
    sys.exit(main())
