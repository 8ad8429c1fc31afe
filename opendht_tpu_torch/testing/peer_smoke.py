"""Per-peer observatory CI smoke.

Boots real-UDP 3-node clusters and injects chaos-plane faults on ONE
link, then asserts the four things only a live wire can about the
per-peer ledger (opendht_tpu/peers.py):

1. **The adaptive RTO beats the fixed timetable under jitter** — the
   same delay+jitter ``LinkRule`` (one-way ~[0.4, 0.7]s, so RTTs
   straddle the fixed ``MAX_RESPONSE_TIME = 1.0``) runs twice: once
   with ``adaptive_rto`` off (every slow-but-alive reply is preceded
   by a pointless retransmit) and once with it on (Karn backoff climbs
   out of the stale fast estimate, a clean sample seeds
   srtt + 4*rttvar above the link's real RTT).  The adaptive run must
   record MEASURABLY FEWER spurious retransmits to the lagged peer —
   the acceptance bar — while the fixed run's surfaced RTO stays
   exactly 1.0 (the escape-hatch pin).
2. **Attribution is per-link, not cluster-smeared** — the lagged
   link's srtt/RTO adapt on exactly that peer's row; the untouched
   peer's row keeps a millisecond srtt and a clamped RTO.
3. **Loss lands on the right directed edge of the wire map** — a
   one-way 85% loss rule on node0 -> node2 drives that edge's (and
   only that edge's) fail ratio up; the cluster wire map assembled
   from every node's ``GET /peers`` (testing/wiremap_assembler.py)
   names node0 -> node2 as the worst edge while the REVERSE edge and
   the node0 -> node1 edge stay healthy.
4. **dhtmon gates on the worst link** — ``--max-peer-fail`` exits 0 at
   a ceiling above the injected fail ratio and flips to 1 at a floor
   below it (the same per-node worst / unknown-never-violates
   contract as the other gauge gates), and the censored-attempt
   counter ``dht_net_attempt_timeouts_total{type=}`` ticked at the
   EXPIRED transitions the loss caused.

Run directly::

    python -m opendht_tpu_torch.testing.peer_smoke [--cpu]

Its nodes run on the CUDA card unless ``--cpu`` is given; without a card
(and without ``--cpu``) it raises before any socket is bound.

The port's copy of the JAX package's ``testing/peer_smoke.py``,
behaviour unchanged but for the nodes' device.
"""

from __future__ import annotations

import sys
import threading
import time

from .. import chaos, telemetry
from .._device import resolve_device
from ..infohash import InfoHash
from ..net.node import MAX_RESPONSE_TIME
from ..peers import PeersConfig
from ..runtime.config import Config
from ..tools import dhtmon
from . import wiremap_assembler as wma
from .network import DhtNetwork

#: one-way delay/jitter of the lagged link: RTT = out + back lands in
#: [0.8, 1.4]s — straddling the fixed 1.0 s retransmit timer, the
#: regime where a fixed timetable retransmits into in-flight replies
ONE_WAY_DELAY = 0.4
ONE_WAY_JITTER = 0.3
#: requests to the lagged peer before the jitter verdict is read
MIN_REQUESTS = 24
OP_TIMEOUT = 90.0


def _drive(node, keys, timeout=OP_TIMEOUT) -> None:
    """Fire one concurrent get per key and wait for every done
    callback (the values don't exist; the point is request traffic)."""
    evs = []
    for k in keys:
        ev = threading.Event()
        evs.append(ev)
        node.get(k, lambda vs: True, lambda ok, ns, _e=ev: _e.set())
    deadline = time.monotonic() + timeout
    for ev in evs:
        rem = deadline - time.monotonic()
        assert rem > 0 and ev.wait(rem), "get flood stalled"


def _row(snap: dict, peer_id: str):
    for p in snap.get("peers", []):
        if p["id"] == peer_id:
            return p
    return None


def _jitter_phase(net: DhtNetwork, tag: str) -> dict:
    """Arm delay+jitter on the node0<->node1 link only, drive gets
    from node0 until >= MIN_REQUESTS reached the lagged peer, disarm,
    and return node0's ledger snapshot."""
    plan = chaos.FaultPlan(
        [chaos.Phase("jitter", 0.0, None, rules=[
            chaos.LinkRule(name="lag", src="a", dst="b",
                           delay=ONE_WAY_DELAY, jitter=ONE_WAY_JITTER,
                           symmetric=True)])],
        seed=23)
    net.arm(plan, groups={0: "a", 1: "b"})
    src = net.nodes[0]
    lag_id = str(net.nodes[1].get_node_id())
    for rnd in range(12):
        _drive(src, [InfoHash.get("peersmoke-%s-%d-%d" % (tag, rnd, i))
                     for i in range(6)])
        row = _row(src.get_peers(), lag_id)
        if row is not None and row["sent"] >= MIN_REQUESTS:
            break
    net.disarm()
    snap = src.get_peers()
    row = _row(snap, lag_id)
    assert row is not None and row["sent"] >= 12, \
        "too little traffic reached the lagged peer: %r" % (row,)
    return snap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    resolve_device(device)        # no card and no --cpu: raise here
    reg = telemetry.get_registry()

    # ---- run A: FIXED timetable under jitter -------------------------
    reg.reset()
    net = DhtNetwork(3, config=Config(
        peers=PeersConfig(adaptive_rto=False, min_signal_events=4)),
        seed=7, device=device)
    try:
        assert net.wait_connected(), "fixed cluster failed to connect"
        lag_id = str(net.nodes[1].get_node_id())
        snap = _jitter_phase(net, "fixed")
        f_row = _row(snap, lag_id)
        # the escape-hatch pin on a live wire: knob off => the surfaced
        # per-peer RTO is exactly the fixed constant, even though the
        # ledger measured the real (much larger) srtt
        assert f_row["rto"] == MAX_RESPONSE_TIME, f_row
        assert f_row["attempt_timeouts"] > 0, \
            "fixed run never retransmitted under 0.8-1.4s RTTs: %r" % f_row
        f_spur = f_row["spurious_retransmits"]
        assert f_spur >= 5, \
            "fixed timetable produced too few spurious retransmits " \
            "to compare (%d): %r" % (f_spur, f_row)
    finally:
        net.shutdown()

    # ---- run B: ADAPTIVE RTO under the same jitter -------------------
    reg.reset()
    net = DhtNetwork(3, config=Config(
        peers=PeersConfig(adaptive_rto=True, min_signal_events=4)),
        seed=7, device=device)
    proxies = []
    try:
        assert net.wait_connected(), "adaptive cluster failed to connect"
        id0 = str(net.nodes[0].get_node_id())
        id1 = str(net.nodes[1].get_node_id())
        id2 = str(net.nodes[2].get_node_id())
        snap = _jitter_phase(net, "adaptive")
        a_row = _row(snap, id1)
        q_row = _row(snap, id2)
        # 1: measurably fewer spurious retransmits than the fixed run
        a_spur = a_row["spurious_retransmits"]
        assert a_spur < f_spur, \
            "adaptive RTO did not beat the fixed timetable: " \
            "%d spurious vs %d fixed" % (a_spur, f_spur)
        # 2: the estimate adapted on THIS link only
        assert a_row["samples"] >= 1 and a_row["srtt"] > 0.3, a_row
        assert a_row["rto"] > MAX_RESPONSE_TIME, \
            "adaptive RTO failed to climb above the fixed timer: %r" % a_row
        assert q_row is None or q_row["srtt"] is None \
            or q_row["srtt"] < 0.2, \
            "untouched link's srtt drifted: %r" % q_row
        assert q_row is None or q_row["rto"] <= MAX_RESPONSE_TIME + 1e-9, \
            "untouched link's RTO left baseline: %r" % q_row
        assert q_row is None or q_row["spurious_retransmits"] <= 1, \
            "untouched link retransmitted spuriously: %r" % q_row

        # ---- loss on ONE directed link: node0 -> node2 ---------------
        plan = chaos.FaultPlan(
            [chaos.Phase("loss", 0.0, None, rules=[
                chaos.LinkRule(name="lossy", src="a", dst="c",
                               loss=0.85)])],
            seed=29)
        net.arm(plan, groups={0: "a", 2: "c"})
        for rnd in range(10):
            _drive(net.nodes[0],
                   [InfoHash.get("peersmoke-loss-%d-%d" % (rnd, i))
                    for i in range(5)])
            row = _row(net.nodes[0].get_peers(), id2)
            if row is not None and row["expired"] >= 6 \
                    and row["completed"] >= 2:
                break
        net.disarm()
        row = _row(net.nodes[0].get_peers(), id2)
        assert row is not None and row["expired"] >= 3, \
            "loss rule never expired a request: %r" % (row,)

        # satellite: the censored-attempt counter ticked at EXPIRED
        tot = sum(m.value for m in
                  reg.series("dht_net_attempt_timeouts_total").values())
        assert tot > 0, "dht_net_attempt_timeouts_total never ticked"

        # 3: the wire map attributes the loss to exactly that edge
        from ..proxy import DhtProxyServer
        proxies = [DhtProxyServer(r, 0) for r in net.nodes]
        docs = [wma.scrape_peers("127.0.0.1:%d" % p.port)
                for p in proxies]
        assert all(d is not None for d in docs), \
            "a node's GET /peers was missing"
        wm = wma.assemble_wiremap(docs)
        assert not wm["violations"], wm["violations"]
        assert len(wm["nodes"]) == 3
        worst = wma.worst_edge(wm, "fail_ratio")
        assert worst is not None and worst["src"] == id0 \
            and worst["dst"] == id2, \
            "loss attributed to the wrong edge: %s -> %s" \
            % (worst and worst["src"], worst and worst["dst"])
        # the ledger is cumulative since boot, so the healthy pre-loss
        # completions on this link dilute the ratio — the bar is clear
        # separation from the healthy edges, not the raw loss rate
        assert worst["fail_ratio"] > 0.1 and worst["known"], worst
        rev = wma.find_edge(wm, id2, id0)
        assert rev is None or rev["fail_ratio"] is None \
            or rev["fail_ratio"] < 0.2, \
            "one-way loss leaked onto the reverse edge: %r" % rev
        side = wma.find_edge(wm, id0, id1)
        assert side is None or side["fail_ratio"] is None \
            or side["fail_ratio"] < 0.3, \
            "loss smeared onto the untouched edge: %r" % side

        # 4: dhtmon gates on the worst link, both verdicts
        eps = ",".join("127.0.0.1:%d" % p.port for p in proxies)
        rc = dhtmon.main(["--nodes", eps, "--max-peer-fail", "0.95"])
        assert rc == 0, \
            "dhtmon flagged a link under its ceiling (rc=%d)" % rc
        rc = dhtmon.main(["--nodes", eps, "--max-peer-fail", "0.05"])
        assert rc == 1, \
            "dhtmon missed the dying link (rc=%d, fail %r)" \
            % (rc, worst["fail_ratio"])

        print("peer_smoke: OK — spurious retransmits %d fixed -> %d "
              "adaptive (lag srtt %.3fs rto %.3fs; quiet rto %.3fs), "
              "loss edge %s->%s fail %.2f, dhtmon 0 at 0.95 -> 1 at "
              "0.05"
              % (f_spur, a_spur, a_row["srtt"], a_row["rto"],
                 q_row["rto"] if q_row else float("nan"),
                 worst["src"][:8], worst["dst"][:8],
                 worst["fail_ratio"]))
        return 0
    finally:
        for p in proxies:
            p.stop()
        net.shutdown()


if __name__ == "__main__":
    sys.exit(main())
