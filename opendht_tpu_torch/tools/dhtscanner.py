"""dhtscanner: census the network by walking the keyspace
(↔ reference tools/dhtscanner.cpp:40-135: search successive ids spread
over the ring, collecting every node seen in replies).

``--json`` emits one machine-readable document —
the scanning node's topology snapshot (node id, per-bucket fill,
known-node count, storage size, recent flight-recorder events) plus
the discovered peer map — so the cluster harness can diff topology
over a soak run instead of scraping human output.  Its ``kernels``
section is the port's cost ledger (``--kernels`` computes it on the
node's device first) and its ``waterfall`` section the port's per-op
waterfall with the OPEN-bound comparison.  The scanning node runs on
the CUDA card unless ``--cpu`` is given."""

from __future__ import annotations

import json
import socket
import sys
import time

from ..infohash import InfoHash

# .common imports the crypto layer at module scope; keep it a CALL-time
# dependency so the scan/snapshot helpers import (and the soak harness
# runs) without the `cryptography` wheel — same pattern as the lazy
# lazy crypto module of runtime/runner.py


def scan(node, rounds: int = 32, timeout: float = 15.0,
         quiet: bool = False) -> dict:
    """Issue `rounds` gets at ids evenly spaced over the 160-bit ring;
    harvest the union of nodes from the routing table after each
    (dhtscanner.cpp:52-99 steps a prefix counter the same way)."""
    seen = {}
    for i in range(rounds):
        target = InfoHash.from_int((i << 152) | (1 << 151))
        done = []
        node.get(target, lambda vals: True,
                 lambda ok, nodes: done.append([
                     (n.id, n.addr) for n in nodes or []]))
        t0 = time.monotonic()
        while not done and time.monotonic() - t0 < timeout:
            time.sleep(0.02)
        for nid, addr in (done[0] if done else []):
            seen[nid] = addr
        if not quiet:
            print("scan %2d/%d: target %s…, %d nodes known"
                  % (i + 1, rounds, str(target)[:8], len(seen)))
    return seen


def topology_snapshot(node) -> dict:
    """Per-node topology/routing snapshot off ``get_metrics()`` + the
    flight-recorder ring: stable keys, JSON-able values, cheap enough
    to take every soak tick.  Every section degrades to empty rather
    than raising (a half-up node must still snapshot)."""
    snap: dict = {
        "node_id": str(node.get_node_id()),
        "port": node.get_bound_port(),
        "routing": {},
        "bucket_fill": [],
        "known_nodes": 0,
        "storage": {},
        "metrics_gauges": {},
        "maintenance": {},
        "ingest": {},
        "kernels": {},
        "health": {},
        "keyspace": {},
        "cache": {},
        "reshard": {},
        "waterfall": {},
        "pipeline": {},
        "peers": {},
        "listeners": {},
        "chaos": {},
        "events": [],
    }
    try:
        # latency waterfall: per-stage p50/p95/p99 + budgets +
        # the live OPEN-bound comparison, so a soak diff shows WHERE an
        # op's milliseconds went between snapshots, not just the
        # end-to-end total
        snap["waterfall"] = node.get_profile()
    except Exception:
        pass
    try:
        # pipeline observatory: windowed device occupancy,
        # per-cause bubble attribution and overlap ratio, so a soak
        # diff shows WHETHER the device stayed busy between snapshots
        # and whose fault the gaps were
        snap["pipeline"] = node.get_pipeline()
    except Exception:
        pass
    try:
        # per-peer observatory: srtt/RTO, outcome counts and
        # flap transitions per remote peer, so a soak diff shows WHICH
        # link degraded between snapshots (and the wire-map assembler
        # can rebuild the cluster's directed link graph offline)
        snap["peers"] = node.get_peers()
    except Exception:
        pass
    try:
        # listener table: occupancy/overflow, buffered keys
        # and delivery-lag p95, so a soak diff shows WHETHER the
        # wave-batched listen/push path kept up between snapshots
        # (next to the peers section's view of the links it pushed on)
        snap["listeners"] = node.get_listeners()
    except Exception:
        pass
    try:
        # hot-key serving cache: occupancy, hit ratio and the
        # widened hot set, so a soak diff shows WHICH keys the acting
        # layer served from cache (next to the keyspace section's
        # detection of them)
        snap["cache"] = node.get_cache()
    except Exception:
        pass
    try:
        # keyspace observatory: heavy hitters, occupied-bin
        # histogram and per-shard load attribution, so a soak diff
        # shows WHERE in the ring traffic moved between snapshots (the
        # full 256-bin histogram rides along — it is 256 ints)
        snap["keyspace"] = node.get_keyspace()
    except Exception:
        pass
    try:
        # load-aware resharding: layout generation, solved
        # edges and reason-labeled skip counters, so a soak diff shows
        # WHEN the boundaries moved (next to the keyspace section's
        # load attribution that triggered it)
        snap["reshard"] = node.get_reshard()
    except Exception:
        pass
    try:
        # health observatory: the node verdict + per-signal /
        # per-SLO attribution, so a soak diff shows WHEN a node
        # degraded and what drove it, not just that counters moved
        snap["health"] = node.get_health()
    except Exception:
        pass
    try:
        # ingest surface: the wave builder's queue depth /
        # occupancy p50-p95 / time-in-queue / shed state, so the soak
        # harness can diff how well live traffic coalesced (and whether
        # backpressure fired) between snapshots
        snap["ingest"] = node._dht.wave_builder.snapshot()
    except Exception:
        pass
    try:
        # kernel cost ledger: report whatever is already
        # computed — the snapshot must stay cheap enough for every soak
        # tick, so it never triggers the (seconds-long) compute itself;
        # `dhtscanner --kernels` / the REPL `kernels` cmd arm it
        from .. import profiling
        if profiling.ledger_computed():
            snap["kernels"] = profiling.get_ledger().snapshot()
    except Exception:
        pass
    try:
        metrics = node.get_metrics()
        snap["metrics_gauges"] = {
            k: v for k, v in metrics.get("gauges", {}).items()
            if k.startswith(("dht_routing_", "dht_scheduler_"))}
        # maintenance surface: sweep/refresh/republish counters
        # + calendar-bin gauge, so the soak harness can diff how much
        # maintenance each node actually performed between snapshots
        snap["maintenance"] = {
            k: v for k, v in metrics.get("counters", {}).items()
            if k.startswith("dht_maintenance_")}
        snap["maintenance"].update(
            (k, v) for k, v in metrics.get("gauges", {}).items()
            if k.startswith("dht_maintenance_"))
        # chaos plane: the fault
        # injector's per-rule drop/dup/reorder/delay accounting
        # (dht_chaos_injected_total{action=,rule=}) — armed storms were
        # counted on the registry but surfaced nowhere; a soak diff now
        # shows which rules actually fired between snapshots
        snap["chaos"] = {
            k: v for k, v in metrics.get("counters", {}).items()
            if k.startswith("dht_chaos_")}
    except Exception:
        pass
    for af, fam in ((socket.AF_INET, "ipv4"), (socket.AF_INET6, "ipv6")):
        try:
            st = node.get_node_stats(af)
            snap["routing"][fam] = st.to_dict()
            snap["known_nodes"] += st.get_known_nodes()
        except Exception:
            continue
    try:
        table = node._dht.tables[socket.AF_INET]
        snap["bucket_fill"] = [int(c) for c in table.bucket_occupancy()]
    except Exception:
        pass
    try:
        dht = node._dht
        snap["storage"] = {
            "keys": len(dht.store),
            "values": int(dht.total_values),
            "bytes": int(dht.total_store_size),
        }
    except Exception:
        pass
    try:
        snap["events"] = node.get_flight_recorder(limit=50)["events"]
    except Exception:
        pass
    return snap


def main(argv=None) -> int:
    from .common import make_arg_parser, print_node_info, setup_node
    p = make_arg_parser("OpenDHT-TPU network scanner")
    p.add_argument("--rounds", type=int, default=32,
                   help="number of keyspace probes")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON document (topology snapshot + "
                        "discovered peers) instead of human output")
    p.add_argument("--kernels", action="store_true",
                   help="compute the kernel cost ledger on the node's "
                        "device (seconds, once) so the snapshot's "
                        "'kernels' section carries per-spec dispatched "
                        "ops, operations model and byte bound")
    p.add_argument("--bundle", default="", metavar="DIR",
                   help="collect the scanning node's post-mortem "
                        "black-box bundle (last-N history "
                        "frames + flight ring + kernel ledger + "
                        "keyspace/cache snapshots — the GET "
                        "/debug/bundle artifact) into "
                        "DIR/bundle-<nodeid>.json after the scan")
    args = p.parse_args(argv)
    node = setup_node(args)
    if args.kernels:
        from .. import profiling
        profiling.get_ledger().compute(device="cpu" if args.cpu else None)
        profiling.maybe_export()
    if not args.json:
        print_node_info(node)
    try:
        # wait for connectivity before scanning (dhtscanner.cpp:109-117)
        from ..runtime.config import NodeStatus
        t0 = time.monotonic()
        while (node.get_status() is not NodeStatus.CONNECTED
               and time.monotonic() - t0 < 30.0):
            time.sleep(0.1)
        seen = scan(node, args.rounds, quiet=args.json)
        stats = node.get_node_stats(socket.AF_INET)
        bundle_path = None
        if args.bundle:
            # black-box collector: the scan drove real
            # traffic, so the bundle's history frames carry it — one
            # artifact per node for the cluster harness to merge
            # through testing/timeline_assembler.py
            import os
            os.makedirs(args.bundle, exist_ok=True)
            bundle_path = os.path.join(
                args.bundle,
                "bundle-%s.json" % node.get_node_id().hex())
            with open(bundle_path, "w") as fh:
                json.dump(node.dump_bundle(reason="dhtscanner"), fh)
            if not args.json:
                print("bundle written to %s" % bundle_path)
        if args.json:
            doc = {
                "snapshot": topology_snapshot(node),
                "discovered": sorted(
                    ([str(nid), [str(addr.ip), addr.port]]
                     for nid, addr in seen.items()),
                    key=lambda kv: kv[0]),
                "network_size_estimation":
                    stats.get_network_size_estimation(),
                "bundle_path": bundle_path,
            }
            json.dump(doc, sys.stdout)
            print()
        else:
            print("\n%d nodes discovered:" % len(seen))
            for nid, addr in sorted(seen.items(), key=lambda kv: str(kv[0])):
                print("  %s  %s" % (nid, addr))
            print("network size estimation: %d"
                  % stats.get_network_size_estimation())
    finally:
        node.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
