"""dhtnode: interactive CLI node / daemon (↔ reference tools/dhtnode.cpp).

The port's copy of the JAX package's ``tools/dhtnode.py``: its node
runs on the CUDA card unless ``--cpu`` is given, and ``kernels`` reads
the port's cost ledger (``opendht_tpu_torch.profiling``).  Run it as
``python -m opendht_tpu_torch.tools.dhtnode [--cpu] [-b host:port]``.

REPL ops (cmd_loop, dhtnode.cpp:104-460):
    h                      help
    x / q / quit           exit
    ll                     print routing tables, searches and storage logs
    lr                     routing tables log
    ls [hash]              searches log
    la                     storage (announced values) log
    b <host[:port]>        bootstrap
    cc                     simulate connectivity change
    g <hash>               get
    l <hash>               listen (prints updates; 'cl <token>' to stop)
    cl <token>             cancel listen
    p <hash> <text>        put
    pp <hash> <text>       permanent put
    cpp <hash> <vid>       cancel permanent put
    s <hash> <text>        put signed
    e <hash> <to> <text>   put encrypted to recipient hash
    q? <hash> <where>      query (e.g. q? <hash> id=42)
    il <name> <key> [vid]  index: insert (key as field=value)
    ii <name> <key>        index: lookup
    stats [prom]           unified telemetry (JSON snapshot; 'prom' =
                           Prometheus text, same registry as GET /stats)
    kernels [measure]      kernel cost ledger: per canonical call the
                           torch ops dispatched, the operations model,
                           the byte bound and the argument + output
                           bytes, at the canonical shapes the port's
                           gate budgets (python -m
                           opendht_tpu_torch.perf_gate), on the node's
                           device; 'measure' (the card only) adds the
                           CUDA-event time of one call + the roofline
                           against the card's peaks.  Exports
                           dht_kernel_* gauges to the same registry
                           GET /stats serves
    ingest                 continuous-batching ingest state:
                           queue depth, wave occupancy p50/p95 + mean,
                           time-in-queue p50/p95, waves fired, sheds —
                           the wave builder's live coalescing health
    trace [id|chrome [f]]  distributed tracing: no arg = recent trace
                           ids in the ring; '<trace id>' = that trace's
                           span tree; 'chrome [file]' = Perfetto/Chrome
                           trace-event dump (stdout or file)
    health                 node health verdict (healthy | degraded |
                           unhealthy) with per-signal and per-SLO
                           burn-rate attribution — the same JSON the
                           proxy serves on GET /healthz
    keyspace [json]        keyspace traffic observatory:
                           heavy-hitter top-K off the device count-min
                           sketch (windowed estimates, hot flags),
                           occupied histogram bins, per-shard load
                           attribution + imbalance ratio — the same
                           data the proxy serves on GET /keyspace;
                           'json' dumps the full snapshot (incl. the
                           256-bin histogram)
    reshard [json]         load-aware resharding: installed
                           boundary generation + solved edges,
                           tick/swap/skip counters (skips labeled
                           below-threshold / hysteresis / cooldown),
                           sustain latch age and post-swap refolded
                           imbalance — the same data the proxy serves
                           on GET /reshard
    profile [json|folded]  per-op latency waterfall: per-
                           stage p50/p95/p99 (queue_wait, cache_probe,
                           device_compile/launch, scatter_back,
                           rpc_wait), the stage budgets and the live
                           OPEN-bound comparison — the same data the
                           proxy serves on GET /profile; 'json' dumps
                           the full snapshot (incl. per-op records +
                           bucket exemplars), 'folded' prints
                           flamegraph-shaped folded stacks
    pipeline [json]        pipeline utilization observatory:
                           windowed device occupancy, per-cause
                           device-idle bubble attribution (queue_empty
                           / fill_slow / drain_backpressure /
                           launch_retry / reshard_swap / cache_served),
                           measured fill∥device overlap ratio and the
                           pipeline shape — the same data the proxy
                           serves on GET /pipeline (?fmt=trace there
                           for the Perfetto lane export)
    peers [json]           per-peer network observatory:
                           per-peer srtt/rttvar + adaptive RTO,
                           request outcome counts, attempt timeouts,
                           spurious retransmits, bytes by message
                           type and good<->dubious<->expired flap
                           transitions — the same data the proxy
                           serves on GET /peers; 'json' dumps the
                           full snapshot
    listeners [json]       device-resident listener table:
                           occupancy/overflow/tombstones, buffered
                           values awaiting the next wave's batched
                           match, delivery-lag p95 and the soonest-
                           expiring entries — the same data the proxy
                           serves on GET /listeners; 'json' dumps the
                           full snapshot
    cache [json]           hot-key serving cache: occupancy,
                           per-entry hit counts, windowed hit ratio,
                           invalidation/eviction totals and the
                           widened (closest-16) hot set — the same
                           data the proxy serves on GET /cache; 'json'
                           dumps the full snapshot
    dump [n] [name]        flight-recorder dump: last n (default 40)
                           structured events + span count (the
                           reference's dumpTables analogue); a
                           non-numeric arg filters by event/span name
                           substring (e.g. 'dump health')
    bundle [file]          post-mortem black-box bundle:
                           last-N history frames + flight-recorder
                           ring + kernel ledger + keyspace/cache
                           snapshots + health report in one JSON
                           artifact — the same document the proxy
                           serves on GET /debug/bundle; with a file
                           arg the bundle is written there, otherwise
                           a summary prints (auto-captured bundles
                           from past unhealthy transitions listed)
    stt <port>             start REST proxy server
    stp                    stop REST proxy server
    pst <host:port>        switch backend to a REST proxy (client)
    psp                    switch back to the UDP backend
    info                   node id, port, stats
"""

from __future__ import annotations

import shlex
import socket
import sys
import time

from ..infohash import InfoHash
from ..core.value import Value
from .common import (make_arg_parser, parse_bootstrap, print_node_info,
                     print_node_stats, setup_node)


def to_hash(word: str) -> InfoHash:
    """40-hex-char args are hashes; anything else is hashed as a key
    (the reference requires strict hex — dhtnode.cpp:131-138 — this is a
    usability extension)."""
    if len(word) == 2 * InfoHash.HASH_LEN:
        try:
            return InfoHash(word)
        except Exception:
            pass
    return InfoHash.get(word)

HELP = __doc__


def _value_str(v: Value) -> str:
    flags = []
    if v.is_signed():
        flags.append("signed")
    if v.is_encrypted():
        flags.append("encrypted")
    body = v.data.decode("utf-8", "replace") if not v.is_encrypted() else "<cypher>"
    return "Value[id:%x%s%s] %r" % (
        v.id, " " if flags else "", ",".join(flags), body)


def cmd_loop(node, args) -> None:            # noqa: C901 — REPL dispatch
    """(↔ cmd_loop, dhtnode.cpp:104-460)"""
    from ..indexation.pht import Pht

    proxy_server = None
    indexes = {}
    listen_tokens = {}

    print("(type 'h' for help)")
    while True:
        try:
            line = input("> ")
        except (EOFError, KeyboardInterrupt):
            print()
            break
        try:
            words = shlex.split(line)
        except ValueError as e:
            print("parse error: %s" % e)
            continue
        if not words:
            continue
        op, rest = words[0], words[1:]
        try:
            if op in ("x", "q", "exit", "quit"):
                break
            elif op in ("h", "help"):
                print(HELP)
            elif op == "info":
                print_node_info(node)
                print_node_stats(node)
            elif op == "stats":
                # the unified telemetry registry: same data
                # the proxy serves on GET /stats
                if rest and rest[0] in ("prom", "prometheus"):
                    from ..telemetry import get_registry
                    print(get_registry().prometheus(), end="")
                else:
                    import json as _json
                    print(_json.dumps(node.get_metrics(), indent=2,
                                      sort_keys=True))
            elif op == "kernels":
                # kernel cost ledger: runs each canonical spec once on
                # the node's device on first use (seconds), cached for
                # the process; 'measure' adds a timed call + roofline %
                # of the card's peaks
                from .. import profiling
                dev = getattr(node._dht, "device", None)
                led = profiling.get_ledger()
                if rest and rest[0] == "measure":
                    led.measure(device=dev)
                else:
                    led.compute(device=dev)
                led.export_to_registry()
                entries = led.snapshot()
                print("%-28s %s" % ("kernel", "    ops   MFLOP  MB-bound"
                                    "  MB-args+out"))
                for name in sorted(entries):
                    e = entries[name]
                    if "error" in e:
                        print("%-28s ERROR %s" % (name, e["error"]))
                        continue
                    line = "%-28s %7d %7.2f %9.3f %12.3f" % (
                        name, e["launches"], e["flops_model"] / 1e6,
                        e["bytes_bound"] / 1e6,
                        (e["argument_bytes"] + e["output_bytes"]) / 1e6)
                    if "live_p50_s" in e:
                        line += "  live p50 %.3f ms (n=%d)" % (
                            e["live_p50_s"] * 1e3, e["live_count"])
                    rl = e.get("roofline")
                    if rl:
                        line += "  %.3f ms -> %s-bound, %.4f%% HBM peak" \
                            % (e["device_ms"], rl["bound"],
                               rl["hbm_pct_of_peak"])
                    print(line)
                print("%d kernels on %s; budgets gated by python -m "
                      "opendht_tpu_torch.perf_gate "
                      "(opendht_tpu_torch/perf_budgets.json)"
                      % (len(entries), dev if dev is not None else "?"))
            elif op == "ingest":
                # continuous-batching ingest health: the
                # wave builder's snapshot — same numbers dhtscanner
                # --json reports under "ingest" and the proxy exports
                # as dht_ingest_* series
                try:
                    snap = node._dht.wave_builder.snapshot()
                except AttributeError:
                    print("ingest state unavailable (proxy backend?)")
                    continue
                print("batching %s  fill_target %d  deadline %.1f ms  "
                      "queue %d/%d" % (
                          snap["batching"], snap["fill_target"],
                          snap["deadline_s"] * 1e3,
                          snap["queue_depth"], snap["queue_max"]))
                print("pipeline depth %d  in-flight %d (peak %d)"
                      % (snap.get("pipeline_depth", 1),
                         snap.get("inflight", 0),
                         snap.get("inflight_peak", 0)))
                print("waves %d  occupancy mean %.2f p50 %.1f p95 %.1f"
                      % (snap["waves"], snap["occupancy_mean"],
                         snap["occupancy_p50"], snap["occupancy_p95"]))
                print("time-in-queue p50 %.3f ms  p95 %.3f ms  sheds %d"
                      % (snap["queue_seconds_p50"] * 1e3,
                         snap["queue_seconds_p95"] * 1e3, snap["sheds"]))
            elif op == "trace":
                import json as _json
                from .. import tracing
                from ..testing.trace_assembler import assemble_trace
                tr = tracing.get_tracer()
                if rest and rest[0] == "chrome":
                    dump = tracing.to_chrome_trace(tr.records())
                    if len(rest) > 1:
                        with open(rest[1], "w") as fh:
                            _json.dump(dump, fh)
                        print("%d trace events -> %s (load in "
                              "ui.perfetto.dev)" % (
                                  len(dump["traceEvents"]), rest[1]))
                    else:
                        print(_json.dumps(dump))
                elif rest:
                    tree = assemble_trace([tr], rest[0])
                    print(_json.dumps(tree, indent=2, sort_keys=True))
                else:
                    seen = {}
                    for s in tr.spans():
                        seen.setdefault(s["trace_id"], [0, s["name"]])
                        seen[s["trace_id"]][0] += 1
                    for tid_, (cnt, name) in list(seen.items())[-20:]:
                        print("  %s  %3d spans  (%s)" % (tid_, cnt, name))
                    print("%d trace(s) in the ring" % len(seen))
            elif op == "health":
                # the node health verdict: same report the
                # proxy serves on GET /healthz
                import json as _json
                rep = node.get_health()
                print(_json.dumps(rep, indent=2, sort_keys=True))
                print("verdict: %s%s" % (
                    rep.get("verdict", "unknown"),
                    " (causes: %s)" % ", ".join(rep["causes"])
                    if rep.get("causes") else ""))
            elif op == "keyspace":
                # keyspace traffic observatory: same
                # snapshot the proxy serves on GET /keyspace
                import json as _json
                snap = node.get_keyspace()
                if rest and rest[0] == "json":
                    print(_json.dumps(snap, indent=2, sort_keys=True))
                elif not snap.get("enabled"):
                    print("keyspace observatory disabled")
                else:
                    print("window %.0f ids (%d lifetime)  occupied bins "
                          "%d/%d  candidates %d" % (
                              snap["window_total"], snap["observed_total"],
                              snap["occupied_bins"], snap["hist_bins"],
                              snap["candidates"]))
                    sh = snap["shards"]
                    print("shards: %s%d  loads %s  imbalance %s" % (
                        "virtual " if sh["virtual"] else "t=",
                        sh["n"] if sh["virtual"] else sh["t"],
                        sh["loads"],
                        sh["imbalance"] if sh["imbalance"] is not None
                        else "unknown"))
                    for t_ in snap["top"]:
                        print("  %s%s  est %d  share %.1f%%" % (
                            t_["key"], "  HOT" if t_["hot"] else "",
                            t_["estimate"], t_["share"] * 100))
                    if not snap["top"]:
                        print("  (no traffic observed yet)")
            elif op == "reshard":
                # load-aware resharding: same snapshot the
                # proxy serves on GET /reshard
                import json as _json
                snap = node.get_reshard()
                if rest and rest[0] == "json":
                    print(_json.dumps(snap, indent=2, sort_keys=True))
                elif not snap.get("enabled"):
                    print("resharding disabled")
                else:
                    lay = snap.get("layout")
                    print("gen %d%s  ticks %d  swaps %d  threshold %.2f  "
                          "sustain %.0fs  cooldown %.0fs" % (
                              snap["gen"],
                              " (%s)" % snap["mode"] if snap["mode"]
                              else "",
                              snap["ticks"], snap["swaps"],
                              snap["threshold"], snap["sustain"],
                              snap["min_interval"]))
                    skips = snap.get("skips") or {}
                    print("skips: %s" % (", ".join(
                        "%s=%d" % kv for kv in sorted(skips.items()))
                        or "none"))
                    if snap.get("latched_s") is not None:
                        print("imbalance above threshold for %.1fs"
                              % snap["latched_s"])
                    if lay is not None:
                        print("layout t=%d edges %s  post-swap "
                              "imbalance %s" % (
                                  lay["t"], lay["edges"],
                                  "%.3f" % snap["post_imbalance"]
                                  if snap.get("post_imbalance")
                                  is not None else "unknown"))
                    else:
                        print("layout: uniform (no swap yet)")
            elif op == "cache":
                # hot-key serving cache: same snapshot the
                # proxy serves on GET /cache
                import json as _json
                snap = node.get_cache()
                if rest and rest[0] == "json":
                    print(_json.dumps(snap, indent=2, sort_keys=True))
                elif not snap.get("enabled"):
                    print("hot-key cache disabled")
                else:
                    ratio = snap["hit_ratio"]
                    print("occupancy %d/%d  hit ratio %s  hits %d  "
                          "misses %d" % (
                              snap["occupancy"], snap["capacity"],
                              "%.3f" % ratio if ratio is not None
                              else "unknown",
                              snap["hits"], snap["misses"]))
                    print("admissions %d  evictions %d  invalidations "
                          "%d  replica k %d->%d on %d hot key(s)" % (
                              snap["admissions"], snap["evictions"],
                              snap["invalidations"],
                              snap["replica_k"]["base"],
                              snap["replica_k"]["widened"],
                              len(snap["hot_keys"])))
                    for ent in snap["entries"]:
                        print("  %s  %d value(s)  %d hit(s)%s  ttl %.1fs"
                              % (ent["key"], ent["values"], ent["hits"],
                                 "  store-backed" if ent["store_backed"]
                                 else "", ent["ttl_s"]))
                    if not snap["entries"]:
                        print("  (no hot keys cached yet)")
            elif op == "profile":
                # per-op latency waterfall: same snapshot
                # the proxy serves on GET /profile (?fmt=folded for
                # the 'folded' form)
                import json as _json
                if rest and rest[0] == "folded":
                    from .. import waterfall as _wf
                    print(_wf.get_profiler().folded(), end="")
                    continue
                snap = node.get_profile()
                if rest and rest[0] == "json":
                    print(_json.dumps(snap, indent=2, sort_keys=True))
                elif not snap.get("enabled"):
                    print("waterfall profiler disabled")
                else:
                    budgets = snap.get("budgets", {})
                    print("%-16s %8s %10s %10s %10s %10s" % (
                        "stage", "count", "p50 ms", "p95 ms", "p99 ms",
                        "budget ms"))
                    for stage, d in snap["stages"].items():
                        if not d.get("count") or d.get("alias_of"):
                            continue
                        print("%-16s %8d %10.3f %10.3f %10.3f %10.1f" % (
                            stage, d["count"], d["p50"] * 1e3,
                            d["p95"] * 1e3, d["p99"] * 1e3,
                            budgets.get(stage, 0.0) * 1e3))
                    ops = snap.get("ops", [])
                    print("%d per-op record(s) retained" % len(ops))
                    ob = snap.get("open_bounds")
                    if ob:
                        print("open bounds (%s, status %s):" % (
                            ob["platform"], ob["status"]))
                        for key_, b in sorted(ob["bounds"].items()):
                            print("  %-26s %s" % (
                                key_, "%.3f" % b["value"]
                                if b["value"] is not None
                                else "no measurement"))
            elif op == "pipeline":
                # pipeline utilization observatory: same snapshot the
                # proxy serves on
                # GET /pipeline
                import json as _json
                snap = node.get_pipeline()
                if rest and rest[0] == "json":
                    print(_json.dumps(snap, indent=2, sort_keys=True))
                elif not snap.get("enabled"):
                    print("pipeline observatory disabled")
                else:
                    occ = snap.get("occupancy", -1.0)
                    print("occupancy %s (window %.0fs)  depth %d  "
                          "inflight %d (peak %d)  overlap %s" % (
                              "%.1f%%" % (occ * 100) if occ >= 0
                              else "unknown",
                              snap.get("window_s", 0.0),
                              snap.get("pipeline_depth", 1),
                              snap.get("inflight", 0),
                              snap.get("inflight_peak", 0),
                              "%.2fx" % snap["overlap_ratio"]
                              if snap.get("overlap_ratio", -1) >= 0
                              else "unknown"))
                    print("%d wave(s), device busy %.3fs total" % (
                        snap.get("waves_total", 0),
                        snap.get("busy_seconds_total", 0.0)))
                    bubbles = snap.get("bubbles", {})
                    for cause, d in bubbles.items():
                        if d.get("count"):
                            print("  bubble %-18s %6d gap(s) %8.3fs" % (
                                cause, d["count"], d["seconds"]))
                    top = snap.get("top_bubble_cause")
                    print("top bubble cause: %s" % (top or "none"))
            elif op == "peers":
                # per-peer network observatory:
                # same snapshot the proxy serves on GET /peers
                import json as _json
                snap = node.get_peers()
                if rest and rest[0] == "json":
                    print(_json.dumps(snap, indent=2, sort_keys=True))
                elif not snap.get("enabled"):
                    print("peer ledger disabled")
                else:
                    print("%d peer(s) tracked (capacity %d, %d "
                          "evicted), adaptive RTO %s" % (
                              snap.get("tracked", 0),
                              snap.get("capacity", 0),
                              snap.get("evicted", 0),
                              "on" if snap.get("adaptive_rto")
                              else "off"))
                    print("%-28s %-8s %9s %9s %6s %6s %6s %5s" % (
                        "peer", "status", "srtt_ms", "rto_ms", "sent",
                        "done", "exp", "flap"))
                    for p in snap.get("peers", []):
                        print("%-28s %-8s %9s %9.1f %6d %6d %6d %5d"
                              % (p["peer"][:28], p["status"] or "?",
                                 "%.1f" % (p["srtt"] * 1e3)
                                 if p["srtt"] is not None else "-",
                                 p["rto"] * 1e3, p["sent"],
                                 p["completed"], p["expired"],
                                 p["flaps"]))
                    fs = snap.get("fail_signal")
                    print("worst-link fail ratio: %s" % (
                        "%.2f" % fs if fs is not None else "unknown"))
            elif op == "listeners":
                # device-resident listener table:
                # same snapshot the proxy serves on GET /listeners
                import json as _json
                snap = node.get_listeners()
                if rest and rest[0] == "json":
                    print(_json.dumps(snap, indent=2, sort_keys=True))
                elif not snap.get("enabled"):
                    print("listener table disabled (batching %s)" % (
                        snap.get("batching", "?"),))
                else:
                    print("%d/%d key(s) tracked (+%d overflow, %d "
                          "tombstone(s)), %d key(s) buffered" % (
                              snap.get("occupancy", 0),
                              snap.get("capacity", 0),
                              snap.get("overflow", 0),
                              snap.get("tombstones", 0),
                              snap.get("buffered", 0)))
                    print("flushes %d, matches %d, misses %d, "
                          "deliveries %d (%d value(s)), compactions %d"
                          % (snap.get("flushes", 0),
                             snap.get("matches", 0),
                             snap.get("misses", 0),
                             snap.get("deliveries", 0),
                             snap.get("values_delivered", 0),
                             snap.get("compactions", 0)))
                    lag = snap.get("lag_p95_s")
                    print("delivery lag p95: %s" % (
                        "%.1f ms" % (lag * 1e3)
                        if lag is not None and lag >= 0
                        else "unknown"))
                    for e in snap.get("entries", []):
                        print("  %s expires in %6.1fs" % (
                            e["key"], e["ttl_s"]))
            elif op == "bundle":
                # post-mortem black-box bundle: same
                # artifact the proxy serves on GET /debug/bundle
                import json as _json
                b = node.dump_bundle()
                if rest:
                    with open(rest[0], "w") as fh:
                        _json.dump(b, fh, indent=1, sort_keys=True)
                    print("bundle written to %s" % rest[0])
                h = b.get("history", {})
                print("bundle: %d history frame(s) (period %ss), %d "
                      "flight event(s) + %d span(s), verdict %s" % (
                          len(h.get("frames", [])),
                          h.get("period", "?"),
                          len(b["flight_recorder"]["events"]),
                          len(b["flight_recorder"]["spans"]),
                          b.get("health", {}).get("verdict", "unknown")))
                for a in b.get("auto_captures", []):
                    tr_ = a.get("transition") or {}
                    print("  auto-captured %s: %s -> %s (causes %s)" % (
                        time.strftime("%H:%M:%S",
                                      time.localtime(a.get("time", 0))),
                        tr_.get("from", "?"), tr_.get("to", "?"),
                        ", ".join(tr_.get("causes", [])) or "-"))
                if not b.get("auto_captures"):
                    print("  (no auto-captured bundles retained)")
            elif op == "dump":
                import json as _json
                n, name = 40, None
                for arg in rest[:2]:
                    if arg.isdigit():
                        n = int(arg)
                    else:
                        name = arg       # e.g. 'dump health'
                d = node.get_flight_recorder(limit=n, name=name)
                print(_json.dumps(d["events"], indent=2, sort_keys=True))
                print("flight recorder: %d/%d events shown%s, %d spans, "
                      "ring capacity %d" % (
                          len(d["events"]), n,
                          " (filter %r)" % name if name else "",
                          len(d["spans"]), d["capacity"]))
            elif op == "ll":
                d = node._dht
                for af in (socket.AF_INET,):
                    print(d.get_routing_tables_log(af))
                print(d.get_searches_log())
                print(d.get_storage_log())
            elif op == "lr":
                print(node._dht.get_routing_tables_log(socket.AF_INET))
            elif op == "ls":
                print(node._dht.get_searches_log())
            elif op == "la":
                print(node._dht.get_storage_log())
            elif op == "b":
                bs = parse_bootstrap(rest[0])
                node.bootstrap(*bs)
                print("bootstrapping %s:%d" % bs)
            elif op == "cc":
                node._post(lambda dht: dht.connectivity_changed(),
                           prio=True)
                print("connectivity change signalled")
            elif op == "g":
                key = to_hash(rest[0])
                t0 = time.monotonic()
                vals = node.get_sync(key, timeout=30.0)
                dt = time.monotonic() - t0
                for v in vals:
                    print("  %s" % _value_str(v))
                print("Get: %d value(s) in %.3fs" % (len(vals), dt))
            elif op == "q?":
                from ..core.value import Query
                key = to_hash(rest[0])
                q_str = " ".join(rest[1:])
                if ("where" not in q_str.lower()
                        and "select" not in q_str.lower()):
                    q_str = "where " + q_str    # 'q? <hash> id=42' shorthand
                q = Query(q_str)
                node.query(key, lambda fields: print("  fields: %s" % fields)
                           or True, lambda ok, ns: print("Query done: %s" % ok),
                           q)
            elif op == "l":
                key = to_hash(rest[0])
                tok = node.listen(key, lambda vals, expired: [
                    print("  %s %s" % ("EXPIRED" if expired else "LISTEN",
                                       _value_str(v))) for v in vals
                ] or True)
                t = tok.result(10.0)
                listen_tokens[t] = key
                print("listening, token %d" % t)
            elif op == "cl":
                t = int(rest[0])
                node.cancel_listen(listen_tokens.pop(t), t)
                print("cancelled %d" % t)
            elif op in ("p", "pp"):
                key = to_hash(rest[0])
                v = Value(" ".join(rest[1:]).encode())
                ok = node.put_sync(key, v, timeout=30.0,
                                   permanent=(op == "pp"))
                # the node assigns the random value id; 'cpp' needs it
                print("Put: %s (id %x)" % (ok, v.id))
            elif op == "cpp":
                node.cancel_put(to_hash(rest[0]),
                                int(rest[1], 16))
                print("cancelled")
            elif op == "s":
                key = to_hash(rest[0])
                done = []
                node.put_signed(key, Value(" ".join(rest[1:]).encode()),
                                lambda ok, ns: done.append(ok))
                _wait(done)
                print("PutSigned: %s" % (done and done[0]))
            elif op == "e":
                key = to_hash(rest[0])
                to = to_hash(rest[1])
                done = []
                node.put_encrypted(key, to,
                                   Value(" ".join(rest[2:]).encode()),
                                   lambda ok, ns: done.append(ok))
                _wait(done)
                print("PutEncrypted: %s" % (done and done[0]))
            elif op in ("il", "ii"):
                name = rest[0]
                if name not in indexes:
                    indexes[name] = Pht(name, {"k": 20}, node)
                pht = indexes[name]
                field = rest[1].encode()
                done = []
                if op == "il":
                    vid = int(rest[2]) if len(rest) > 2 else 1
                    pht.insert({"k": bytes(InfoHash.get(field))},
                               (node.get_node_id(), vid),
                               lambda ok: done.append(ok))
                    _wait(done)
                    print("Index insert: %s" % (done and done[0]))
                else:
                    pht.lookup({"k": bytes(InfoHash.get(field))},
                               cb=lambda vals, prefix: print(
                                   "  index values: %s" % (vals,)),
                               done_cb=lambda ok: done.append(ok))
                    _wait(done)
                    print("Lookup: %s" % (done and done[0]))
            elif op == "log":
                # toggle / route logging (↔ dhtnode.cpp:87-96)
                from ..log import DhtLogger
                if not hasattr(node, "_cli_logger"):
                    node._cli_logger = DhtLogger()
                lg = node._cli_logger
                arg = rest[0] if rest else "on"
                if arg == "off":
                    lg.disable()
                    print("logging off")
                elif arg == "file":
                    lg.set_sink_file(rest[1])
                    print("logging to %s" % rest[1])
                elif arg == "syslog":
                    lg.set_sink_syslog()
                    print("logging to syslog")
                elif len(arg) == 2 * InfoHash.HASH_LEN:
                    lg.set_filter(InfoHash(arg))
                    lg.set_sink_console()
                    print("logging filtered to %s" % arg)
                else:
                    lg.set_filter(None)
                    lg.set_sink_console()
                    print("logging on")
            elif op == "stt":
                from ..proxy import DhtProxyServer
                if proxy_server is not None:
                    proxy_server.stop()
                proxy_server = DhtProxyServer(node, int(rest[0]))
                print("proxy server on port %d" % proxy_server.port)
            elif op == "stp":
                if proxy_server:
                    proxy_server.stop()
                    proxy_server = None
                    print("proxy server stopped")
            elif op == "pst":
                node.enable_proxy(rest[0])
                print("backend switched to proxy %s" % rest[0])
            elif op == "psp":
                node.enable_proxy(None)
                print("backend switched to UDP")
            else:
                print("unknown op %r (h for help)" % op)
        except IndexError:
            print("missing argument (h for help)")
        except Exception as e:
            print("error: %s" % e)
    if proxy_server:
        proxy_server.stop()


def _wait(done, timeout=30.0):
    t0 = time.monotonic()
    while not done and time.monotonic() - t0 < timeout:
        time.sleep(0.02)


def main(argv=None) -> int:
    """(↔ main, dhtnode.cpp:480-545)"""
    p = make_arg_parser("OpenDHT-TPU node CLI")
    p.add_argument("--daemon", action="store_true",
                   help="run non-interactively (Ctrl-C to stop)")
    p.add_argument("--save-state", default="",
                   help="persist nodes+values to this file on exit and "
                        "restore them on start (checkpoint/resume)")
    args = p.parse_args(argv)
    node = setup_node(args)
    print_node_info(node)
    # SIGTERM (systemd/docker stop) must run the finally block so
    # --save-state persists for daemon deployments
    import signal as _signal

    def _on_term(signum, frame):
        raise KeyboardInterrupt

    try:
        _signal.signal(_signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass     # not the main thread / unsupported platform
    if args.save_state:
        import os as _os
        if _os.path.exists(args.save_state):
            from .common import load_state
            try:
                n_nodes, n_keys = load_state(node, args.save_state)
                print("restored %d nodes, %d keys from %s"
                      % (n_nodes, n_keys, args.save_state))
            except Exception as e:
                # a corrupt state file must not keep the node from
                # starting (the save path warns symmetrically)
                print("state restore failed: %s" % e)
    proxy_server = None
    if args.proxyserver:
        from ..proxy import DhtProxyServer
        proxy_server = DhtProxyServer(node, args.proxyserver)
        print("proxy server on port %d" % proxy_server.port)
    try:
        if args.daemon:
            while True:
                time.sleep(3600)
        else:
            cmd_loop(node, args)
    except KeyboardInterrupt:
        pass
    finally:
        if args.save_state:
            try:
                from .common import save_state
                save_state(node, args.save_state)
                print("state saved to %s" % args.save_state)
            except Exception as e:
                print("state save failed: %s" % e)
        if proxy_server:
            proxy_server.stop()
        node.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
