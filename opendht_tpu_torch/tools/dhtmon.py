"""dhtmon: cluster health invariants CLI.

Scrapes every listed node's ``GET /healthz`` + ``GET /stats`` (the
proxy surfaces of opendht_tpu_torch/health.py) and checks the cluster
invariants with exit-code thresholds, so one command drives CI gates,
soak monitors and pager policy:

- per-node verdicts (``--require-ready`` fails unless every node's
  /healthz returns 200);
- global lookup success rate from the summed op-outcome counters
  (``--min-success R``);
- cluster op-latency percentiles from the merged
  ``dht_op_seconds_bucket`` series, via the ONE ``--alert PCT=SEC``
  grammar shared with testing/network_monitor.py (health.parse_alerts);
- the batched replica-coverage probe (``--min-coverage R``) when
  invoked programmatically with in-process runners
  (:func:`run_checks` ``runners=``; the probe needs the cluster's
  stores — testing/health_monitor.replica_coverage), resolving every
  sampled key's true closest-8 in ONE batched device launch on
  ``device`` (None = the CUDA card).

Exit codes: 0 = all invariants hold; 1 = an invariant violated;
2 = usage / scrape error.

Usage::

    python -m opendht_tpu_torch.tools.dhtmon --nodes 127.0.0.1:8080 \\
        --min-success 0.99 --alert p95=2.5 --require-ready [--json]

The port's copy of the JAX package's ``tools/dhtmon.py``, behaviour,
violations, report and exit codes unchanged.  The CLI only scrapes
HTTP and touches no device; the probe (``run_checks(runners=,
device=)``) resolves on the CUDA card unless ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from typing import List, Optional

from ..health import (parse_alerts, percentile_breaches,
                      quantile_from_cumulative)
from ..testing import health_monitor as hm
from ..waterfall import STAGE_ALIASES, STAGES

#: ``dht_stage_seconds_bucket{stage="queue_wait",le="0.001"}`` →
#: (stage, le) — both label orders, like health_monitor._BUCKET_RE
_STAGE_BUCKET_RE = re.compile(
    r'^dht_stage_seconds_bucket\{le="([^"]+)",stage="([^"]+)"\}$'
    r'|^dht_stage_seconds_bucket\{stage="([^"]+)",le="([^"]+)"\}$')


def _stage_p95s(series: dict) -> dict:
    """Per-stage p95 off one node's scraped ``dht_stage_seconds``
    buckets (+Inf dropped; a never-observed stage exports no finite
    buckets and is simply absent — unknown, never a violation)."""
    per: dict = {}
    for name, v in series.items():
        m = _STAGE_BUCKET_RE.match(name)
        if not m:
            continue
        le_s, stage = ((m.group(1), m.group(2)) if m.group(1) is not None
                       else (m.group(4), m.group(3)))
        if le_s == "+Inf":
            continue
        per.setdefault(stage, []).append((float(le_s), v))
    return {stage: quantile_from_cumulative(sorted(pairs), 0.95)
            for stage, pairs in per.items()}


def run_checks(endpoints: List[str] = (), runners=(), alerts=None,
               min_success: Optional[float] = None,
               min_coverage: Optional[float] = None,
               require_ready: bool = False, op: str = "get",
               sample_max: int = 64, k: int = 8, mesh=None,
               window: float = 0.0, since: Optional[float] = None,
               max_imbalance: Optional[float] = None,
               min_cache_hit: Optional[float] = None,
               max_stage: Optional[dict] = None,
               min_occupancy: Optional[float] = None,
               max_peer_fail: Optional[float] = None,
               max_listener_lag: Optional[float] = None,
               device=None) -> tuple:
    """Scrape + evaluate; returns ``(violations, doc)`` where ``doc``
    is the JSON-able cluster report and ``violations`` is a list of
    human-readable invariant failures (empty = healthy).

    ``window > 0`` evaluates the success/latency invariants over a
    WINDOW.  The PREFERRED source is each node's
    ``GET /history`` endpoint (the flight data recorder's retained
    delta frames: no second scrape, no wait — the window already
    happened); only when a node does not export history does the check
    fall back to the legacy scrape-diff-scrape (scrape, wait
    ``window`` seconds, scrape again, diff the cumulative series).
    Both sources feed the SAME invariant code (``lookup_success`` /
    ``cluster_quantile`` over one summed series map — pinned equal in
    tests/test_history.py).  ``since`` is the strict form: evaluate
    over the last ``since`` seconds of HISTORY ONLY, raising when any
    node lacks the endpoint (no silent wait) — the soak/CI gate form.
    The default (0) reads the since-boot cumulative ratio — right for
    a CI smoke's bounded lifetime, wrong for a week-old soak, where
    lifetime counters both hide a fresh outage and remember a
    recovered one forever.
    ONLY the success/latency invariants window: readiness, the
    replica-coverage probe and the imbalance gauge are point-in-time
    by nature, so when no windowed invariant is requested
    (``min_success`` unset and no ``alerts``) the history/baseline
    scrape and any wait are skipped entirely (a coverage-only
    ``--window`` run would otherwise scrape every node twice for
    nothing).

    ``max_imbalance`` gates the keyspace observatory's
    per-shard load balance: the worst node's ``dht_shard_imbalance``
    gauge (max/mean per-shard windowed traffic; -1 = unknown, never a
    violation) must not exceed it.

    ``min_cache_hit`` gates the hot-key serving cache: the
    worst node's ``dht_cache_hit_ratio`` gauge (windowed hits /
    eligible probes) must not drop below it — the SAME unknown
    contract as ``max_imbalance``: a -1/absent gauge (cache disabled,
    dark, or no probes in the window) never violates.

    ``max_stage`` ({stage: seconds}) gates the latency
    waterfall: the worst node's per-stage p95 off its scraped
    ``dht_stage_seconds`` buckets must not exceed the stage's
    threshold.  Per-node like the other gauge gates (one slow node
    must not hide inside a cluster merge); a never-observed stage is
    unknown and never violates.

    ``min_occupancy`` gates the pipeline observatory: the
    worst node's ``dht_pipeline_occupancy`` gauge (windowed fraction
    of wall clock with >= 1 wave in flight on the device) must not
    drop below it — the SAME unknown contract as the other gauge
    gates: a -1/absent gauge (observatory off, or no window closed
    yet) never violates.

    ``max_peer_fail`` gates the per-peer ledger: the worst
    single link's ``dht_peer_fail_ratio{peer=}`` gauge (expired /
    finished requests of one peer, published only past
    ``Config.peers.min_signal_events`` requests) must not exceed it
    across any node — the per-LINK view next to the cluster-wide
    timeout ratio, so one dying link cannot hide inside healthy
    aggregates.  The SAME unknown contract as ``--max-imbalance``: a
    -1/absent gauge (ledger off, peer evicted, or too little traffic
    to judge) never violates.

    ``max_listener_lag`` gates the listener table: the worst
    node's ``dht_listener_lag_p95`` gauge (windowed p95 of store-time
    -> coalesced-delivery-dispatch lag through the wave-batched match,
    seconds) must not exceed it — a drain stall or a fattened flush
    deadline shows up here before subscribers notice.  The SAME
    unknown contract as ``--max-imbalance``: a -1/absent gauge (table
    off, batching off, dark, or no delivery in the window) never
    violates.

    ``device`` is where the replica-coverage probe's census resolves
    (None = the CUDA card, raising when there is none); it is read only
    when ``runners`` are given."""
    alerts = alerts or {}
    violations: List[str] = []
    baseline = None
    hist_series = None
    window_source = None
    windowed = min_success is not None or bool(alerts)
    if since is not None and not since > 0:
        # a non-positive --since would silently fall through to the
        # since-boot cumulative evaluation — the exact failure mode
        # --since exists to prevent; refuse loudly (exit 2 in main)
        raise ValueError("--since must be a positive window (got %g)"
                         % since)
    if since is not None and not endpoints:
        # runners-only invocations have no GET /history to read; a
        # silent skip would report a windowed gate passed when nothing
        # was evaluated
        raise ValueError("--since requires proxy endpoints exporting "
                         "GET /history")
    win = since if since is not None else window
    if windowed and endpoints and win > 0:
        # the history endpoint IS the window — no second
        # scrape, no wait.  All-or-nothing across nodes: a mixed
        # cluster would double-count traffic if half the series were
        # windowed deltas and half cumulative diffs.
        hists = []
        for ep in endpoints:
            h = hm.scrape_history(ep, win)
            if h is None:
                hists = None
                break
            hists.append(h)
        if hists is not None:
            hist_series = hm.merge_history_series(hists)
            window_source = "history"
        elif since is not None:
            raise RuntimeError(
                "--since requires every node to export GET /history "
                "(the flight data recorder)")
        else:
            baseline = hm.merge_series([hm.scrape_node(ep)
                                        for ep in endpoints])
            time.sleep(window)
            window_source = "scrape-diff"
    scrapes = []
    for ep in endpoints:
        scrapes.append(hm.scrape_node(ep))
    doc: dict = {
        "nodes": [{"endpoint": s["endpoint"], "ready": s["ready"],
                   "verdict": s["verdict"]} for s in scrapes],
        "window_s": (win or None) if windowed else None,
        "window_source": window_source,
    }
    if require_ready:
        for s in scrapes:
            if not s["ready"]:
                violations.append("node %s not ready (verdict %s)"
                                  % (s["endpoint"], s["verdict"]))
    series = hm.merge_series(scrapes) if scrapes else {}
    if hist_series is not None:
        # the recorder's summed frame deltas have the same shape as a
        # scrape diff (history.frames_to_series) — the invariant code
        # below cannot tell the sources apart
        series = hist_series
    elif baseline is not None:
        # cumulative counters and cumulative-by-le buckets both diff
        # cleanly; only the summed counter/bucket series are read below
        series = {key: max(v - baseline.get(key, 0.0), 0.0)
                  for key, v in series.items()}
    ls = hm.lookup_success(series, op=op) if series else None
    doc["lookup_success"] = (
        {"ratio": ls[0], "ops": ls[1]} if ls is not None else None)
    if min_success is not None and ls is not None and ls[0] < min_success:
        violations.append(
            "lookup success %.4f < %.4f over %d %s ops"
            % (ls[0], min_success, int(ls[1]), op))
    if alerts and series:
        doc["latency"] = {
            "p%g" % p: hm.cluster_quantile(series, op, p / 100.0)
            for p in sorted(alerts)}
        for pct, v, thr in percentile_breaches(
                lambda q: hm.cluster_quantile(series, op, q), alerts):
            violations.append("cluster %s p%g %.3fs exceeds %.3fs"
                              % (op, pct, v, thr))
    if max_imbalance is not None and scrapes:
        # per-node, NOT merged: imbalance ratios don't sum — the gate
        # is "no node's keyspace is lopsided", so take the worst node
        # (-1/absent = observatory unknown, never a violation)
        per_node = []
        for s in scrapes:
            vals = [v for name, v in s["series"].items()
                    if name.startswith("dht_shard_imbalance") and v >= 0]
            per_node.append({"endpoint": s["endpoint"],
                             "imbalance": max(vals) if vals else None})
        known = [p["imbalance"] for p in per_node
                 if p["imbalance"] is not None]
        worst = max(known) if known else None
        doc["shard_imbalance"] = {"max": worst, "per_node": per_node}
        if worst is not None and worst > max_imbalance:
            violations.append(
                "shard imbalance %.3f exceeds %.3f (worst node %s)"
                % (worst, max_imbalance,
                   max(per_node, key=lambda p: p["imbalance"] or -1)
                   ["endpoint"]))
    if min_cache_hit is not None and scrapes:
        # per-node, worst = MIN: the gate is "every node's hot traffic
        # is actually being served from its cache" — -1/absent =
        # unknown (disabled / no probe window), never a violation
        per_node = []
        for s in scrapes:
            vals = [v for name, v in s["series"].items()
                    if name.startswith("dht_cache_hit_ratio") and v >= 0]
            per_node.append({"endpoint": s["endpoint"],
                             "hit_ratio": min(vals) if vals else None})
        known = [p["hit_ratio"] for p in per_node
                 if p["hit_ratio"] is not None]
        worst = min(known) if known else None
        doc["cache_hit"] = {"min": worst, "per_node": per_node}
        if worst is not None and worst < min_cache_hit:
            violations.append(
                "cache hit ratio %.3f below %.3f (worst node %s)"
                % (worst, min_cache_hit,
                   min(per_node,
                       key=lambda p: p["hit_ratio"]
                       if p["hit_ratio"] is not None else 2.0)
                   ["endpoint"]))
    if min_occupancy is not None and scrapes:
        # per-node, worst = MIN: the gate is "every node's device is
        # actually being kept busy by its pipeline" — -1/absent =
        # unknown (observatory off / no closed window), never a
        # violation, matching the other gauge gates
        per_node = []
        for s in scrapes:
            vals = [v for name, v in s["series"].items()
                    if name.startswith("dht_pipeline_occupancy")
                    and v >= 0]
            per_node.append({"endpoint": s["endpoint"],
                             "occupancy": min(vals) if vals else None})
        known = [p["occupancy"] for p in per_node
                 if p["occupancy"] is not None]
        worst = min(known) if known else None
        doc["pipeline_occupancy"] = {"min": worst, "per_node": per_node}
        if worst is not None and worst < min_occupancy:
            violations.append(
                "pipeline occupancy %.4f below %.4f (worst node %s)"
                % (worst, min_occupancy,
                   min(per_node,
                       key=lambda p: p["occupancy"]
                       if p["occupancy"] is not None else 2.0)
                   ["endpoint"]))
    if max_peer_fail is not None and scrapes:
        # per-node, worst = MAX over that node's per-peer fail-ratio
        # gauges: the gate is "no single link is silently dying" —
        # -1/absent = unknown (ledger off / evicted peer / below
        # min_signal_events), never a violation, matching the other
        # gauge gates.  The gauge name prefix matches every peer label
        # series of dht_peer_fail_ratio.
        per_node = []
        for s in scrapes:
            vals = [v for name, v in s["series"].items()
                    if name.startswith("dht_peer_fail_ratio")
                    and v >= 0]
            per_node.append({"endpoint": s["endpoint"],
                             "peer_fail": max(vals) if vals else None})
        known = [p["peer_fail"] for p in per_node
                 if p["peer_fail"] is not None]
        worst = max(known) if known else None
        doc["peer_fail"] = {"max": worst, "per_node": per_node}
        if worst is not None and worst > max_peer_fail:
            violations.append(
                "peer fail ratio %.3f exceeds %.3f (worst node %s)"
                % (worst, max_peer_fail,
                   max(per_node,
                       key=lambda p: p["peer_fail"]
                       if p["peer_fail"] is not None else -1.0)
                   ["endpoint"]))
    if max_listener_lag is not None and scrapes:
        # per-node, worst = MAX: the gate is "no node's wave-batched
        # listen/push delivery is lagging subscribers" — -1/absent =
        # unknown (table off, batching off, dark, or no delivery
        # window), never a violation, matching the other gauge gates
        per_node = []
        for s in scrapes:
            vals = [v for name, v in s["series"].items()
                    if name.startswith("dht_listener_lag_p95")
                    and v >= 0]
            per_node.append({"endpoint": s["endpoint"],
                             "listener_lag": max(vals) if vals else None})
        known = [p["listener_lag"] for p in per_node
                 if p["listener_lag"] is not None]
        worst = max(known) if known else None
        doc["listener_lag"] = {"max": worst, "per_node": per_node}
        if worst is not None and worst > max_listener_lag:
            violations.append(
                "listener delivery lag p95 %.4fs exceeds %.4fs "
                "(worst node %s)"
                % (worst, max_listener_lag,
                   max(per_node,
                       key=lambda p: p["listener_lag"]
                       if p["listener_lag"] is not None else -1.0)
                   ["endpoint"]))
    if max_stage and scrapes:
        # per-node, worst = MAX p95 per stage: the gate is "no node's
        # serving stage blew its latency budget" — a stage with no
        # finite buckets (never observed) is unknown, never a violation
        per_node = [{"endpoint": s["endpoint"],
                     "p95": _stage_p95s(s["series"])} for s in scrapes]
        worst: dict = {}
        for stage, thr in sorted(max_stage.items()):
            vals = [(p["p95"][stage], p["endpoint"]) for p in per_node
                    if p["p95"].get(stage) is not None]
            w = max(vals) if vals else None
            worst[stage] = {"p95": w[0] if w else None, "threshold": thr}
            if w is not None and w[0] > thr:
                violations.append(
                    "stage %s p95 %.4fs exceeds %.4fs (worst node %s)"
                    % (stage, w[0], thr, w[1]))
        doc["stages"] = {"worst": worst, "per_node": per_node}
    if runners:
        cov = hm.replica_coverage(runners, sample_max=sample_max, k=k,
                                  mesh=mesh, device=device)
        doc["replica_coverage"] = cov
        if min_coverage is not None and cov["keys"] and \
                cov["mean_coverage"] < min_coverage:
            violations.append(
                "replica coverage %.3f < %.3f over %d keys "
                "(min per-key %.3f)"
                % (cov["mean_coverage"], min_coverage, cov["keys"],
                   cov["min_coverage"]))
    doc["violations"] = violations
    return violations, doc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="cluster health invariants monitor (exit-code "
                    "thresholds for CI and soak)")
    p.add_argument("--nodes", action="append", default=[],
                   metavar="HOST:PORT[,HOST:PORT...]",
                   help="proxy endpoints to scrape (repeatable or "
                        "comma-separated)")
    p.add_argument("--alert", action="append", default=[],
                   metavar="PCT=SEC",
                   help="fail when the cluster-merged op latency "
                        "percentile exceeds SEC (e.g. --alert p95=2.5; "
                        "the same grammar as network_monitor)")
    p.add_argument("--min-success", type=float, default=None,
                   metavar="R",
                   help="fail when the global lookup success ratio "
                        "drops below R (e.g. 0.99)")
    p.add_argument("--require-ready", action="store_true",
                   help="fail unless every node's GET /healthz is 200")
    p.add_argument("--op", default="get",
                   help="op family for the success/latency invariants "
                        "(default: get)")
    p.add_argument("--window", type=float, default=0.0, metavar="SEC",
                   help="evaluate the SUCCESS/LATENCY invariants over "
                        "a SEC-second window instead of the "
                        "since-boot cumulative — use for long-lived "
                        "clusters, where lifetime ratios hide fresh "
                        "outages and remember recovered ones.  Reads "
                        "each node's GET /history frames (the "
                        "flight data recorder: no wait) when every "
                        "node exports them, falling back to scrape-"
                        "wait-scrape-diff otherwise.  Readiness, the "
                        "replica-coverage probe and --max-imbalance "
                        "are point-in-time and unaffected; with no "
                        "windowed invariant requested the extra "
                        "scrapes are skipped entirely")
    p.add_argument("--since", type=float, default=None, metavar="SEC",
                   help="like --window, but STRICTLY from the nodes' "
                        "GET /history frames over the last SEC "
                        "seconds — exits 2 when any node lacks the "
                        "recorder instead of silently waiting out a "
                        "scrape-diff window (the soak/CI gate form)")
    p.add_argument("--max-imbalance", type=float, default=None,
                   metavar="R",
                   help="fail when any node's keyspace shard-load "
                        "imbalance (dht_shard_imbalance: max/mean "
                        "per-shard windowed traffic from the count-min "
                        "observatory) exceeds R — 1.0 is perfect "
                        "balance, the shard count is a single-shard "
                        "flood; unknown (no traffic window) never "
                        "violates")
    p.add_argument("--min-cache-hit", type=float, default=None,
                   metavar="R",
                   help="fail when any node's hot-key cache hit ratio "
                        "(dht_cache_hit_ratio: windowed hits / eligible "
                        "probes from the hot-key serving cache) drops "
                        "below R — unknown (-1/absent: cache disabled "
                        "or no probe window) never violates, matching "
                        "the --max-imbalance contract")
    p.add_argument("--min-occupancy", type=float, default=None,
                   metavar="R",
                   help="fail when any node's pipeline device "
                        "occupancy (dht_pipeline_occupancy: windowed "
                        "fraction of wall clock with >=1 wave in "
                        "flight, from the pipeline observatory) drops "
                        "below R — unknown (-1/absent: observatory "
                        "off or no closed window) never violates, "
                        "matching the --min-cache-hit contract")
    p.add_argument("--max-peer-fail", type=float, default=None,
                   metavar="R",
                   help="fail when any single link's fail ratio "
                        "(dht_peer_fail_ratio{peer=}: expired / "
                        "finished requests to one peer, from the "
                        "per-peer ledger) exceeds R on any "
                        "node — unknown (-1/absent: ledger off, peer "
                        "evicted, or below Config.peers."
                        "min_signal_events requests) never violates, "
                        "matching the --max-imbalance contract")
    p.add_argument("--max-listener-lag", type=float, default=None,
                   metavar="SEC",
                   help="fail when any node's listener delivery lag "
                        "p95 (dht_listener_lag_p95: windowed store->"
                        "coalesced-dispatch lag through the "
                        "wave-batched match, seconds) exceeds SEC — "
                        "unknown (-1/absent: table off, batching off, "
                        "dark, or no delivery window) never violates, "
                        "matching the --max-imbalance contract")
    p.add_argument("--max-stage", action="append", default=[],
                   metavar="STAGE=SEC",
                   help="fail when any node's p95 for a latency "
                        "waterfall stage (dht_stage_seconds: "
                        "queue_wait, cache_probe, device_compile, "
                        "dispatch, device_wait, scatter_back, "
                        "rpc_wait) exceeds SEC (repeatable, e.g. "
                        "--max-stage device_wait=0.25); "
                        "device_launch is accepted as a one-release "
                        "alias of device_wait (the stage split); "
                        "a never-observed stage is unknown and never "
                        "violates")
    p.add_argument("--json", action="store_true",
                   help="emit the full cluster report as one JSON doc")
    args = p.parse_args(argv)
    try:
        alerts = parse_alerts(args.alert)
    except ValueError as e:
        print("dhtmon:", e, file=sys.stderr)
        return 2
    max_stage: dict = {}
    for spec in args.max_stage:
        stage, eq, sec = spec.partition("=")
        # one-release compatibility: --max-stage
        # device_launch=... resolves to the canonical device_wait
        # stage instead of silently failing to match anything
        stage = STAGE_ALIASES.get(stage, stage)
        try:
            if not eq or stage not in STAGES:
                raise ValueError
            max_stage[stage] = float(sec)
        except ValueError:
            print("dhtmon: invalid --max-stage %r (want STAGE=SEC, "
                  "STAGE one of %s)" % (spec, ", ".join(STAGES)),
                  file=sys.stderr)
            return 2
    endpoints = [ep for spec in args.nodes for ep in spec.split(",") if ep]
    if not endpoints:
        print("dhtmon: no --nodes given", file=sys.stderr)
        return 2
    try:
        violations, doc = run_checks(
            endpoints, alerts=alerts, min_success=args.min_success,
            require_ready=args.require_ready, op=args.op,
            window=args.window, since=args.since,
            max_imbalance=args.max_imbalance,
            min_cache_hit=args.min_cache_hit,
            max_stage=max_stage or None,
            min_occupancy=args.min_occupancy,
            max_peer_fail=args.max_peer_fail,
            max_listener_lag=args.max_listener_lag)
    except Exception as e:
        print("dhtmon: scrape failed: %s" % e, file=sys.stderr)
        return 2
    if args.json:
        json.dump(doc, sys.stdout)
        print()
    else:
        for n in doc["nodes"]:
            print("node %s: %s%s" % (n["endpoint"], n["verdict"],
                                     "" if n["ready"] else " (NOT READY)"))
        if doc.get("window_source"):
            print("window: %gs via %s" % (doc["window_s"],
                                          doc["window_source"]))
        ls = doc.get("lookup_success")
        if ls:
            print("lookup success: %.4f over %d ops"
                  % (ls["ratio"], int(ls["ops"])))
        for name, v in sorted((doc.get("latency") or {}).items()):
            print("cluster %s %s: %s" % (
                args.op, name, "%.3fs" % v if v is not None else "n/a"))
        imb = doc.get("shard_imbalance")
        if imb:
            print("shard imbalance: %s (worst node)" % (
                "%.3f" % imb["max"] if imb["max"] is not None
                else "unknown"))
        ch = doc.get("cache_hit")
        if ch:
            print("cache hit ratio: %s (worst node)" % (
                "%.3f" % ch["min"] if ch["min"] is not None
                else "unknown"))
        po = doc.get("pipeline_occupancy")
        if po:
            print("pipeline occupancy: %s (worst node)" % (
                "%.4f" % po["min"] if po["min"] is not None
                else "unknown"))
        pf = doc.get("peer_fail")
        if pf:
            print("peer fail ratio: %s (worst link)" % (
                "%.3f" % pf["max"] if pf["max"] is not None
                else "unknown"))
        ll = doc.get("listener_lag")
        if ll:
            print("listener lag p95: %s (worst node)" % (
                "%.4fs" % ll["max"] if ll["max"] is not None
                else "unknown"))
        for stage, w in sorted((doc.get("stages") or {})
                               .get("worst", {}).items()):
            print("stage %s p95: %s (max %.4fs, worst node)" % (
                stage, "%.4fs" % w["p95"] if w["p95"] is not None
                else "unknown", w["threshold"]))
    for v in violations:
        print("ALERT:", v, file=sys.stderr)
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
