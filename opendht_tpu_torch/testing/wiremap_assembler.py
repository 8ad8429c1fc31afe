"""Cluster wire-map assembly over per-peer ledgers.

The trace assembler stitches ONE operation's span tree, the
timeline assembler stitches the cluster's metrics history —
this module stitches the cluster's WIRE: every node's per-peer ledger
snapshot (``GET /peers``, opendht_tpu_torch/peers.py) merged into one
directed link graph, so a soak harness or game-day scorecard can
answer "which edge is slow / lossy / flapping" instead of reading
cluster-wide aggregates that smear a single bad link over every node.
A chaos-plane ``LinkRule`` injected on ONE link shows up on exactly
that directed edge.

Sources accepted by :func:`assemble_wiremap` (the assemblers' shared
duck-typing): a ``GET /peers`` document (:func:`scrape_peers` stamps
``scraped_at`` so skew is estimable), a ``DhtRunner``-like
(``get_peers()``), or a raw :class:`~opendht_tpu_torch.peers.PeerLedger`.

**Skew**: each scrape document carries the serving node's clock
(``time``) next to the scraper's (``scraped_at``); their difference
estimates that node's offset and every edge's ``first_seen`` /
``last_seen`` gains an adjusted ``*_adj`` twin before comparison
(same-host clusters estimate ~0).  **Sanity** is checked per node like
the timeline assembler's monotonicity pass: a peer row stamped after
its own snapshot time (``last_seen > time + CLOCK_SLACK``) or with
``first_seen > last_seen`` is REPORTED in ``violations``, never
dropped — a post-mortem tool must degrade, not lie.

The port's copy of the JAX package's ``testing/wiremap_assembler.py``,
behaviour unchanged.
"""

from __future__ import annotations

import json
import sys
import time
import urllib.request
from typing import List, Optional

#: tolerance for "a peer row from the future": rows stamp the ledger
#: clock per event, snapshots stamp it once — only lock-release
#: ordering jitter remains (the timeline assembler's CLOCK_SLACK)
CLOCK_SLACK = 0.050


def scrape_peers(endpoint: str, timeout: float = 10.0) -> Optional[dict]:
    """One node's ``GET /peers`` document with the LOCAL wall clock
    stamped as ``scraped_at`` so :func:`assemble_wiremap` can estimate
    skew.  ``None`` when the node does not export the route (scrape
    error or ledger disabled)."""
    base = "http://" + endpoint.rstrip("/")
    try:
        with urllib.request.urlopen(base + "/peers", timeout=timeout) as r:
            doc = json.loads(r.read().decode())
    except Exception:
        return None
    if not isinstance(doc, dict) or not doc.get("enabled"):
        return None
    doc["endpoint"] = endpoint
    doc["scraped_at"] = time.time()
    return doc


def _extract(source) -> Optional[dict]:
    """Normalize one source into a peers document (or None)."""
    if isinstance(source, dict):
        return source if source.get("enabled") else None
    if hasattr(source, "get_peers"):               # DhtRunner-like
        return _extract(source.get_peers())
    if hasattr(source, "snapshot"):                # raw PeerLedger
        return _extract(source.snapshot())
    return None


def _skew(doc: dict) -> float:
    """Serving-node clock minus scraper wall clock at scrape time —
    0.0 when either stamp is missing (in-process sources share the
    clock)."""
    t = doc.get("time")
    at = doc.get("scraped_at")
    if t is None or at is None:
        return 0.0
    return float(t) - float(at)


def assemble_wiremap(sources) -> dict:
    """Merge every source's per-peer ledger into one directed link
    graph.

    Returns ``{"nodes", "edges", "skew", "violations"}``: ``nodes``
    lists one entry per scraped ledger (id, endpoint, tracked count,
    estimated skew); ``edges`` is one directed entry per (scraping
    node -> tracked peer) with the full per-peer attribution (srtt /
    rttvar / rto, outcome counts, attempt timeouts, spurious
    retransmits, fail ratio, bytes by type, status + flaps) plus
    skew-adjusted ``first_seen_adj`` / ``last_seen_adj`` and ``known``
    (True when the peer id is itself one of the scraped nodes — the
    edge's far end is inside the map)."""
    nodes: List[dict] = []
    docs: List[dict] = []
    violations: List[str] = []
    for si, source in enumerate(sources):
        doc = _extract(source)
        if doc is None:
            violations.append("source %d: no per-peer ledger" % si)
            continue
        docs.append(doc)
    ids = {d.get("node", "") for d in docs if d.get("node")}
    skews = {}
    edges: List[dict] = []
    for si, doc in enumerate(docs):
        src = doc.get("node") or ("source-%d" % si)
        skew = _skew(doc)
        skews[src] = skew
        snap_t = float(doc.get("time") or 0.0)
        nodes.append({
            "id": src,
            "endpoint": doc.get("endpoint", ""),
            "tracked": doc.get("tracked", 0),
            "evicted": doc.get("evicted", 0),
            "adaptive_rto": bool(doc.get("adaptive_rto")),
            "skew": skew,
        })
        for p in doc.get("peers") or []:
            first = float(p.get("first_seen") or 0.0)
            last = float(p.get("last_seen") or 0.0)
            if last > snap_t + CLOCK_SLACK:
                violations.append(
                    "node %s: peer %s last seen %.3fs after its own "
                    "snapshot" % (src, p.get("peer"), last - snap_t))
            if first > last:
                violations.append(
                    "node %s: peer %s first_seen %.3f after last_seen "
                    "%.3f" % (src, p.get("peer"), first, last))
            e = dict(p)
            e["src"] = src
            e["dst"] = p.get("id") or p.get("addr", "")
            e["known"] = e["dst"] in ids
            e["first_seen_adj"] = first - skew
            e["last_seen_adj"] = last - skew
            edges.append(e)
    return {"nodes": nodes, "edges": edges, "skew": skews,
            "violations": violations}


def rank_edges(wiremap: dict, metric: str = "fail_ratio",
               descending: bool = True) -> List[dict]:
    """Edges ordered by one attribution metric, worst first by
    default; edges where the metric is None/absent (unknown — e.g. no
    RTT sample yet, or below the ledger's signal floor) are EXCLUDED,
    the same never-violates contract every per-peer reader follows."""
    known = [e for e in wiremap["edges"] if e.get(metric) is not None]
    return sorted(known, key=lambda e: e[metric], reverse=descending)


def worst_edge(wiremap: dict, metric: str = "fail_ratio"
               ) -> Optional[dict]:
    """The single worst edge by ``metric`` (None when every edge is
    unknown) — the wire-level answer behind
    ``dhtmon --max-peer-fail``'s cluster verdict."""
    ranked = rank_edges(wiremap, metric)
    return ranked[0] if ranked else None


def find_edge(wiremap: dict, src: str, dst: str) -> Optional[dict]:
    """The directed edge src -> dst (full node ids), or None — lets a
    harness assert an injected fault landed on exactly the link it was
    armed on."""
    for e in wiremap["edges"]:
        if e["src"] == src and e["dst"] == dst:
            return e
    return None


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        description="assemble the cluster wire map from GET /peers")
    p.add_argument("endpoints", nargs="+", metavar="HOST:PORT",
                   help="proxy endpoints to scrape")
    p.add_argument("--json", action="store_true",
                   help="dump the assembled map as JSON")
    p.add_argument("--metric", default="fail_ratio",
                   help="ranking metric for the edge table "
                        "(default: fail_ratio)")
    args = p.parse_args(argv)
    docs = []
    for ep in args.endpoints:
        doc = scrape_peers(ep)
        if doc is None:
            print("wiremap: %s exports no per-peer ledger" % ep,
                  file=sys.stderr)
        else:
            docs.append(doc)
    wm = assemble_wiremap(docs)
    if args.json:
        json.dump(wm, sys.stdout)
        print()
    else:
        print("%d node(s), %d directed edge(s)" % (
            len(wm["nodes"]), len(wm["edges"])))
        for e in rank_edges(wm, args.metric):
            srtt = e.get("srtt")
            print("%s -> %s  %s=%.4g  srtt=%s  sent=%d expired=%d "
                  "flaps=%d" % (
                      e["src"][:12], str(e["dst"])[:12], args.metric,
                      e[args.metric],
                      "%.1fms" % (srtt * 1e3) if srtt is not None
                      else "-", e.get("sent", 0), e.get("expired", 0),
                      e.get("flaps", 0)))
        for v in wm["violations"]:
            print("VIOLATION:", v, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
