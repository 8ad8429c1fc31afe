"""Cross-node span assembly + the tracing smoke.

:func:`assemble_trace` scrapes every cluster node's flight-recorder
ring (``DhtRunner.get_trace``; any object with a ``get_trace`` method,
or a raw span list, works — a remote node's ``GET /trace/<id>`` JSON
plugs straight in) and reconstructs the full span tree of one
operation: op root span → per-hop client RPC spans → remote server
spans.  Spans are deduped by span id, so in-process clusters sharing
one tracer ring assemble identically to one-ring-per-process
deployments.

The smoke (``python -m opendht_tpu_torch.testing.trace_assembler
[--cpu]``: its nodes on the CUDA card unless ``--cpu``) boots a
real-UDP cluster, runs one traced put+get,
asserts the assembled tree has ≥ 3 contributing nodes with correct
parentage and monotone timestamps, round-trips the Chrome trace dump
through ``json.loads`` with the exact ``ph``/``pid``/``tid``/``ts``/
``dur`` fields Perfetto requires, and checks the ring's
bounded-memory property (10× capacity pushed → oldest evicted,
RSS-stable).

The port's copy of the JAX package's ``testing/trace_assembler.py``,
behaviour unchanged but for the smoke's device.
"""

from __future__ import annotations

import json
import sys
import time

from .. import tracing

#: tolerance for child-starts-before-parent comparisons: spans stamp
#: ``time.time()`` on different hosts/threads; within one machine the
#: clock is shared and only scheduling jitter remains
CLOCK_SLACK = 0.050


def collect_spans(nodes, trace_id) -> list:
    """Union of one trace's spans over every node's ring, deduped by
    span id.  ``nodes``: DhtRunner-likes (``get_trace``), Tracers
    (``spans``), or plain span-dict lists."""
    want = None
    seen = {}
    for n in nodes:
        if hasattr(n, "get_trace"):
            spans = n.get_trace(trace_id)
        elif hasattr(n, "spans"):
            spans = n.spans(trace_id)
        else:
            want = tracing._trace_hex(trace_id)
            spans = [s for s in n if s.get("trace_id") == want]
        for s in spans:
            seen.setdefault(s["span_id"], s)
    return list(seen.values())


def assemble_trace(nodes, trace_id) -> dict:
    """Reconstruct one trace's span tree across the cluster.

    Returns ``{"trace_id", "spans": N, "nodes": [tags], "roots":
    [tree]}`` where each tree node is the span dict plus a
    ``"children"`` list (sorted by start time).  Spans whose parent is
    not in the collected set (e.g. rotated out of a busy ring) surface
    as additional roots rather than being dropped — a postmortem tool
    must degrade, not lie."""
    spans = collect_spans(nodes, trace_id)
    by_id = {}
    for s in spans:
        t = dict(s)
        t["children"] = []
        by_id[t["span_id"]] = t
    roots = []
    for t in by_id.values():
        parent = by_id.get(t.get("parent_id") or "")
        if parent is not None:
            parent["children"].append(t)
        else:
            roots.append(t)
    for t in by_id.values():
        t["children"].sort(key=lambda c: c["start"])
    roots.sort(key=lambda c: c["start"])
    return {
        "trace_id": tracing._trace_hex(trace_id),
        "spans": len(by_id),
        "nodes": sorted({t.get("node", "") for t in by_id.values()}),
        "roots": roots,
    }


def check_tree(tree: dict) -> list:
    """Structural assertions on an assembled tree; returns a list of
    violation strings (empty = clean): every server span parents to a
    client RPC span, every RPC span parents into the op tree, and child
    start times are monotone vs their parent."""
    bad = []

    def walk(t, parent):
        if parent is not None and t["start"] < parent["start"] - CLOCK_SLACK:
            bad.append("span %s starts %.3fs before its parent %s"
                       % (t["span_id"], parent["start"] - t["start"],
                          parent["span_id"]))
        if t["kind"] == "server":
            if parent is None or not parent["name"].startswith("dht.rpc."):
                bad.append("server span %s (%s) not parented to an rpc "
                           "client span" % (t["span_id"], t["name"]))
            elif parent.get("node") == t.get("node"):
                bad.append("server span %s on the same node as its "
                           "client hop" % t["span_id"])
        if t["name"].startswith("dht.rpc.") and parent is None:
            bad.append("rpc span %s has no parent in the tree"
                       % t["span_id"])
        for c in t["children"]:
            walk(c, t)

    for r in tree["roots"]:
        walk(r, None)
    return bad


# ------------------------------------------------------------------ smoke
def _wait_connected(nodes, timeout=30.0) -> bool:
    from ..runtime.config import NodeStatus
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if all(n.get_status() is NodeStatus.CONNECTED for n in nodes):
            return True
        time.sleep(0.05)
    return False


def ring_bounded_check(factor: int = 10) -> None:
    """Push ``factor``× a small ring's capacity of fat events: the ring
    must stay at capacity, evict oldest-first, and not retain memory
    proportional to the push count (RSS-stable)."""
    import resource

    cap = 512
    tr = tracing.Tracer(capacity=cap, node="ringcheck")
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    payload = "x" * 256
    total = cap * factor
    for i in range(total):
        tr.event("flood", seq_no=i, payload=payload)
    recs = tr.records()
    assert len(recs) == cap, "ring grew past capacity: %d" % len(recs)
    oldest = min(r["attrs"]["seq_no"] for r in recs)
    assert oldest == total - cap, \
        "oldest retained is %d, expected %d" % (oldest, total - cap)
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    # ru_maxrss is KiB on linux; the retained set is ~cap*payload —
    # allow generous allocator slack while still catching O(total)
    # retention (which would be ≥ 10× the band)
    grown_kib = rss1 - rss0
    assert grown_kib < 16 * 1024, \
        "RSS grew %d KiB over a %d-event flood" % (grown_kib, total)


def main(argv=None) -> int:
    from ..infohash import InfoHash
    from ..core.value import Value
    from ..runtime.runner import DhtRunner

    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    n_nodes = 5
    tracer = tracing.get_tracer()
    nodes = []
    try:
        for i in range(n_nodes):
            n = DhtRunner()
            n.run(0, device=device)
            if nodes:
                n.bootstrap("127.0.0.1", nodes[0].get_bound_port())
            nodes.append(n)
        if not _wait_connected(nodes):
            print("trace smoke: cluster failed to connect", file=sys.stderr)
            return 1

        key = InfoHash.get("trace-smoke")
        root = tracing.TraceContext.new_root()
        with tracing.activate(root):
            assert nodes[-1].put_sync(key, Value(b"traced"), timeout=20.0)
            vals = nodes[-1].get_sync(key, timeout=20.0)
        assert vals and any(v.data == b"traced" for v in vals)

        # ---- cross-node assembly ---------------------------------------
        tree = assemble_trace(nodes, root.trace_id)
        assert tree["spans"] >= 5, \
            "expected a multi-hop tree, got %d spans" % tree["spans"]
        contributing = [n for n in tree["nodes"] if n]
        assert len(contributing) >= 3, \
            "expected >=3 nodes contributing spans, got %r" % contributing
        violations = check_tree(tree)
        assert not violations, "span-tree violations:\n  " + \
            "\n  ".join(violations)
        ops = [r["name"] for r in tree["roots"]]
        assert any(o.startswith("dht.op.") for o in ops), ops

        # ---- chrome trace round-trip -----------------------------------
        dump = tracing.to_chrome_trace(
            collect_spans(nodes, root.trace_id))
        text = json.dumps(dump)
        back = json.loads(text)
        xs = [e for e in back["traceEvents"] if e.get("ph") == "X"]
        assert xs, "no complete events in the chrome dump"
        for e in xs:
            for field in ("pid", "tid", "ts", "dur", "name"):
                assert field in e, "chrome event missing %r" % field
            assert isinstance(e["pid"], int) and isinstance(e["tid"], int)

        # ---- flight-recorder dump parses -------------------------------
        fr = nodes[0].get_flight_recorder(limit=200)
        json.loads(json.dumps(fr))
        assert fr["capacity"] == tracer.capacity

        # ---- ring bounded memory ---------------------------------------
        ring_bounded_check()

        print("trace smoke ok: %d spans over %d nodes, chrome dump "
              "%d events, ring bounded" % (tree["spans"],
                                           len(contributing), len(xs)))
        return 0
    finally:
        for n in nodes:
            n.join()


if __name__ == "__main__":
    sys.exit(main())
