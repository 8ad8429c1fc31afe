"""Cluster timeline assembly over per-node metrics histories.

The trace assembler stitches ONE operation's span tree across
the cluster; this module stitches the cluster's METRICS TIMELINE: every
node's flight-data-recorder frames (opendht_tpu_torch/history.py) merged into
one time-ordered sequence, so a soak harness or post-mortem can answer
"what was the whole cluster doing between t0 and t1" — the windowed
view ``dhtmon --since`` gates on instead of scrape-diff-scrape.

Sources accepted by :func:`assemble_timeline` (mirroring the trace
assembler's duck-typing):

- a ``GET /history`` document (``testing/health_monitor.scrape_history``
  stamps ``scraped_at`` so skew is estimable),
- a post-mortem black-box bundle (``history.BUNDLE_KIND``; its flight
  events — ``health_transition``, ``slo_violation``, ... — join the
  timeline alongside the frames),
- a ``DhtRunner``-like (``get_history()``), a raw
  :class:`~opendht_tpu_torch.history.MetricsHistory`, or a plain frame list.

**Skew**: each scrape document carries the serving node's wall clock
(``time``) next to the scraper's (``scraped_at``); their difference
estimates that node's clock offset and every frame/event timestamp is
shifted by it before merging (same-host clusters estimate ~0).
**Monotonicity** is checked per node like the trace assembler's
span-tree check:
frame ``seq``/``t`` must be non-decreasing within one node's history —
violations are REPORTED, not dropped (a post-mortem tool must degrade,
not lie).

:func:`window_series` reduces a timeline window back to the summed
``{series: value}`` shape the dhtmon invariants read — the same
one-delta-codepath contract as ``history.frames_to_series``.

The port's copy of the JAX package's ``testing/timeline_assembler.py``,
behaviour unchanged, over the port's ``history`` module.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..history import BUNDLE_KIND, frames_to_series

#: tolerance for per-node timestamp monotonicity: frames stamp
#: ``time.time()`` once per tick, so only scheduling jitter remains
#: (the trace assembler's CLOCK_SLACK, relaxed to the tick cadence)
CLOCK_SLACK = 0.050


def _extract(source) -> dict:
    """Normalize one source into ``{"node", "frames", "events",
    "skew"}``."""
    if isinstance(source, dict):
        if source.get("kind") == BUNDLE_KIND:
            hist = source.get("history") or {}
            return {
                "node": source.get("node_id", ""),
                "frames": list(hist.get("frames") or []),
                "events": list((source.get("flight_recorder") or {})
                               .get("events") or []),
                "skew": _skew(source),
            }
        # a GET /history document (or anything frame-shaped)
        return {
            "node": source.get("node_id", source.get("endpoint", "")),
            "frames": list(source.get("frames") or []),
            "events": [],
            "skew": _skew(source),
        }
    if hasattr(source, "get_history"):            # DhtRunner-like
        return _extract(source.get_history())
    if hasattr(source, "frames"):                 # MetricsHistory
        return {"node": getattr(source, "node", ""),
                "frames": source.frames(), "events": [], "skew": 0.0}
    return {"node": "", "frames": list(source), "events": [],
            "skew": 0.0}                          # raw frame list


def _skew(doc: dict) -> float:
    """Serving-node wall clock minus scraper wall clock at scrape time
    — 0.0 when either stamp is missing (in-process sources share the
    clock)."""
    t = doc.get("time")
    at = doc.get("scraped_at")
    if t is None or at is None:
        return 0.0
    return float(t) - float(at)


def assemble_timeline(sources) -> dict:
    """Merge every source's frames (and bundle flight events) into one
    skew-adjusted, time-ordered cluster timeline.

    Returns ``{"nodes", "frames", "events", "skew", "violations",
    "span"}`` — frames/events each gain ``"node"`` and an adjusted
    ``"t_adj"`` (original timestamps untouched); ``violations`` lists
    per-node monotonicity breaks (non-decreasing ``seq``/``t``, the
    trace assembler's contract); ``span`` is the adjusted
    ``[t_min, t_max]`` the timeline covers (None when empty)."""
    nodes: List[str] = []
    frames: List[dict] = []
    events: List[dict] = []
    skews: Dict[str, float] = {}
    violations: List[str] = []
    for si, source in enumerate(sources):
        ex = _extract(source)
        node = ex["node"] or ("source-%d" % si)
        nodes.append(node)
        skews[node] = ex["skew"]
        prev_seq: Optional[int] = None
        prev_t: Optional[float] = None
        for f in ex["frames"]:
            seq = f.get("seq")
            t = f.get("t", 0.0)
            if prev_seq is not None and seq is not None \
                    and seq <= prev_seq:
                violations.append(
                    "node %s: frame seq %s not after %s"
                    % (node, seq, prev_seq))
            if prev_t is not None and t < prev_t - CLOCK_SLACK:
                violations.append(
                    "node %s: frame at %.3f is %.3fs before its "
                    "predecessor" % (node, t, prev_t - t))
            prev_seq = seq if seq is not None else prev_seq
            prev_t = max(prev_t, t) if prev_t is not None else t
            g = dict(f)
            g["node"] = node
            g["t_adj"] = t - ex["skew"]
            frames.append(g)
        for e in ex["events"]:
            g = dict(e)
            g["node"] = g.get("node") or node
            g["t_adj"] = e.get("t", 0.0) - ex["skew"]
            events.append(g)
    frames.sort(key=lambda f: f["t_adj"])
    events.sort(key=lambda e: e["t_adj"])
    ts = [f["t_adj"] for f in frames] + [e["t_adj"] for e in events]
    return {
        "nodes": nodes,
        "frames": frames,
        "events": events,
        "skew": skews,
        "violations": violations,
        "span": [min(ts), max(ts)] if ts else None,
    }


def window_series(timeline: dict, t0: Optional[float] = None,
                  t1: Optional[float] = None) -> Dict[str, float]:
    """Summed ``{series: value}`` over the timeline's frames with
    adjusted time in ``(t0, t1]`` — the exact map
    ``testing/health_monitor.lookup_success`` / ``cluster_quantile``
    read, so cluster invariants evaluate over an assembled timeline
    through the same code path dhtmon uses."""
    frames = [f for f in timeline["frames"]
              if (t0 is None or f["t_adj"] > t0)
              and (t1 is None or f["t_adj"] <= t1)]
    return frames_to_series(frames)


def find_events(timeline: dict, name: str) -> List[dict]:
    """Timeline events whose name contains ``name`` (the flight
    recorder's substring convention) — e.g.
    ``find_events(tl, "health_transition")`` locates every verdict
    change across the cluster, in time order."""
    return [e for e in timeline["events"] if name in e.get("ev", "")]
