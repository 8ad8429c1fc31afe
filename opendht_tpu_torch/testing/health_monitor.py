"""Cluster health aggregator, the cluster half of the health plane.

The node side (opendht_tpu_torch/health.py) rolls each node's signals into a
verdict; this module answers the *cluster*-level questions the paper's
invariants pose (PAPER.md layer map; ROADMAP item 4's measurement
half):

- **Scrape**: every node's ``GET /healthz`` verdict and ``GET /stats``
  Prometheus exposition (:func:`scrape_node`), summed into cluster
  series (:func:`merge_series`).
- **Global lookup success rate** (:func:`lookup_success`): cluster-wide
  ``dht_ops_total{op="get",ok=}`` ratio — the "lookups succeed"
  invariant.
- **Cluster op-latency percentiles** (:func:`cluster_quantile`): the
  per-op ``dht_op_seconds_bucket`` series merged across nodes and
  interpolated with the same log-bucket math the node histograms use
  (health.quantile_from_cumulative) — drives the shared
  ``--alert PCT=SEC`` grammar.
- **Batched replica-coverage probe** (:func:`replica_coverage`): the
  paper invariant "a value lives on the 8 XOR-closest nodes", checked
  directly: sample stored keys across the cluster, resolve the TRUE
  closest-8 for the whole sample in ONE
  ``NodeTable.find_closest`` launch over a census table of the live
  node ids (the batched resolve — more than 64 keys take the device
  snapshot and its ``window_select`` kernel; pass ``mesh=`` to ride the
  t-sharded table), then cross-check which of those nodes
  actually hold each value.  K sampled keys cost one lane-padded
  launch, not K — pinned equal to the per-key scalar loop in
  tests/test_health.py.

``tools/dhtmon.py`` is the CLI over these helpers (exit-code
thresholds for CI and soak).

The port's copy of the JAX package's ``testing/health_monitor.py``,
behaviour unchanged.  The device is explicit: the census table, and so
the probe's resolve, lives on ``device`` (None = the CUDA card, raising
when there is none; tests pass ``device="cpu"``).
"""

from __future__ import annotations

import json
import random
import re
import time
import urllib.error
import urllib.request
from typing import Dict, Iterable, List, Optional, Tuple

from .._device import resolve_device
from ..health import quantile_from_cumulative
from ..infohash import InfoHash
from ..sockaddr import SockAddr

#: ``dht_op_seconds_bucket{op="get",le="0.25"}`` → (op, le)
_BUCKET_RE = re.compile(
    r'^dht_op_seconds_bucket\{le="([^"]+)",op="([^"]+)"\}$'
    r'|^dht_op_seconds_bucket\{op="([^"]+)",le="([^"]+)"\}$')


# ================================================================ scraping
def scrape_node(endpoint: str, timeout: float = 10.0) -> dict:
    """One node's health + stats off its proxy: ``{"endpoint",
    "ready", "verdict", "health", "series"}``.  ``endpoint`` is
    ``host:port`` of the node's REST proxy."""
    base = "http://" + endpoint.rstrip("/")
    req = urllib.request.Request(base + "/healthz")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            hz = json.loads(r.read().decode())
            code = r.status
    except urllib.error.HTTPError as e:       # 503 carries the body too
        hz = json.loads(e.read().decode() or "{}")
        code = e.code
    with urllib.request.urlopen(base + "/stats", timeout=timeout) as r:
        text = r.read().decode()
    from .telemetry_smoke import parse_exposition
    return {
        "endpoint": endpoint,
        "ready": code == 200,
        "verdict": hz.get("verdict", "unknown"),
        "health": hz.get("health", {}),
        "series": parse_exposition(text),
    }


def scrape_history(endpoint: str, since: float,
                   timeout: float = 10.0) -> Optional[dict]:
    """One node's ``GET /history?since=SEC`` document, with
    the LOCAL wall clock stamped as ``scraped_at`` so the timeline
    assembler can estimate skew.  ``None`` when the node does not
    export history (route missing, scrape error, or recorder disabled)
    — the caller's signal to fall back to scrape-diff-scrape."""
    base = "http://" + endpoint.rstrip("/")
    try:
        with urllib.request.urlopen(
                base + "/history?since=%g" % since, timeout=timeout) as r:
            doc = json.loads(r.read().decode())
    except Exception:
        return None
    if not isinstance(doc, dict) or not doc.get("enabled"):
        return None
    doc["endpoint"] = endpoint
    doc["scraped_at"] = time.time()
    return doc


def merge_history_series(histories: Iterable[dict]) -> Dict[str, float]:
    """Sum every node's history frames into ONE windowed series map of
    the exact shape :func:`merge_series` builds from ``GET /stats``
    scrapes — so :func:`lookup_success` / :func:`cluster_quantile`
    evaluate windowed invariants over history through the same code
    path as the scrape-diff mode (one delta codepath)."""
    from ..history import frames_to_series
    out: Dict[str, float] = {}
    for h in histories:
        for k, v in frames_to_series(h.get("frames") or []).items():
            out[k] = out.get(k, 0.0) + v
    return out


def merge_series(scrapes: Iterable[dict]) -> Dict[str, float]:
    """Sum every Prometheus series across node scrapes (counters and
    cumulative buckets sum; the cluster invariants below only read
    summed series)."""
    out: Dict[str, float] = {}
    for sc in scrapes:
        for k, v in sc["series"].items():
            out[k] = out.get(k, 0.0) + v
    return out


# ===================================================== cluster invariants
def lookup_success(series: Dict[str, float],
                   op: str = "get") -> Optional[Tuple[float, float]]:
    """Cluster-wide op success ratio from the summed
    ``dht_ops_total{op=,ok=}`` counters: ``(ratio, total_ops)``; None
    with zero traffic (unknown is not a violation)."""
    ok = series.get('dht_ops_total{ok="true",op="%s"}' % op, 0.0)
    bad = series.get('dht_ops_total{ok="false",op="%s"}' % op, 0.0)
    total = ok + bad
    if total <= 0:
        return None
    return ok / total, total


def op_latency_buckets(series: Dict[str, float]
                       ) -> Dict[str, List[Tuple[float, float]]]:
    """Per-op cumulative ``(le, count)`` pairs from the summed
    ``dht_op_seconds_bucket`` series (the +Inf bucket dropped — the
    finite edges carry the distribution)."""
    out: Dict[str, list] = {}
    for name, v in series.items():
        m = _BUCKET_RE.match(name)
        if not m:
            continue
        le_s, op = (m.group(1), m.group(2)) if m.group(1) is not None \
            else (m.group(4), m.group(3))
        if le_s == "+Inf":
            continue
        out.setdefault(op, []).append((float(le_s), v))
    return {op: sorted(pairs) for op, pairs in out.items()}


def cluster_quantile(series: Dict[str, float], op: str,
                     q: float) -> Optional[float]:
    """Cluster-merged latency quantile of one op family; None without
    data."""
    pairs = op_latency_buckets(series).get(op)
    return quantile_from_cumulative(pairs, q) if pairs else None


# ================================================= replica-coverage probe
def census_table(nodes: List[Tuple[InfoHash, Optional[SockAddr]]],
                 now: float, device=None):
    """A :class:`~opendht_tpu_torch.core.table.NodeTable` on ``device``
    (None = the CUDA card) holding every live
    cluster node as a confirmed, reachable peer — the ground-truth
    membership the closest-8 invariant is defined over (the observer
    id is random, so no cluster node is excluded as "self").  Bucket
    admission is widened to the census size: a routing table may
    legitimately cache-and-drop far peers, a census must not."""
    from ..core.table import NodeTable
    nodes = list(nodes)
    t = NodeTable(InfoHash.get_random(), k=max(8, len(nodes)),
                  device=device)
    for nid, addr in nodes:
        t.insert(nid, addr if addr is not None
                 else SockAddr("127.0.0.1", 1), now, confirm=2)
    return t


def closest_ids(table, keys: List[InfoHash], k: int = 8, mesh=None,
                now: Optional[float] = None,
                device=None) -> List[List[InfoHash]]:
    """TRUE closest-``k`` node ids for MANY keys from ONE batched
    ``find_closest`` resolve (``mesh`` row-shards the resolve over
    ``t`` devices).  The scalar oracle — one ``find_closest`` per key —
    is pinned equal in tests/test_health.py.

    ``device`` is where the resolve must run (None = the CUDA card): a
    census ``table`` placed elsewhere raises ValueError rather than
    resolve on another device than the caller asked for."""
    want = resolve_device(device)
    if table.device.type != want.type or (
            want.index is not None and table.device.index is not None
            and table.device.index != want.index):
        raise ValueError("closest_ids: the census table is on %s, not "
                         "on the requested %s" % (table.device, want))
    if not keys:
        return []
    if now is None:
        now = time.monotonic()
    rows, _dist = table.find_closest(list(keys), k=k, now=now, mesh=mesh)
    ids = table.ids_of_rows(rows)
    k_out = rows.shape[1]
    return [[ids[qi * k_out + j] for j in range(k_out)
             if rows[qi, j] >= 0]
            for qi in range(rows.shape[0])]


def stored_keys(runners) -> Dict[InfoHash, set]:
    """``key -> {node-id hex}`` of every non-empty storage across the
    cluster's runners (in-process probe surface)."""
    held: Dict[InfoHash, set] = {}
    for r in runners:
        nid = str(r.get_node_id())
        for key, st in r._dht.store.items():
            if not st.empty():
                held.setdefault(key, set()).add(nid)
    return held


def replica_coverage(runners, sample_max: int = 64, k: int = 8,
                     mesh=None, seed: int = 0, device=None) -> dict:
    """The batched replica-coverage probe over an in-process cluster:
    sample up to ``sample_max`` stored keys, resolve every key's true
    closest-``k`` in ONE device launch on ``device`` (None = the CUDA
    card), and report what fraction of those expected replicas actually
    hold the value."""
    now = time.monotonic()
    held = stored_keys(runners)
    keys = sorted(held, key=bytes)
    if len(keys) > sample_max:
        random.Random(seed).shuffle(keys)
        keys = sorted(keys[:sample_max], key=bytes)
    nodes = [(r.get_node_id(),
              SockAddr("127.0.0.1", r.get_bound_port() or 1))
             for r in runners]
    table = census_table(nodes, now, device=device)
    per_key = []
    for key, closest in zip(keys, closest_ids(table, keys, k=k,
                                              mesh=mesh, now=now,
                                              device=device)):
        want = [str(nid) for nid in closest]
        have = sum(1 for w in want if w in held[key])
        per_key.append({
            "key": key.hex(),
            "expected": len(want),
            "held": have,
            "coverage": (have / len(want)) if want else 1.0,
        })
    covs = [p["coverage"] for p in per_key]
    return {
        "keys": len(per_key),
        "nodes": len(runners),
        "k": k,
        "sampled_of": len(held),
        "mean_coverage": (sum(covs) / len(covs)) if covs else None,
        "min_coverage": min(covs) if covs else None,
        "per_key": per_key,
    }
