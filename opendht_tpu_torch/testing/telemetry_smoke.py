"""End-to-end telemetry smoke.

Boots a small real-UDP cluster, runs puts/gets/listens, then scrapes the
telemetry surface both ways — ``DhtRunner.get_metrics()`` (JSON) and the
proxy's ``GET /stats`` (Prometheus text exposition) — and asserts that
(1) the exposition parses line-by-line against the v0.0.4 grammar,
(2) the counters the exercised paths must advance actually advanced, and
(3) the two exports describe the same registry.

Run directly::

    python -m opendht_tpu_torch.testing.telemetry_smoke [--cpu]

Its nodes run on the CUDA card unless ``--cpu`` is given; without a card
(and without ``--cpu``) it raises before any socket is bound.

The port's copy of the JAX package's ``testing/telemetry_smoke.py``,
behaviour unchanged but for the nodes' device.
"""

from __future__ import annotations

import json
import re
import sys
import time
import urllib.request

from .._device import resolve_device
from ..infohash import InfoHash
from ..core.value import Value
from ..runtime.config import NodeStatus
from ..runtime.runner import DhtRunner

# one line of text exposition: comment/TYPE, or `name{labels} value`
_LINE_RE = re.compile(
    r"^(#.*|[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(\\.|[^\"\\])*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(\\.|[^\"\\])*\")*\})?"
    r" [-+]?([0-9.eE+-]+|[0-9]+|\+Inf|NaN))$")


def parse_exposition(text: str) -> dict:
    """Validate every line and return {series: float}; raises on any
    line the v0.0.4 grammar rejects."""
    out = {}
    for ln in text.splitlines():
        if not ln.strip():
            continue
        if not _LINE_RE.match(ln):
            raise ValueError("bad exposition line: %r" % ln)
        if ln.startswith("#"):
            continue
        series, val = ln.rsplit(" ", 1)
        out[series] = float(val)
    return out


def _wait_connected(nodes, timeout=30.0) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if all(n.get_status() is NodeStatus.CONNECTED for n in nodes):
            return True
        time.sleep(0.05)
    return False


def main(argv=None) -> int:
    from ..proxy import DhtProxyServer

    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    resolve_device(device)        # no card and no --cpu: raise here
    n_ops = 4
    node1, node2 = DhtRunner(), DhtRunner()
    proxy = None
    try:
        node1.run(0, device=device)
        node2.run(0, device=device)
        node2.bootstrap("127.0.0.1", node1.get_bound_port())
        if not _wait_connected([node1, node2]):
            print("telemetry_smoke: cluster failed to connect",
                  file=sys.stderr)
            return 1

        keys = [InfoHash.get("telemetry-smoke-%d" % i) for i in range(n_ops)]
        for i, key in enumerate(keys):
            assert node2.put_sync(key, Value(b"v%d" % i), timeout=15.0)
        got = 0
        for key in keys:
            got += len(node1.get_sync(key, timeout=15.0))
        assert got >= n_ops, "expected >= %d values, got %d" % (n_ops, got)

        # ---- JSON surface -------------------------------------------------
        snap = node2.get_metrics()
        json.dumps(snap)                      # must be JSON-able
        counters = snap["counters"]

        def counter_sum(prefix: str) -> float:
            return sum(v for k, v in counters.items()
                       if k == prefix or k.startswith(prefix + "{"))

        expect_advanced = [
            'dht_ops_total{ok="true",op="put"}',
            'dht_ops_total{ok="true",op="get"}',
            'dht_net_requests_sent_total{type="put"}',
            'dht_net_requests_sent_total{type="get"}',
            'dht_net_requests_completed_total{type="put"}',
        ]
        for series in expect_advanced:
            assert counters.get(series, 0) > 0, \
                "counter %s did not advance: %r" % (
                    series, sorted(counters)[:40])
        assert counter_sum("dht_net_messages_total") > 0
        hists = snap["histograms"]
        assert any(k.startswith("dht_op_seconds") for k in hists)
        assert any(k.startswith("dht_net_rtt_seconds") for k in hists)
        # routing gauges refreshed by get_metrics (the old stats island)
        assert any(k.startswith("dht_routing_good{")
                   for k in snap["gauges"])

        # ---- Prometheus surface -------------------------------------------
        proxy = DhtProxyServer(node1, 0)
        with urllib.request.urlopen(
                "http://127.0.0.1:%d/stats" % proxy.port, timeout=10) as r:
            ctype = r.headers.get("Content-Type", "")
            text = r.read().decode()
        assert "text/plain" in ctype, ctype
        series = parse_exposition(text)
        for s in expect_advanced:
            assert series.get(s, 0) > 0, "scrape missing %s" % s
        assert series.get("dht_proxy_requests_total", 0) >= 1
        # same registry both ways: every JSON counter appears in the
        # scrape with a value at least as recent (counters only grow)
        for k, v in counters.items():
            assert k in series, "JSON counter %s missing from /stats" % k
            assert series[k] >= v, (k, series[k], v)
        print("telemetry smoke ok: %d exposition series, "
              "%d counters advanced" % (len(series), len(expect_advanced)))
        return 0
    finally:
        if proxy is not None:
            proxy.stop()
        node1.join()
        node2.join()


if __name__ == "__main__":
    sys.exit(main())
