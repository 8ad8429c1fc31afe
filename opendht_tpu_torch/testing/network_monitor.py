"""network_monitor: continuous end-to-end put→listen health probe.

Analog of the reference monitor (reference python/tools/
network_monitor.py:26-83): two local nodes bootstrap to the monitored
network; node1 listens on N keys, node2 puts a fresh random value on
every key each period, and the monitor reports how long the full
put→propagate→listen round trip takes.  A timeout exits non-zero so the
tool can drive alerting.

Differences from the reference: ``--rounds`` bounds the loop (0 = run
forever like the reference) and ``--local`` spins up a private two-node
network instead of joining a public bootstrap, so the tool is runnable
in sealed environments and tests.

Telemetry: every key's put→listen round trip is observed into
the ``dht_monitor_roundtrip_seconds`` histogram of the unified registry,
and each round reports the cumulative p50/p95 from that histogram — not
just the last round's wall time.  Alerting is configurable per
percentile: ``--alert p95=2.5`` (repeatable) exits non-zero as soon as
the cumulative percentile crosses the threshold, so one flag drives
pager policy off whichever tail matters.

The monitor's latency view is not
roundtrip-only — each round also folds the per-peer
``dht_peer_rtt_seconds{peer=}`` histograms the per-peer ledger
maintains (one shared instrumentation point; the monitor adds no
private wire-RTT bookkeeping) into cumulative per-hop wire
percentiles, and names the slowest link by smoothed RTT.  The
end-to-end roundtrip and the wire RTT bracket the same probe: a slow
round with fast wire RTTs is storage/propagation, a slow round with
one slow link is that link.

Usage::

    python -m opendht_tpu_torch.testing.network_monitor --local -n 4 --rounds 3
    python -m opendht_tpu_torch.testing.network_monitor -b host:port -p 60 \
        --alert p50=1.0 --alert p95=5.0
    python -m opendht_tpu_torch.testing.network_monitor --local --cpu

The port's copy of the JAX package's ``testing/network_monitor.py``,
behaviour unchanged but for the device: both probe nodes run on the
CUDA card unless ``Monitor(device="cpu")`` (``--cpu``) is given, and
without a card the monitor raises before any socket is bound.  Its keys
stay unseeded (``InfoHash.get_random``), as in JAX.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from datetime import datetime

from .. import telemetry
from .._device import resolve_device
# the --alert PCT=SEC grammar and the cumulative-percentile check are
# shared with testing/health_monitor.py and tools/dhtmon.py — one copy,
# in opendht_tpu_torch/health.py; parse_alerts stays importable from
# this module for existing callers
from ..health import parse_alerts, percentile_breaches  # noqa: F401
from ..infohash import InfoHash
from ..core.value import Value
from ..runtime.config import NodeStatus
from ..runtime.runner import DhtRunner


class Monitor:
    def __init__(self, bootstrap: "tuple[str, int] | None", num_ops: int,
                 timeout: float, device=None):
        self.timeout = timeout
        #: where both probe nodes keep their tables (None = the card)
        self.device = resolve_device(device)
        self.node1 = DhtRunner()
        self.node2 = DhtRunner()
        self.node1.run(0, device=self.device)
        self.node2.run(0, device=self.device)
        self._local = None
        if bootstrap is None:
            # private network: node1 doubles as the bootstrap
            self.node2.bootstrap("127.0.0.1", self.node1.get_bound_port())
        else:
            host, port = bootstrap
            self.node1.bootstrap(host, port)
            self.node2.bootstrap(host, port)
        self.keys = [InfoHash.get_random() for _ in range(num_ops)]
        self.pending: dict = {}          # key-hex -> (expected Value, t_put)
        self._cv = threading.Condition()
        self.rtt = telemetry.get_registry().histogram(
            "dht_monitor_roundtrip_seconds")
        for key in self.keys:
            self.node1.listen(key, self._make_cb(key))

    def _make_cb(self, key: InfoHash):
        kstr = key.hex()

        def cb(values, expired):
            if expired:
                return True
            with self._cv:
                ent = self.pending.get(kstr)
                if ent is not None and any(v.id == ent[0].id for v in values):
                    self.pending.pop(kstr, None)
                    # per-key round trip → the histogram the round
                    # report and --alert percentiles read from
                    self.rtt.observe(time.monotonic() - ent[1])
                    self._cv.notify_all()
            return True
        return cb

    def wait_connected(self, timeout: float = 30.0) -> bool:
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if (self.node1.get_status() is NodeStatus.CONNECTED
                    and self.node2.get_status() is NodeStatus.CONNECTED):
                return True
            time.sleep(0.1)
        return False

    def run_test(self) -> float:
        """One round: put a fresh value on every key, wait until every
        listener heard its value.  Returns elapsed seconds; raises
        TimeoutError on expiry (reference monitor exits 1)."""
        start = time.monotonic()
        with self._cv:
            for i, key in enumerate(self.keys):
                val = Value(InfoHash.get_random().hex().encode(),
                            value_id=int(start * 1000) * 1000 + i + 1)
                self.pending[key.hex()] = (val, time.monotonic())
                self.node2.put(key, val, lambda ok, nodes: None)
            while self.pending:
                remaining = self.timeout - (time.monotonic() - start)
                if remaining <= 0 or not self._cv.wait(timeout=remaining):
                    missing = list(self.pending)
                    self.pending.clear()
                    raise TimeoutError("no listen callback for %d keys: %s"
                                       % (len(missing), missing[:4]))
        return time.monotonic() - start

    def percentiles(self, pcts=(50, 95)) -> dict:
        """Cumulative put→listen round-trip percentiles (seconds) from
        the ``dht_monitor_roundtrip_seconds`` histogram."""
        return {p: self.rtt.quantile(p / 100.0) for p in pcts}

    def wire_percentiles(self, pcts=(50, 95)) -> dict:
        """Cumulative per-hop wire-RTT percentiles folded over EVERY
        ``dht_peer_rtt_seconds{peer=}`` histogram the per-peer
        ledger maintains (merged bucket-exactly — the same log buckets,
        one summed map) — the monitor reuses the ledger's
        instrumentation instead of keeping a wire view of its own.
        All-None when no ledger sample exists yet."""
        merged: dict = {}
        total = 0
        for m in telemetry.get_registry().series(
                "dht_peer_rtt_seconds").values():
            cnt, _s, buckets = m.raw()
            total += cnt
            for i, c in buckets.items():
                merged[i] = merged.get(i, 0) + c
        if total <= 0:
            return {p: None for p in pcts}
        items = sorted(merged.items())
        return {p: telemetry.quantile_from_buckets(items, total, p / 100.0)
                for p in pcts}

    def worst_link(self):
        """``(peer_label, srtt_seconds)`` of the slowest tracked link
        by smoothed RTT across both probe nodes' ledgers; None before
        any link has an RTT sample."""
        worst = None
        for node in (self.node1, self.node2):
            snap = node.get_peers()
            if not snap.get("enabled"):
                continue
            for pd in snap.get("peers", []):
                if pd.get("srtt") is not None and (
                        worst is None or pd["srtt"] > worst[1]):
                    worst = (pd["peer"], pd["srtt"])
        return worst

    def close(self) -> None:
        self.node1.join()
        self.node2.join()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="monitor a DHT network with periodic put->listen probes")
    p.add_argument("-b", "--bootstrap",
                   help="bootstrap address host:port (default: private net)")
    p.add_argument("-n", "--num-ops", type=int, default=8,
                   help="concurrent keys probed per round")
    p.add_argument("-p", "--period", type=float, default=60.0,
                   help="seconds between rounds")
    p.add_argument("-t", "--timeout", type=float, default=15.0,
                   help="per-round timeout")
    p.add_argument("--rounds", type=int, default=0,
                   help="stop after N rounds (0 = forever)")
    p.add_argument("--local", action="store_true",
                   help="run against a private 2-node network")
    p.add_argument("--alert", action="append", default=[], metavar="PCT=SEC",
                   help="exit non-zero when the cumulative round-trip "
                        "percentile exceeds SEC (e.g. --alert p95=2.5; "
                        "repeatable, one threshold per percentile)")
    p.add_argument("--cpu", action="store_true",
                   help="run the probe nodes' tables on the host (default: "
                        "the CUDA card, and no card is an error)")
    args = p.parse_args(argv)
    try:
        alerts = parse_alerts(args.alert)
    except ValueError as e:
        print("network_monitor:", e, file=sys.stderr)
        return 2

    bootstrap = None
    if args.bootstrap and not args.local:
        host, _, port = args.bootstrap.partition(":")
        bootstrap = (host, int(port or 4222))

    mon = Monitor(bootstrap, args.num_ops, args.timeout,
                  device="cpu" if args.cpu else None)
    try:
        if not mon.wait_connected():
            print("monitor: nodes failed to connect", file=sys.stderr)
            return 1
        next_test = time.monotonic()
        done_rounds = 0
        while args.rounds == 0 or done_rounds < args.rounds:
            try:
                dt = mon.run_test()
            except TimeoutError as e:
                print("Test timeout !", e, file=sys.stderr)
                return 1
            pcts = mon.percentiles(tuple(sorted({50, 95, *alerts})))
            print(datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
                  "Test completed successfully in", round(dt, 3),
                  "| round-trip " + " ".join(
                      "p%g=%.3fs" % (p, v) for p, v in sorted(pcts.items())))
            wire = mon.wire_percentiles()
            if any(v is not None for v in wire.values()):
                wl = mon.worst_link()
                print("  wire RTT " + " ".join(
                    "p%g=%.3fs" % (p, v)
                    for p, v in sorted(wire.items()) if v is not None)
                    + (" | slowest link %s srtt=%.3fs" % wl
                       if wl is not None else ""))
            breaches = percentile_breaches(
                lambda q: mon.rtt.quantile(q), alerts)
            if breaches:
                for pct, v, thr in breaches:
                    print("ALERT: round-trip p%g %.3fs exceeds %.3fs"
                          % (pct, v, thr), file=sys.stderr)
                return 1
            done_rounds += 1
            if args.rounds and done_rounds >= args.rounds:
                break
            next_test += args.period
            now = time.monotonic()
            if next_test > now:
                time.sleep(next_test - now)
    finally:
        mon.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
