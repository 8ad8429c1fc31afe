"""scanner: adaptive keyspace crawl with node-ring + geo summaries.

Analog of the reference crawler (reference python/tools/
scanner.py:118-166): starting from prefix 0 at depth 0, every completed
``get`` reply drives the descent — the crawl splits deeper wherever
replies show more shared prefix bits (``commonBits(first, last) + 6``,
capped at depth 8), so dense keyspace regions get proportionally more
probes.  Discovered nodes accumulate in a NodeSet; per-IP aggregation,
unit-circle ring coordinates (id → angle, scanner.py:180-184) and a
geo summary are reported at the end.

The reference resolves locations by downloading MaxMind GeoIP databases
and plots live matplotlib/Basemap maps; this environment has no egress,
so geolocation is a pluggable resolver (default: an offline classifier
that labels loopback/private/global per RFC 6890) and the "map" is a
JSON summary on stdout.  Pass a real resolver callable for actual
GeoIP lookups.

Usage::

    python -m opendht_tpu_torch.testing.scanner -b 127.0.0.1:4222
    python -m opendht_tpu_torch.testing.scanner --local 8   # self-made network
    python -m opendht_tpu_torch.testing.scanner --local 8 --cpu

The port's copy of the JAX package's ``testing/scanner.py``, behaviour
unchanged but for the device: the CLI's nodes run on the CUDA card
unless ``--cpu`` is given, and without a card (and without ``--cpu``)
it raises before any socket is bound.  :class:`Scanner` crawls from
whatever runner it is given.
"""

from __future__ import annotations

import argparse
import ipaddress
import json
import math
import sys
import threading
import time

from .._device import resolve_device
from ..infohash import InfoHash
from ..nodeset import NodeSet
from ..runtime.config import NodeStatus
from ..runtime.runner import DhtRunner

MAX_DEPTH = 8                    # scanner.py:143


def offline_geo(ip: str) -> dict:
    """Offline stand-in for the GeoIP record: RFC 6890 class labels."""
    try:
        a = ipaddress.ip_address(ip)
    except ValueError:
        return {"class": "invalid"}
    if a.is_loopback:
        cls = "loopback"
    elif a.is_private:
        cls = "private"
    elif a.is_multicast:
        cls = "multicast"
    else:
        cls = "global"
    return {"class": cls, "v": a.version}


class Scanner:
    """Concurrent adaptive crawl of the full keyspace
    (scanner.py:118-150: step / stepdone / nextstep)."""

    def __init__(self, node: DhtRunner, geo=offline_geo,
                 max_depth: int = MAX_DEPTH):
        self.node = node
        self.geo = geo
        self.max_depth = max_depth
        self.all_nodes = NodeSet()
        self.ip4s: dict = {}
        self.ip6s: dict = {}
        self.probes = 0
        self._inflight = 0
        self._cv = threading.Condition()

    def scan(self, timeout: float = 120.0) -> None:
        # start from 00..01, not the zero hash: peers reject a get for a
        # null infohash (GET_NO_INFOHASH, src/dht.cpp:2140) — the
        # reference seeds the same way (scanner.py:277-279 setBit(159,1))
        with self._cv:
            self._step(InfoHash.zero().set_bit(159, True), 0)
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=min(remaining, 0.5))

    # ------------------------------------------------------------- crawl
    def _step(self, cur_h: InfoHash, cur_depth: int) -> None:
        """Probe one keyspace arc; replies may split it deeper
        (scanner.py:118-128)."""
        self._inflight += 1
        self.probes += 1
        self.node.get(cur_h, lambda values: True,
                      lambda ok, nodes: self._step_done(cur_h, cur_depth,
                                                        ok, nodes))

    def _step_done(self, cur_h, cur_depth, ok, nodes) -> None:
        with self._cv:
            try:
                if nodes:
                    self._append_nodes(nodes)
                    common = 0
                    if len(nodes) > 1:
                        # (id, node) pairs: the JAX copy hands NodeSet the
                        # Node objects, whose TypeError ends its crawl
                        # after one probe (ROADMAP C.3)
                        s = NodeSet()
                        s.extend((getattr(n, "id", n), n) for n in nodes)
                        common = InfoHash.common_bits(s.first(), s.last())
                    depth = min(self.max_depth, common + 6)
                    # split the remaining arc one level per gained bit
                    # (scanner.py:139-148)
                    if cur_depth < depth:
                        for b in range(cur_depth, depth):
                            new_h = cur_h.set_bit(b, True)
                            self._step(new_h, b + 1)
            finally:
                self._inflight -= 1
                self._cv.notify_all()

    # ----------------------------------------------------------- harvest
    def _append_nodes(self, nodes) -> None:
        for n in nodes:
            nid = getattr(n, "id", n)
            if self.all_nodes.insert((nid, n)):
                addr = getattr(n, "addr", None)
                ip = getattr(addr, "host", "") or ""
                bucket = self.ip6s if ":" in ip else self.ip4s
                if ip in bucket:
                    bucket[ip]["nodes"] += 1
                else:
                    bucket[ip] = {"nodes": 1, "geo": self.geo(ip)}

    # ----------------------------------------------------------- reports
    def ring_points(self) -> list:
        """Unit-circle coordinates of every node id
        (scanner.py:180-184: angle = 2π · id.toFloat())."""
        pts = []
        for entry in self.all_nodes:
            a = 2.0 * math.pi * entry.get_id().to_float()
            pts.append({"id": entry.get_id().hex()[:16],
                        "x": math.cos(a), "y": math.sin(a)})
        return pts

    def summary(self) -> dict:
        geo_counts: dict = {}
        for bucket in (self.ip4s, self.ip6s):
            for rec in bucket.values():
                cls = rec["geo"].get("class", "unknown")
                geo_counts[cls] = geo_counts.get(cls, 0) + 1
        return {
            "probes": self.probes,
            "nodes": len(self.all_nodes),
            "ip4s": len(self.ip4s),
            "ip6s": len(self.ip6s),
            "geo": geo_counts,
            "ring": self.ring_points(),
        }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="crawl a DHT network and summarize nodes/locations")
    p.add_argument("-b", "--bootstrap",
                   help="bootstrap address host:port")
    p.add_argument("--local", type=int, default=0, metavar="N",
                   help="spin up a private N-node network and scan it")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--max-depth", type=int, default=MAX_DEPTH)
    p.add_argument("--cpu", action="store_true",
                   help="run the nodes' tables on the host (default: the "
                        "CUDA card, and no card is an error)")
    args = p.parse_args(argv)

    # the card unless --cpu; resolved before any socket is bound
    device = "cpu" if args.cpu else None
    resolve_device(device)
    cluster = None
    scanner_node = DhtRunner()
    scanner_node.run(0, device=device)
    try:
        if args.local:
            from .dhtcluster import NodeCluster
            cluster = NodeCluster(device=device)
            cluster.resize(args.local)
            scanner_node.bootstrap("127.0.0.1",
                                   cluster.front().get_bound_port())
        elif args.bootstrap:
            host, _, port = args.bootstrap.partition(":")
            scanner_node.bootstrap(host, int(port or 4222))
        else:
            p.error("need -b or --local")

        t0 = time.monotonic()
        while (scanner_node.get_status() is not NodeStatus.CONNECTED
               and time.monotonic() - t0 < 30.0):
            time.sleep(0.1)

        sc = Scanner(scanner_node, max_depth=args.max_depth)
        sc.scan(timeout=args.timeout)
        print(json.dumps(sc.summary()))
    finally:
        scanner_node.join()
        if cluster is not None:
            cluster.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
