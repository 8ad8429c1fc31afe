"""Scenario suites over the virtual network
(↔ reference python/tools/dht/tests.py).

- :class:`PerformanceTest` — repeated random-hash ``get`` rounds with
  latency statistics and optional cluster replacement between rounds
  (↔ PerformanceTest._getsTimesTest, tests.py:866-948), and the
  node-kill *delete* test (↔ _delete, tests.py:951-995).
- :class:`PersistenceTest` — value survival under churn with
  ``maintain_storage`` republication (↔ PersistenceTest
  delete/replace/mult_time, tests.py:440-829).

All scenarios run on :class:`VirtualNet`'s virtual clock, so hours of
protocol time (republish sweeps, expiry) cost milliseconds, and results
are deterministic per seed.

The port's copy of the JAX package's ``testing/scenarios.py``, behaviour
unchanged, over the port's ``VirtualNet``: :func:`build_net`'s
``device`` places every node's tables (None = the CUDA card).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import List, Optional

from ..core.value import Value
from ..infohash import InfoHash
from ..runtime.config import Config
from .virtual_net import VirtualNet


@dataclass
class LatencyStats:
    """sum/mean/std/min/max like the reference prints
    (dht/tests.py:930-948)."""
    samples: List[float] = field(default_factory=list)

    def add(self, dt: float) -> None:
        self.samples.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    @property
    def std(self) -> float:
        if len(self.samples) < 2:
            return 0.0
        m = self.mean
        return math.sqrt(sum((x - m) ** 2 for x in self.samples)
                         / (len(self.samples) - 1))

    def summary(self) -> dict:
        s = self.samples
        return {"count": len(s), "sum": sum(s), "mean": self.mean,
                "std": self.std, "min": min(s) if s else 0.0,
                "max": max(s) if s else 0.0}


def build_net(num_nodes: int, *, delay: float = 0.005, loss: float = 0.0,
              seed: int = 42, config: Optional[Config] = None,
              settle: float = 20.0, device=None) -> VirtualNet:
    """Spin up a connected N-node virtual network on ``device`` (None =
    the CUDA card)."""
    net = VirtualNet(delay=delay, loss=loss, seed=seed, device=device)
    nodes = [net.add_node(config) for _ in range(num_nodes)]
    net.bootstrap_all(nodes[0])
    net.run(max_time=settle, until=net.all_connected)
    return net


class PerformanceTest:
    """(↔ PerformanceTest, dht/tests.py:831-995)"""

    def __init__(self, net: VirtualNet, *, seed: int = 7):
        self.net = net
        self.rng = random.Random(seed)

    def gets_times(self, rounds: int = 10, gets_per_round: int = 50,
                   replace: int = 0, config: Optional[Config] = None
                   ) -> LatencyStats:
        """`gets_per_round` random-hash gets per round × `rounds`,
        measured in *virtual* seconds; optionally replace `replace`
        nodes between rounds (↔ _getsTimesTest, tests.py:866-948)."""
        stats = LatencyStats()
        nodes = list(self.net.nodes.values())
        seed_node = nodes[0]
        for _ in range(rounds):
            for _ in range(gets_per_round):
                src = self.rng.choice(list(self.net.nodes.values()))
                target = InfoHash.get_random()
                done = []
                t0 = self.net.clock
                src.get(target, lambda vs: True,
                        lambda ok, ns: done.append(ok))
                self.net.run(max_time=30.0, until=lambda: bool(done))
                stats.add(self.net.clock - t0)
            if replace:
                self.net.replace_cluster(replace, seed_node, config)
                self.net.run(max_time=20.0, until=self.net.all_connected)
        return stats

    def delete_test(self, *, payload: bytes = b"perf-delete"
                    ) -> "tuple[bool, int]":
        """Kill every node hosting a value at once, then check whether
        the network still serves it (↔ _delete, tests.py:951-995).
        Returns (survived, holders_killed)."""
        key = InfoHash.get("delete-test-key")
        nodes = list(self.net.nodes.values())
        done = []
        nodes[-1].put(key, Value(payload), lambda ok, ns: done.append(ok))
        self.net.run(max_time=30.0, until=lambda: bool(done))
        holders = self.net.storers_of(key)
        for h in holders:
            self.net.remove_node(h)
        alive = [d for d in self.net.nodes.values()]
        if not alive:
            return False, len(holders)
        got: List[Value] = []
        fin = []
        alive[0].get(key, lambda vs: got.extend(vs) or True,
                     lambda ok, ns: fin.append(ok))
        self.net.run(max_time=30.0, until=lambda: bool(fin))
        return any(v.data == payload for v in got), len(holders)


class PersistenceTest:
    """Value survival under churn (↔ PersistenceTest,
    dht/tests.py:440-829).  Requires nodes built with
    ``Config(maintain_storage=True)`` for republication."""

    def __init__(self, net: VirtualNet, *, seed: int = 11):
        self.net = net
        self.rng = random.Random(seed)

    def churn_survival(self, *, kills: int = 4, between: float = 700.0,
                       payload: bytes = b"persist-me",
                       config: Optional[Config] = None) -> bool:
        """Permanent-put a value, then kill one holder at a time with
        `between` virtual seconds in between so the putter's refresh
        cycle and maintain_storage republication can restore the replica
        set, replacing each victim with a fresh node
        (↔ PersistenceTest.replace/mult_time, tests.py:600-829).

        The put must be permanent: plain values expire after their type
        TTL (10 min) by design, so multi-TTL churn windows would lose
        them regardless of churn (value.h:77 semantics).
        """
        key = InfoHash.get("persistence-key")
        nodes = list(self.net.nodes.values())
        seed_node, putter = nodes[0], nodes[-1]
        done = []
        putter.put(key, Value(payload), lambda ok, ns: done.append(ok),
                   permanent=True)
        self.net.run(max_time=30.0, until=lambda: bool(done))
        for _ in range(kills):
            holders = [d for d in self.net.storers_of(key)
                       if d is not seed_node and d is not putter]
            if not holders:
                break
            victim = self.rng.choice(holders)
            self.net.remove_node(victim)
            fresh = self.net.add_node(config)
            self.net.bootstrap_node(fresh, seed_node)
            self.net.settle(between)      # let republication run
        got: List[Value] = []
        fin = []
        # probe from a node that holds nothing locally (and isn't the
        # putter) so the check exercises network replication, not the
        # probe's own store
        storers = set(map(id, self.net.storers_of(key)))
        candidates = [d for d in self.net.nodes.values()
                      if d is not putter and id(d) not in storers]
        if not candidates:
            fresh = self.net.add_node(config)
            self.net.bootstrap_node(fresh, seed_node)
            self.net.settle(10.0)
            candidates = [fresh]
        probe = self.rng.choice(candidates)
        probe.get(key, lambda vs: got.extend(vs) or True,
                  lambda ok, ns: fin.append(ok))
        self.net.run(max_time=30.0, until=lambda: bool(fin))
        return any(v.data == payload for v in got)
