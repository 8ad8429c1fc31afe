"""DhtNetwork: a cluster of real DhtRunner nodes on localhost UDP
(↔ reference python/tools/dht/network.py:283-436 — the in-namespace
node cluster; the netns/veth/netem tier is replaced by
:class:`~opendht_tpu_torch.testing.virtual_net.VirtualNet`'s simulated
delay/loss).

The port's copy of the JAX package's ``testing/network.py``, behaviour
unchanged.  The device is explicit: ``DhtNetwork(device=None)`` runs
every runner's tables on the CUDA card (raising without one, before any
socket is bound), the nodes ``launch_node`` and ``replace_cluster``
start later included; tests pass ``device="cpu"``."""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

from .. import chaos
from .._device import resolve_device
from ..core.value import Value
from ..infohash import InfoHash
from ..runtime.config import Config, NodeStatus
from ..runtime.runner import DhtRunner, RunnerConfig


class DhtNetwork:
    """Manage N in-process runners bound to localhost
    (↔ DhtNetwork, network.py:283-340)."""

    def __init__(self, num_nodes: int = 8, *,
                 config: Optional[Config] = None, seed: int = 0,
                 device=None):
        #: where every runner's tables live (None = the CUDA card)
        self.device = resolve_device(device)
        self.config = config or Config()
        self.rng = random.Random(seed)
        self.nodes: List[DhtRunner] = []
        self.bootstrap_addr = None
        self.injector: Optional["chaos.FaultInjector"] = None
        self._default_group: Optional[str] = None
        for _ in range(num_nodes):
            self.launch_node()

    # ------------------------------------------------------------- topology
    def launch_node(self, group: Optional[str] = None) -> DhtRunner:
        """(↔ DhtNetwork.launch_node, network.py:341-360).  While a
        FaultPlan is armed, the fresh node's engine is hooked too so a
        partition cannot silently leak through churn replacements; it
        joins ``group`` (or the arm-time ``default_group``, else the
        wildcard group)."""
        r = DhtRunner()
        r.run(0, RunnerConfig(dht_config=self.config), device=self.device)
        # hook BEFORE bootstrap: the loop thread must not get a first
        # packet out ahead of the fault hook (a replacement node in a
        # blocked group could otherwise leak one datagram across an
        # armed partition)
        if self.injector is not None:
            self._arm_one(r, group if group is not None
                          else self._default_group)
        if self.bootstrap_addr is None:
            self.bootstrap_addr = ("127.0.0.1", r.get_bound_port())
        else:
            r.bootstrap(*self.bootstrap_addr)
        self.nodes.append(r)
        return r

    def _arm_one(self, r: DhtRunner, group: Optional[str]) -> None:
        key = ("127.0.0.1", r.get_bound_port())
        if group is not None:
            self.injector.plan.membership.setdefault(key, group)
        chaos.arm_engine(r._dht._dht.engine, self.injector, key)

    def shutdown_node(self, node: Optional[DhtRunner] = None) -> None:
        """Stop one node (random non-seed by default)
        (↔ DhtNetworkSubProcess shutdown requests, network.py:377-436)."""
        if node is None:
            if len(self.nodes) <= 1:
                return
            node = self.rng.choice(self.nodes[1:])
        self.nodes.remove(node)
        node.join()

    def replace_cluster(self, count: int) -> List[DhtRunner]:
        """Kill ``count`` random non-seed nodes, launch replacements
        (↔ cluster replacement during test rounds, dht/tests.py:905-910)."""
        victims = self.rng.sample(self.nodes[1:],
                                  min(count, len(self.nodes) - 1))
        for v in victims:
            self.shutdown_node(v)
        return [self.launch_node() for _ in victims]

    def shutdown(self) -> None:
        self.disarm()
        for r in self.nodes:
            r.join()
        self.nodes.clear()

    # --------------------------------------------------------- chaos plane
    def arm(self, plan: "chaos.FaultPlan",
            groups: Optional[Dict[int, str]] = None,
            default_group: Optional[str] = None
            ) -> "chaos.FaultInjector":
        """Arm a FaultPlan across the live cluster: one
        shared injector, per-node fault hooks on every engine's send
        path — the same seam the virtual net and the live engine use.
        ``groups`` maps node INDEX → plan group; membership is derived
        from each runner's bound port so link rules and partitions
        match real datagrams.  An asymmetric partition is enforced at
        the SENDER (each direction's source drops), exactly netem's
        egress qdisc semantics.  Nodes launched later (churn
        replacements) are hooked automatically and join
        ``default_group`` (wildcard when None)."""
        groups = groups or {}
        self._default_group = default_group
        self.injector = chaos.FaultInjector(plan)
        self.injector.arm(time.monotonic())
        for i, r in enumerate(self.nodes):
            self._arm_one(r, groups.get(i, default_group))
        return self.injector

    def disarm(self) -> None:
        if getattr(self, "injector", None) is None:
            return
        for r in self.nodes:
            try:
                chaos.disarm_dht(r._dht._dht)
            except Exception:
                pass
        self.injector = None
        self._default_group = None

    # ------------------------------------------------------------- plumbing
    def wait_connected(self, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(r.get_status() is NodeStatus.CONNECTED
                   for r in self.nodes):
                return True
            time.sleep(0.05)
        return False

    def random_node(self) -> DhtRunner:
        return self.rng.choice(self.nodes)

    def get(self, key: InfoHash, timeout: float = 30.0) -> List[Value]:
        return self.random_node().get_sync(key, timeout=timeout)

    def put(self, key: InfoHash, value: Value, timeout: float = 30.0) -> bool:
        """(↔ the cluster put request, network.py:252-266)"""
        return self.random_node().put_sync(key, value, timeout=timeout)

    def __len__(self) -> int:
        return len(self.nodes)

    def __enter__(self) -> "DhtNetwork":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
