"""Real-kernel network tier: clusters in Linux network NAMESPACES.

The reference's distributed test infra runs node clusters in network
namespaces joined by bridges/veth with netem shaping
(reference python/tools/dht/virtual_network_builder.py:1-121,
network.py NSPopen).  This tier reproduces the namespace/veth/routing
half on this kernel: each cluster is a :class:`ClusterSubProcess`
living in its OWN netns, reached through a veth pair, with the root
namespace forwarding between cluster subnets — so DHT traffic crosses
REAL kernel interfaces (device queues, ARP, IP routing), not a
userspace switch.

What stays with the deterministic virtual-clock tier
(testing/virtual_net.py): loss/delay shaping.  This kernel ships no
``sch_netem`` (``tc qdisc add ... netem`` → "Specified qdisc kind is
unknown") and no iptables/nftables userland, so in-kernel loss is not
buildable here; the capability is probed, not assumed —
:func:`netem_available` documents the hole and the tier degrades to
loss-free real-kernel plumbing.

Requires CAP_NET_ADMIN (root).  All state is torn down in ``close()``;
names are prefixed ``odt`` to avoid collisions.

The port's copy of the JAX package's ``testing/netns_net.py``,
behaviour unchanged but for the device: its clusters are the port's
:class:`ClusterSubProcess` children, on the CUDA card unless
``NetnsClusterNet(device="cpu")``; without a card (and without
``device="cpu"``) it raises before any namespace is made.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import List, Optional

from .._device import resolve_device
from .subproc_cluster import ClusterSubProcess

_SUBNET = "10.77.%d"


def _sh(*argv, check: bool = True) -> subprocess.CompletedProcess:
    return subprocess.run(argv, capture_output=True, text=True,
                          check=check)


def _uniq() -> str:
    """Short per-process prefix: concurrent sessions must not race on
    kernel object names (interface names cap at 15 chars)."""
    return "odt%d" % (os.getpid() % 100000)


def netns_available() -> bool:
    """True when namespaces + veth can actually be created here.
    Stale probe artifacts from a killed prior run are cleared first so
    one crash can never permanently disable the tier; names are
    per-process so concurrent sessions cannot corrupt each other."""
    u = _uniq()
    try:
        _sh("ip", "netns", "del", u + "pr", check=False)
        _sh("ip", "link", "del", u + "p0", check=False)
        _sh("ip", "netns", "add", u + "pr")
    except (OSError, subprocess.CalledProcessError):
        return False
    try:
        _sh("ip", "link", "add", u + "p0", "type", "veth",
            "peer", "name", u + "p1")
        _sh("ip", "link", "del", u + "p0")
        return True
    except (OSError, subprocess.CalledProcessError):
        return False
    finally:
        _sh("ip", "netns", "del", u + "pr", check=False)


def netem_available() -> bool:
    """True when the kernel can attach a netem qdisc (loss/delay).
    False on this build host — recorded as the environment bound.
    Must never raise: a missing ``tc`` binary (no iproute2-tc userland)
    is one of the exact environments this probe documents."""
    u = _uniq()
    try:
        _sh("ip", "link", "del", u + "q0", check=False)
        _sh("ip", "link", "add", u + "q0", "type", "veth",
            "peer", "name", u + "q1")
    except (OSError, subprocess.CalledProcessError):
        return False
    try:
        r = _sh("tc", "qdisc", "add", "dev", u + "q0", "root",
                "netem", "delay", "1ms", check=False)
        return r.returncode == 0
    except OSError:                      # tc binary absent
        return False
    finally:
        _sh("ip", "link", "del", u + "q0", check=False)


class NetnsClusterNet:
    """N cluster subprocesses, each in its own namespace, routed
    through the root namespace.

    Topology per cluster i (subnet 10.77.i.0/24):

        root ns:  odtv{i}h  10.77.i.1/24   (also the clusters' gateway)
        odtns{i}: odtv{i}c  10.77.i.2/24, default route via 10.77.i.1

    A DHT node in the root namespace (bound 0.0.0.0) is reachable from
    every cluster at its gateway address; clusters reach EACH OTHER
    through root-namespace IP forwarding — every packet crosses two
    real veth devices and the kernel's forwarding path.
    """

    def __init__(self, device=None):
        #: where every cluster's nodes keep their tables (None = the card)
        self.device = resolve_device(device)
        self.clusters: List[ClusterSubProcess] = []
        self._ns: List[str] = []
        self._links: List[str] = []
        self._prefix = _uniq()
        self._saved_ip_forward: Optional[str] = None

    def add_cluster(self, n_nodes: int, *, timeout: float = 120.0
                    ) -> ClusterSubProcess:
        i = len(self._ns)
        p = self._prefix
        ns, vh, vc = f"{p}n{i}", f"{p}v{i}h", f"{p}v{i}c"
        sub = _SUBNET % i
        # clear stale artifacts from a killed prior run of THIS pid slot
        _sh("ip", "netns", "del", ns, check=False)
        _sh("ip", "link", "del", vh, check=False)
        _sh("ip", "netns", "add", ns)
        self._ns.append(ns)
        _sh("ip", "link", "add", vh, "type", "veth", "peer", "name", vc)
        self._links.append(vh)
        _sh("ip", "link", "set", vc, "netns", ns)
        _sh("ip", "addr", "add", f"{sub}.1/24", "dev", vh)
        _sh("ip", "link", "set", vh, "up")
        for cmd in ((f"ip addr add {sub}.2/24 dev {vc}"),
                    (f"ip link set {vc} up"),
                    ("ip link set lo up"),
                    (f"ip route add default via {sub}.1")):
            _sh("ip", "netns", "exec", ns, *cmd.split())
        # forwarding is load-bearing for cross-cluster traffic: write
        # /proc directly (no sysctl-binary dependency) and VERIFY — a
        # silently-off forward would blackhole a<->b packets and
        # surface later as an opaque lookup miss.  The prior value is
        # saved once and restored in close(): flipping a host-global
        # routing knob must not outlive the harness.
        with open("/proc/sys/net/ipv4/ip_forward") as f:
            cur = f.read().strip()
        if cur != "1":
            if self._saved_ip_forward is None:
                self._saved_ip_forward = cur
            try:
                with open("/proc/sys/net/ipv4/ip_forward", "w") as f:
                    f.write("1")
            except OSError:
                pass
            with open("/proc/sys/net/ipv4/ip_forward") as f:
                if f.read().strip() != "1":
                    raise RuntimeError(
                        "cannot enable net.ipv4.ip_forward — "
                        "cross-cluster routing unavailable in this "
                        "container")
        cl = ClusterSubProcess(argv_prefix=("ip", "netns", "exec", ns),
                               timeout=timeout, device=self.device)
        self.clusters.append(cl)
        if n_nodes:
            cl.launch(n_nodes)
        return cl

    def cluster_addr(self, i: int) -> str:
        """The cluster's address as seen from the root namespace."""
        return (_SUBNET % i) + ".2"

    def gateway_addr(self, i: int) -> str:
        """The root namespace's address on cluster i's subnet (where a
        root-ns node is reachable from that cluster)."""
        return (_SUBNET % i) + ".1"

    def close(self) -> None:
        for cl in self.clusters:
            try:
                if cl.proc.poll() is None:
                    cl.quit()
            except Exception:
                cl.kill()
        time.sleep(0.1)
        for vh in self._links:
            _sh("ip", "link", "del", vh, check=False)
        for ns in self._ns:
            _sh("ip", "netns", "del", ns, check=False)
        if self._saved_ip_forward is not None:
            try:
                with open("/proc/sys/net/ipv4/ip_forward", "w") as f:
                    f.write(self._saved_ip_forward)
            except OSError:
                pass
            self._saved_ip_forward = None
        self.clusters.clear()
        self._ns.clear()
        self._links.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
