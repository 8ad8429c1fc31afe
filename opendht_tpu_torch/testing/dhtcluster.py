"""dhtcluster: run and control a resizable cluster of live DHT nodes.

Analog of the reference cluster driver (reference python/tools/
dhtcluster.py:29-270): a ``NodeCluster`` manages N in-process DhtRunner
nodes (launch/end/resize, aggregate message stats), and ``ClusterShell``
is a cmd.Cmd REPL with the reference's commands (node, resize, ll, ls,
log, exit).  Service mode runs headless under SIGTERM/SIGINT handlers.

All nodes bind 127.0.0.1 with OS-assigned ports and bootstrap off the
first node, so a multi-hundred-node cluster runs in one process with no
interface configuration (the reference binds an interface IP and a port
range; netifaces-style interface selection has no analog here).

Usage::

    python -m opendht_tpu_torch.testing.dhtcluster -n 16        # REPL
    python -m opendht_tpu_torch.testing.dhtcluster -n 16 -s     # service
    python -m opendht_tpu_torch.testing.dhtcluster -n 4 --cpu   # on the host

The port's copy of the JAX package's ``testing/dhtcluster.py``,
behaviour unchanged but for the device: every node's tables live on the
CUDA card unless ``device="cpu"`` (``--cpu``) is given, and without a
card ``NodeCluster`` raises before any socket is bound.
"""

from __future__ import annotations

import argparse
import cmd
import signal
import sys
import time

from .._device import resolve_device
from ..runtime.runner import DhtRunner

MAX_NODES = 500                  # reference dhtcluster.py:106


class NodeCluster:
    """A resizable set of live local nodes (dhtcluster.py:29-128)."""

    def __init__(self, port: int = 0, device=None):
        #: where every node's tables live (None = the CUDA card)
        self.device = resolve_device(device)
        self.nodes: list[DhtRunner] = []
        self.port = port            # 0 = OS-assigned per node

    # -- lifecycle ---------------------------------------------------------
    def launch_node(self) -> DhtRunner:
        n = DhtRunner()
        n.run(self.port if not self.nodes else 0, device=self.device)
        if self.nodes:
            n.bootstrap("127.0.0.1", self.nodes[0].get_bound_port())
        self.nodes.append(n)
        return n

    def end_node(self) -> bool:
        if not self.nodes:
            return False
        self.nodes.pop().join()
        return True

    def resize(self, n: int) -> None:
        n = max(0, min(n, MAX_NODES))
        while len(self.nodes) < n:
            self.launch_node()
            time.sleep(0.01)
        while len(self.nodes) > n:
            self.end_node()

    def close(self) -> None:
        self.resize(0)

    # -- access ------------------------------------------------------------
    def front(self):
        return self.nodes[0] if self.nodes else None

    def get(self, i: int):
        return self.nodes[i] if 0 <= i < len(self.nodes) else None

    def get_node_info_by_id(self, node_id):
        for n in self.nodes:
            if n.get_node_id() == node_id:
                return n
        return None

    def get_message_stats(self) -> list:
        """[n_nodes, sum of per-node engine counters]
        (dhtcluster.py:122-128)."""
        totals = None
        for n in self.nodes:
            s = n.get_node_message_stats()
            totals = s if totals is None else [a + b
                                               for a, b in zip(totals, s)]
        return [len(self.nodes)] + (totals or [])


class ClusterShell(cmd.Cmd):
    """dhtcluster.py:130-192."""

    intro = ("Welcome to the OpenDHT-TPU node cluster control. "
             "Type help or ? to list commands.\n")
    prompt = ">> "

    def __init__(self, network: NodeCluster, stdout=None, stdin=None):
        super().__init__(stdout=stdout, stdin=stdin)
        if stdin is not None:
            self.use_rawinput = False
        self.net = network
        self.node = None
        self.node_num = 0

    def _print(self, *args):
        print(*args, file=self.stdout)

    def do_exit(self, arg):
        """Stop the cluster and exit."""
        self.close()
        return True

    do_EOF = do_exit

    def do_node(self, arg):
        """node [N]: select node N (1-based) or deselect."""
        if not arg:
            self.node, self.node_num = None, 0
            self.prompt = ">> "
            return
        try:
            num = int(arg)
        except ValueError:
            self._print("Invalid node number:", arg)
            return
        node = self.net.get(num - 1)
        if node is None:
            self._print("Invalid node number:", num,
                        "(accepted: 1-%d)" % len(self.net.nodes))
        else:
            self.node, self.node_num = node, num
            self.prompt = "(%d) >> " % num

    def do_resize(self, arg):
        """resize N: grow/shrink the cluster to N nodes."""
        if not arg:
            return
        try:
            self.net.resize(int(arg))
        except Exception as e:
            self._print("Can't resize:", e)
        # a shrink may have joined the selected node — deselect it so
        # later commands don't act on a dead runner
        if self.node is not None and self.node not in self.net.nodes:
            self._print("(selected node %d was removed)" % self.node_num)
            self.node, self.node_num = None, 0
            self.prompt = ">> "

    def do_ll(self, arg):
        """Selected node id, or cluster size."""
        if self.node:
            self._print("Node", self.node.get_node_id().hex())
        else:
            self._print(len(self.net.nodes), "nodes running.")

    def do_ls(self, arg):
        """Searches log of the selected node."""
        if self.node:
            self._print(self.node.get_searches_log())
        else:
            self._print("No node selected.")

    def do_stats(self, arg):
        """Aggregate message statistics over the cluster."""
        self._print(self.net.get_message_stats())

    def do_log(self, arg):
        """Toggle logging on the selected node."""
        if self.node:
            self._print("(log toggling is a no-op here: use the module "
                        "logger, opendht_tpu_torch.log.setup_logging)")

    def close(self):
        if self.net is not None:
            self.net.close()
            self.net = None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Create a dht network of -n nodes")
    p.add_argument("-n", "--node-num", type=int, default=32,
                   help="number of dht nodes to run")
    p.add_argument("-p", "--port", type=int, default=0,
                   help="port for the first (bootstrap) node")
    p.add_argument("-s", "--service", action="store_true",
                   help="service mode (headless, stop on SIGTERM/SIGINT)")
    p.add_argument("--cpu", action="store_true",
                   help="run the nodes' tables on the host (default: the "
                        "CUDA card, and no card is an error)")
    args = p.parse_args(argv)

    net = NodeCluster(port=args.port, device="cpu" if args.cpu else None)
    stop = []

    def quit_signal(signum, frame):
        stop.append(signum)

    try:
        if args.service:
            signal.signal(signal.SIGTERM, quit_signal)
            signal.signal(signal.SIGINT, quit_signal)
            net.resize(args.node_num)
            print("%d nodes running (bootstrap 127.0.0.1:%d)"
                  % (len(net.nodes), net.front().get_bound_port()))
            while not stop:
                time.sleep(0.5)
        else:
            net.resize(args.node_num)
            ClusterShell(net).cmdloop()
    finally:
        net.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
