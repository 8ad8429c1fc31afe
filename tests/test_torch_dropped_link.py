"""chip_smoke.py's dropped-link leg (``drop_link``) makes the dropped link
carry expiring requests, also when the source already holds the
destination expired.

The monitor phase requires that the wire map ranks the dropped directed
link A -> B worst, and that at least 3 of A's requests to B expired. A
node marked expired in A's table is skipped by A's searches, and while
A's replies to B are dropped nothing B sends clears the mark, so a B that
one slow earlier request left expired would receive nothing from A: the
leg first has A ping B. Runs four ``DhtRunner``s on the CPU over
loopback UDP."""

import importlib.util
import socket
from concurrent.futures import Future
from pathlib import Path

from opendht_tpu_torch.runtime import Config
from opendht_tpu_torch.testing import DhtNetwork

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _expire_in(runner, node_id) -> bool:
    """Mark ``node_id`` expired in ``runner``'s node cache, on its DHT
    thread, as an expired request of its own does."""
    done = Future()

    def op(dht):
        node = dht._dht.engine.cache.lookup(node_id, socket.AF_INET)
        if node is not None:
            node.set_expired()
        done.set_result(node is not None)
    runner._post(op, prio=True)
    return done.result(30)


def test_drop_link_expires_requests_to_a_destination_held_expired():
    net = DhtNetwork(4, config=Config(max_req_per_sec=1_000_000), seed=5,
                     device="cpu")
    try:
        assert net.wait_connected(60)
        a, b = net.nodes[1], net.nodes[2]
        # once A has met B
        assert chip_smoke._wait(lambda: _expire_in(a, b.get_node_id()), 30,
                                step=0.2)
        out = chip_smoke.drop_link(net, 1, 2, seed=5, timeout=20)
        assert out["status_after_ping"] == "good"
        assert out["record"]["expired"] >= 3
        # the rule is lifted: A reaches B again
        assert net.injector is None
    finally:
        net.shutdown()
