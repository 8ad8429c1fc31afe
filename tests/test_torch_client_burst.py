"""chip_smoke.py's request client (``client_burst``) sends each request
once, also after a pause between bursts.

The serve and runner phases fail on any packet the node drops for its
queue delay, so a client that doubles the node's load after a pause
(its engine's clock left at the previous burst's end: every request of
the new burst looks a second overdue and is sent again) is a fault of
the harness that shows as one of the node.  Runs a ``DhtRunner`` on
the CPU over loopback UDP."""

import importlib.util
import socket
import time
from pathlib import Path

import numpy as np

from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.runtime import DhtRunner

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def test_client_burst_sends_each_request_once_after_a_pause():
    node = DhtRunner()
    csock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        node.run(0, device="cpu")
        inner = node._dht._dht
        periodic = inner.periodic
        received = []

        def counted(data, addr):
            if data:
                received.append(bytes(data))
            return periodic(data, addr)
        inner.periodic = counted
        csock.bind(("127.0.0.1", 0))
        csock.setblocking(False)
        ceng, peer = chip_smoke.client_engine(
            csock, "burst-client", InfoHash(bytes(node.get_node_id())),
            node.get_bound_port())
        rng = np.random.default_rng(3)
        targets = [InfoHash(rng.integers(0, 256, 20, np.uint8).tobytes())
                   for _ in range(16)]
        per_burst = []
        for lo, hi in ((0, 8), (8, 16)):
            received.clear()
            b = chip_smoke.client_burst(ceng, peer, csock, targets, lo, hi,
                                        30)
            assert len(b["answers"]) == hi - lo and not b["expired"]
            # let any duplicate still in flight reach the node
            time.sleep(0.2)
            per_burst.append(len(received))
            # past the engine's 1 s retry time
            time.sleep(1.5)
        assert per_burst == [8, 8]
    finally:
        csock.close()
        node.join()
