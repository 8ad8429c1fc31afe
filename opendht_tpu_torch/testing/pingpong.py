"""pingpong: two-node round-trip latency probe
(↔ reference python/tools/pingpong.py — the minimal wire-level latency
utility of the cluster toolkit).

Two in-process nodes bounce a value back and forth via put/listen;
prints per-round-trip wall-clock stats.  Usage::

    python -m opendht_tpu_torch.testing.pingpong [-n ROUNDS] [--cpu]

The port's copy of the JAX package's ``testing/pingpong.py``, behaviour
unchanged but for the device: both nodes run on the CUDA card unless
``--cpu`` is given, and without a card (and without ``--cpu``) it
raises before any socket is bound.  The JAX probe pins JAX to the CPU
instead.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="OpenDHT ping-pong "
                                            "(PyTorch port)")
    p.add_argument("-n", "--rounds", type=int, default=20)
    p.add_argument("-b", "--bootstrap", default="",
                   help="optional external bootstrap host[:port] "
                        "(default: private two-node network)")
    p.add_argument("--cpu", action="store_true",
                   help="run the nodes' tables on the host (default: the "
                        "CUDA card, and no card is an error)")
    args = p.parse_args(argv)

    # the card unless --cpu; resolved before any socket is bound
    from .._device import resolve_device
    device = "cpu" if args.cpu else None
    resolve_device(device)

    from ..core.value import Value
    import random as _random

    from ..infohash import InfoHash
    from ..runtime.config import NodeStatus
    from ..runtime.runner import DhtRunner
    from ..tools.common import parse_bootstrap
    from .scenarios import LatencyStats

    # per-run key suffix: stale values from a previous run against the
    # same external network must not satisfy this run's rounds
    run_tag = "%016x" % _random.getrandbits(64)
    ping_key = InfoHash.get("pingpong:ping:" + run_tag)
    pong_key = InfoHash.get("pingpong:pong:" + run_tag)

    a, b = DhtRunner(), DhtRunner()
    a.run(0, device=device)
    b.run(0, device=device)
    bs = parse_bootstrap(args.bootstrap)
    if bs:
        a.bootstrap(*bs)
        b.bootstrap(*bs)
    else:
        b.bootstrap("127.0.0.1", a.get_bound_port())
    deadline = time.monotonic() + 30.0
    while ((a.get_status() is not NodeStatus.CONNECTED
            or b.get_status() is not NodeStatus.CONNECTED)
           and time.monotonic() < deadline):
        time.sleep(0.05)

    # the ponger echoes every ping id it hears
    def pong(values, expired):
        if not expired:
            for v in values:
                b.put(pong_key, Value(v.data, value_id=v.id))
        return True

    b.listen(ping_key, pong)

    got = threading.Event()
    latest = {}

    def on_pong(values, expired):
        if not expired:
            for v in values:
                latest[v.id] = True
                got.set()
        return True

    a.listen(pong_key, on_pong)
    time.sleep(1.0)

    stats = LatencyStats()
    for i in range(args.rounds):
        vid = _random.getrandbits(48) | 1
        got.clear()
        t0 = time.monotonic()
        a.put(ping_key, Value(b"ping", value_id=vid))
        while vid not in latest and time.monotonic() - t0 < 10.0:
            got.wait(0.01)
            got.clear()
        if vid in latest:
            stats.add(time.monotonic() - t0)
    a.join()
    b.join()
    print(json.dumps({"test": "pingpong", "rounds": args.rounds,
                      **stats.summary()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
