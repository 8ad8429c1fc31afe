"""Cluster benchmark CLI (↔ reference python/tools/dht/benchmark.py).

Usage::

    python -m opendht_tpu_torch.testing.benchmark -t gets -n 32 -r 10 -g 50
    python -m opendht_tpu_torch.testing.benchmark -t delete -n 32
    python -m opendht_tpu_torch.testing.benchmark -t persistence -n 24
    python -m opendht_tpu_torch.testing.benchmark -t gets --real -n 8

Default backend is the deterministic virtual network (latencies are in
*virtual* seconds — the simulated wire delay, -d, dominates); ``--real``
runs on real localhost UDP runners and reports wall-clock latencies.

The port's copy of the JAX package's ``testing/benchmark.py``, behaviour
unchanged but for the device: every node runs on the CUDA card unless
``--cpu`` is given, and without a card (and without ``--cpu``) it
raises before any node is built.  The JAX CLI pins JAX to the CPU
instead.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def run_gets_virtual(args) -> dict:
    from ..runtime.config import Config
    from .scenarios import PerformanceTest, build_net
    net = build_net(args.nodes, delay=args.delay, loss=args.loss,
                    seed=args.seed, device=args.device)
    stats = PerformanceTest(net, seed=args.seed).gets_times(
        rounds=args.rounds, gets_per_round=args.gets,
        replace=args.replace, config=Config())
    return {"test": "gets", "backend": "virtual", "nodes": args.nodes,
            **stats.summary()}


def run_gets_real(args) -> dict:
    from ..infohash import InfoHash
    from .network import DhtNetwork
    from .scenarios import LatencyStats
    stats = LatencyStats()
    with DhtNetwork(args.nodes, seed=args.seed,
                    device=args.device) as net:
        net.wait_connected()
        for _ in range(args.rounds):
            for _ in range(args.gets):
                t0 = time.monotonic()
                net.get(InfoHash.get_random(), timeout=30.0)
                stats.add(time.monotonic() - t0)
            if args.replace:
                net.replace_cluster(args.replace)
                net.wait_connected()
    return {"test": "gets", "backend": "real", "nodes": args.nodes,
            **stats.summary()}


def run_delete(args) -> dict:
    from .scenarios import PerformanceTest, build_net
    net = build_net(args.nodes, delay=args.delay, loss=args.loss,
                    seed=args.seed, device=args.device)
    survived, holders = PerformanceTest(net, seed=args.seed).delete_test()
    return {"test": "delete", "nodes": args.nodes,
            "holders_killed": holders, "value_survived": survived}


def run_persistence(args) -> dict:
    from ..runtime.config import Config
    from .scenarios import PersistenceTest, build_net
    conf = Config(maintain_storage=True)
    net = build_net(args.nodes, delay=args.delay, loss=args.loss,
                    seed=args.seed, config=conf, device=args.device)
    ok = PersistenceTest(net, seed=args.seed).churn_survival(
        kills=args.replace or 4, config=conf)
    return {"test": "persistence", "nodes": args.nodes, "survived": ok}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="OpenDHT cluster benchmark "
                                            "(PyTorch port)")
    p.add_argument("-t", "--test", default="gets",
                   choices=["gets", "delete", "persistence"])
    p.add_argument("-n", "--nodes", type=int, default=32)
    p.add_argument("-r", "--rounds", type=int, default=10)
    p.add_argument("-g", "--gets", type=int, default=50)
    p.add_argument("--replace", type=int, default=0,
                   help="nodes replaced between rounds / churn kills")
    p.add_argument("-d", "--delay", type=float, default=0.005,
                   help="virtual wire delay seconds (netem analogue)")
    p.add_argument("-l", "--loss", type=float, default=0.0,
                   help="virtual packet loss [0..1] (netem analogue)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--real", action="store_true",
                   help="real localhost UDP runners instead of the "
                        "virtual network")
    p.add_argument("--cpu", action="store_true",
                   help="run the nodes' tables on the host (default: the "
                        "CUDA card, and no card is an error)")
    args = p.parse_args(argv)
    if args.real and args.test != "gets":
        p.error("--real is only implemented for -t gets")

    # the card unless --cpu; resolved before any node is built, so a
    # missing card fails first
    from .._device import resolve_device
    args.device = "cpu" if args.cpu else None
    resolve_device(args.device)

    if args.test == "gets":
        out = run_gets_real(args) if args.real else run_gets_virtual(args)
    elif args.test == "delete":
        out = run_delete(args)
    else:
        out = run_persistence(args)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
