"""Hop parity on the port: the live iterative search against the batched
simulator, and the live search against the JAX package's.

tests/test_hop_parity.py runs cold-start gets by fresh observers (an
empty table, one bootstrap seed) on a live virtual-UDP cluster and holds
their discovery depth (``live_search.Search.current_hops``) and their
recall of the true closest 8 against ``core/search.py
simulate_lookups``.  This file runs the same recipe over the port's
``VirtualNet(device="cpu")`` and its own ``simulate_lookups``:

- **The twin, tolerance 0** (N = 512 and 2,048, seeded convergence).
  Both packages get the same node ids (``os.urandom`` and
  ``random._urandom``, which ``secrets`` draws through, patched to one
  seeded stream), the same ``random`` state and the same targets
  (``random.Random(7)``).  ``seed_converged`` draws its tables from
  ``np.random.default_rng`` and quiesces the maintenance that draws from
  ``jax.random`` or torch, and each get ends within a virtual second, so
  every lookup must match: hops, recall, the first 8 ids found in order,
  the virtual seconds it took and the datagrams sent meanwhile, byte for
  byte but for their transaction ids.  Those come from ``random``, which
  both packages draw alike until an observer's first maintenance pass
  (~3 virtual s after its get) refreshes its buckets towards targets
  drawn from ``jax.random`` in one package and torch in the other: the
  nodes found then differ, and so does the number of ids drawn for
  them.  The first lookup's datagrams are equal with their ids.  The
  twin found one difference (ROADMAP C.1): the port's table
  seeded its maintenance generator with eight bytes of ``os.urandom``,
  the JAX table its key with four, so every id drawn after an observer's
  first maintenance pass differed; the port now draws four, pinned by
  :func:`test_a_tables_maintenance_seed_takes_four_urandom_bytes_as_jaxs`.
- **The JAX test's assertions, on the port**: |p50 live − p50 sim| ≤ 1.5
  at N = 128 and 512 with protocol convergence, seeded ≡ protocol at
  512, and at scale live depth + 1 within one round of the simulator,
  which may not undercut it, with a recall median ≥ 7.  The simulator
  runs on a table and targets from ``np.random.default_rng(3)`` (torch
  cannot reproduce the JAX test's ``jax.random`` draws); its equality
  with the JAX engine is pinned by tests/test_torch_search.py.
- The at-scale points 8,192-32,768 (65,536 with ``RUN_XL_CLUSTER``) are
  slow-marked, as the JAX file marks them.

A run is cached per package, size and convergence, so the tests of one
file share their clusters; every run is seeded, so what a test sees
does not depend on which test ran first.
"""

from __future__ import annotations

import hashlib
import importlib
import os
import random
import socket
from typing import NamedTuple

import msgpack
import numpy as np
import pytest
import torch

from test_torch_storage import PACKAGES, seed_streams

#: the seed of the patched ``os.urandom`` stream and of ``random``
STREAM_SEED = 11
#: cold-start gets per cluster (the JAX test's 8; its at-scale points 6)
LOOKUPS = 8
SCALE_LOOKUPS = 6
#: the sizes of the twin and of the tier-1 at-scale point
TWIN_SIZES = (512, 2048)
SLOW_SIZES = [8192, 16384, 32768] + (
    [65536] if os.environ.get("RUN_XL_CLUSTER") else [])


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads: the nodes' ops are tiny, and beside other
    busy test processes all-core OpenMP pools slow every process."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class Lookup(NamedTuple):
    hops: int
    recall: int
    found: tuple          # the first 8 candidates' ids, in order
    seconds: float        # virtual seconds from the get to its done
    wire: tuple           # datagrams sent meanwhile: (count, sha256)
    tids: str             # their transaction ids: sha256


def without_tid(data: bytes) -> bytes:
    """A datagram with its transaction id left out."""
    msg = msgpack.unpackb(data, raw=True, strict_map_key=False)
    msg.pop(b"t", None)
    return msgpack.packb(msg)


def live_cold_start(pkg: str, n_nodes: int, n_lookups: int, seed: int = 7,
                    converge: str = "protocol") -> list:
    """Cold-start gets by fresh observers against an ``n_nodes`` virtual
    UDP network of package ``pkg`` ("jax" or "port", the port's on the
    CPU).  ``converge``: "protocol" = bootstrap chatter and a maintenance
    settle, "seeded" = ``VirtualNet.seed_converged``.  One
    :class:`Lookup` per get."""
    mod = PACKAGES[pkg]
    VirtualNet = importlib.import_module(mod + ".testing").VirtualNet
    InfoHash = importlib.import_module(mod + ".infohash").InfoHash
    rng = random.Random(seed)
    net = VirtualNet(device="cpu") if pkg == "port" else VirtualNet()
    sent = None           # a lookup's datagrams, while one runs
    enqueue = net._enqueue

    def recorded(arrival, data, src, dst_key):
        if sent is not None:
            sent.append((src.port, dst_key[1], bytes(data)))
        return enqueue(arrival, data, src, dst_key)
    net._enqueue = recorded
    seed_node = net.add_node()
    for _ in range(n_nodes - 1):
        net.add_node()
    if converge == "seeded":
        net.seed_converged()
    else:
        net.bootstrap_all(seed_node)
        assert net.run(240, net.all_connected), "cluster never converged"
        net.settle(60)
    ids = [d.get_node_id() for d in net.nodes.values()]

    out = []
    for _ in range(n_lookups):
        obs = net.add_node()
        net.bootstrap_node(obs, seed_node)
        target = InfoHash(bytes(rng.getrandbits(8) for _ in range(20)))
        done, t0, sent = {}, net.clock, []
        # issued at once: the search boots from the one seed, as the
        # simulator's cold-start model does
        obs.get(target, lambda vals: True,
                lambda ok, ns: done.update(ok=ok, t=net.clock,
                                           n=len(sent)))
        assert net.run(60, lambda: "ok" in done), "get never completed"
        pkts, sent = sent[:done["n"]], None
        wire = hashlib.sha256(repr([(a, b, without_tid(d))
                                    for a, b, d in pkts]).encode())
        tids = hashlib.sha256(repr([
            msgpack.unpackb(d, raw=True, strict_map_key=False).get(b"t")
            for _a, _b, d in pkts]).encode())
        sr = obs._searches_of(socket.AF_INET).get(target)
        h = sr.current_hops()
        assert h is not None
        true8 = {bytes(x) for x in
                 sorted(ids, key=lambda n: bytes(target.xor(n)))[:8]}
        found = tuple(bytes(sn.node.id) for sn in sr.nodes[:8])
        out.append(Lookup(h, len(set(found) & true8), found,
                          round(done["t"] - t0, 9),
                          (len(pkts), wire.hexdigest()), tids.hexdigest()))
        net.remove_node(obs)
    return out


_RUNS: dict = {}


def cold_start(pkg: str, n_nodes: int, converge: str, monkeypatch,
               n_lookups: int = LOOKUPS) -> list:
    """:func:`live_cold_start` on seeded streams, cached: a run of more
    lookups serves a shorter one with its prefix (the gets run one after
    another, so the first n of a longer run are the run of n)."""
    for (p, n, c, m), runs in _RUNS.items():
        if (p, n, c) == (pkg, n_nodes, converge) and m >= n_lookups:
            return runs[:n_lookups]
    # a first import draws from the streams: import before seeding them
    for name in ("testing", "infohash"):
        importlib.import_module(PACKAGES[pkg] + "." + name)
    seed_streams(monkeypatch, STREAM_SEED)
    runs = live_cold_start(pkg, n_nodes, n_lookups, converge=converge)
    _RUNS[(pkg, n_nodes, converge, n_lookups)] = runs
    return runs


def sim_hops(n_nodes: int, n_lookups: int, seed: int = 3) -> list:
    """The port's batched engine on the CPU (α = 4, k = 8) over a table
    and targets drawn from ``np.random.default_rng(seed)``."""
    from opendht_tpu_torch.core.search import simulate_lookups
    from opendht_tpu_torch.ops.ids import to_keys
    from opendht_tpu_torch.ops.sorted_table import sort_table
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**32, size=(n_nodes, 5), dtype=np.uint32)
    targets = rng.integers(0, 2**32, size=(n_lookups, 5), dtype=np.uint32)
    sorted_ids, _perm, n_valid = sort_table(to_keys(table, "cpu"))
    out = simulate_lookups(sorted_ids, n_valid, to_keys(targets, "cpu"),
                           device="cpu")
    assert bool(out["converged"].all())
    return out["hops"].tolist()


# ------------------------------------------------ the twin, tolerance 0
@pytest.mark.parametrize("n_nodes", TWIN_SIZES)
def test_seeded_cold_start_lookups_equal_jax(n_nodes, monkeypatch):
    want = cold_start("jax", n_nodes, "seeded", monkeypatch)
    got = cold_start("port", n_nodes, "seeded", monkeypatch)
    assert len(got) == len(want) == LOOKUPS
    assert got[0].tids == want[0].tids
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[:-1] == w[:-1], f"lookup {i}: port {g} != JAX {w}"
    assert all(w.seconds <= 1.0 for w in want), want


def test_a_tables_maintenance_seed_takes_four_urandom_bytes_as_jaxs(
        monkeypatch):
    """A table's first maintenance pass seeds its generator (the port) or
    key (JAX) from ``os.urandom``: both take four bytes, so the stream's
    later draws (the next node's id) are the same in both packages."""
    from opendht_tpu.core.table import NodeTable as JaxTable
    from opendht_tpu.infohash import InfoHash as JaxHash
    from opendht_tpu_torch.core.table import NodeTable
    from opendht_tpu_torch.infohash import InfoHash

    def drawn(make) -> int:
        taken = []

        def urandom(n):
            taken.append(n)
            return bytes(n)
        with monkeypatch.context() as m:
            m.setattr(os, "urandom", urandom)
            make().maintenance_sweep(100.0)
            return sum(taken)
    port = drawn(lambda: NodeTable(InfoHash.get("me"), device="cpu"))
    jax = drawn(lambda: JaxTable(JaxHash.get("me")))
    assert port == jax == 4


# --------------------------------- the JAX test's assertions, on the port
@pytest.mark.parametrize("n_nodes", [128, 512])
def test_live_vs_simulator_hop_parity(n_nodes, monkeypatch):
    runs = cold_start("port", n_nodes, "protocol", monkeypatch)
    live, recall = [r.hops for r in runs], [r.recall for r in runs]
    sim = sim_hops(n_nodes, n_lookups=512)
    p50_live = float(np.median(live))
    p50_sim = float(np.median(sim))
    assert abs(p50_live - p50_sim) <= 1.5, \
        f"live p50 {p50_live} (hops {live}) vs sim p50 {p50_sim}"
    assert p50_live >= 1 and p50_sim >= 1
    assert float(np.median(recall)) >= 7, (recall, live)


def test_seeded_equals_protocol_convergence(monkeypatch):
    prot = cold_start("port", 512, "protocol", monkeypatch)
    seed = cold_start("port", 512, "seeded", monkeypatch)
    live_p, live_s = [r.hops for r in prot], [r.hops for r in seed]
    assert abs(float(np.median(live_p)) - float(np.median(live_s))) <= 1.0, \
        (live_p, live_s)
    assert float(np.median([r.recall for r in seed])) >= 7 and \
        float(np.median([r.recall for r in prot])) >= 7


@pytest.mark.parametrize("n_nodes", [2048] + [
    pytest.param(n, marks=pytest.mark.slow) for n in SLOW_SIZES])
def test_live_vs_simulator_hop_parity_at_scale(n_nodes, monkeypatch):
    runs = cold_start("port", n_nodes, "seeded", monkeypatch,
                      n_lookups=SCALE_LOOKUPS)
    live, recall = [r.hops for r in runs], [r.recall for r in runs]
    sim = sim_hops(n_nodes, n_lookups=512)
    p50_live_rounds = float(np.median(live)) + 1   # depth → rounds
    p50_sim = float(np.median(sim))
    assert abs(p50_sim - p50_live_rounds) <= 1.0, \
        f"sim p50 {p50_sim} vs live rounds {p50_live_rounds} ({live})"
    assert p50_sim >= p50_live_rounds - 0.5
    assert float(np.median(recall)) >= 7, (recall, live)
