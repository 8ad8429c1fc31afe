"""The port's keyspace observatory (``opendht_tpu_torch/keyspace.py``
and ``ops/sketch.py``) against the JAX package's.

- The device programs: ``hash_columns``, ``sketch_update``,
  ``sketch_query`` and ``sketch_decay`` on the CPU, bit-identical to the
  JAX functions and to the numpy mirror ``hash_columns_host`` (a numpy
  count-min), at the budget shape (``perf_budgets.json``
  ``kernels.sketch_update``: Q=64, depth 4, width 2048) and at edge
  cases: duplicate ids, ids with the top bit set, all-zero and all-ones
  limbs, every supported depth.
- The observatory, step by step: the same numpy-seeded Zipf stream of
  observed ids, stored keys and ticks through a JAX and a port
  ``KeyspaceObservatory``; after every step the same snapshot (top-K
  with estimates and hot flags, histogram, shard loads, imbalance) and
  the same sketch, cell for cell; the tick subscribers see the same
  lists; the go-dark contract on a failing device call.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from opendht_tpu.infohash import InfoHash as JHash
from opendht_tpu.keyspace import KeyspaceConfig as JConfig
from opendht_tpu.keyspace import KeyspaceObservatory as JObs
from opendht_tpu.ops import sketch as JS
from opendht_tpu_torch import keyspace as PK
from opendht_tpu_torch.keyspace import KeyspaceConfig, KeyspaceObservatory
from opendht_tpu_torch.ops import ids as IK
from opendht_tpu_torch.ops import sketch as PS

CPU = "cpu"


def _ids(seed: int, n: int) -> np.ndarray:
    """Seeded uint32 ids [n, 5] with the edge rows: duplicates, the top
    bit set, all-zero and all-ones limbs."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 2 ** 32, size=(n, 5), dtype=np.uint32)
    if n >= 16:
        ids[1:4] = ids[0]                       # duplicates
        ids[4] = 0
        ids[5] = 0xFFFFFFFF
        ids[6, 0] = 0x80000000                  # top bit only, limb 0
        ids[7] = 0x80000000
        ids[8:12, 0] |= np.uint32(0x80000000)   # top bit set
    return ids


# ------------------------------------------------------------- the ops
@pytest.mark.parametrize("depth,width", [(4, 2048), (1, 2), (8, 64),
                                         (3, 1 << 16)])
@pytest.mark.parametrize("n", [64, 1, 257])
def test_hash_columns_equal_jax_and_numpy(depth, width, n):
    ids = _ids(depth * 7 + n, n)
    want = np.asarray(JS.hash_columns(ids, depth, width))
    assert np.array_equal(JS.hash_columns_host(ids, depth, width), want)
    assert np.array_equal(PS.hash_columns_host(ids, depth, width), want)
    got = PS.hash_columns(IK.to_keys(ids, CPU), depth, width)
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    # uint32 ids in, on the device asked for
    assert np.array_equal(
        PS.hash_columns(ids, depth, width, device=CPU).numpy(), want)


@pytest.mark.parametrize("depth,width", [(0, 2048), (9, 2048), (4, 3),
                                         (4, 1)])
def test_bad_geometry_raises_as_in_jax(depth, width):
    with pytest.raises(ValueError):
        JS.sketch_init(depth, width)
    with pytest.raises(ValueError):
        PS.sketch_init(depth, width, device=CPU)


def _numpy_count_min(batches, depth, width, decays=()):
    """A numpy count-min of the id batches (each a uint32 [Q, 5]), with
    ``decays`` = {batch index: factor} applied after that batch."""
    sk = np.zeros((depth, width), np.int64)
    hist = np.zeros(256, np.int64)
    decays = dict(decays)
    for i, b in enumerate(batches):
        cols = PS.hash_columns_host(b, depth, width)
        for d in range(depth):
            np.add.at(sk[d], cols[:, d], 1)
        np.add.at(hist, b[:, 0] >> 24, 1)
        if i in decays:
            f = np.float32(decays[i])
            sk = np.floor(sk.astype(np.float32) * f).astype(np.int64)
            hist = np.floor(hist.astype(np.float32) * f).astype(np.int64)
    return sk, hist


@pytest.mark.parametrize("q", [64, 1, 1000])
def test_sketch_update_query_decay_equal_jax_and_numpy(q):
    depth, width = 4, 2048
    batches = [_ids(100 + i, q) for i in range(4)]
    decays = {1: 0.5, 3: 0.3}
    js, jh = JS.sketch_init(depth, width)
    ps, ph = PS.sketch_init(depth, width, device=CPU)
    for i, b in enumerate(batches):
        js, jh = JS.sketch_update(js, jh, b)
        ps, ph = PS.sketch_update(ps, ph, IK.to_keys(b, CPU))
        if i in decays:
            js, jh = JS.sketch_decay(js, jh, decays[i])
            ps, ph = PS.sketch_decay(ps, ph, decays[i])
        assert np.array_equal(ps.numpy(), np.asarray(js))
        assert np.array_equal(ph.numpy(), np.asarray(jh))
    sk, hist = _numpy_count_min(batches, depth, width, decays)
    assert np.array_equal(ps.numpy(), sk) and np.array_equal(ph.numpy(), hist)
    probe = np.concatenate([batches[0][:40], _ids(999, 40)])
    want = np.asarray(JS.sketch_query(js, probe))
    assert np.array_equal(PS.sketch_query(ps, probe).numpy(), want)
    assert ps.dtype == ph.dtype == torch.int32


def test_histogram_bins_come_from_the_unflipped_top_byte():
    """Bin b counts the ids whose first byte is b (the top 8 bits of the
    un-flipped limb 0), not the sign-flipped key's."""
    ids = np.zeros((256, 5), np.uint32)
    ids[:, 0] = np.arange(256, dtype=np.uint32) << 24
    ids[:128, 0] |= np.uint32(0x00FFFFFF)
    _, ph = PS.sketch_update(*PS.sketch_init(device=CPU), ids)
    assert np.array_equal(ph.numpy(), np.ones(256, np.int32))


def test_decay_keeps_the_float32_factor():
    """0.1 is rounded to float32 before the multiply, as in the JAX
    program: at 2^23 + 7 the float64 factor would floor differently."""
    js = np.full((4, 2048), (1 << 23) + 7, np.int32)
    jh = np.full(256, 1999, np.int32)
    want = [np.asarray(x) for x in JS.sketch_decay(js, jh, 0.1)]
    got = PS.sketch_decay(torch.from_numpy(js), torch.from_numpy(jh), 0.1)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    with pytest.raises(ValueError):
        PS.sketch_decay(torch.from_numpy(js), torch.from_numpy(jh), 1.5)


# ---------------------------------------------------- the observatory
def zipf_keys(seed: int, n_keys: int, n: int, s: float) -> tuple:
    """``n`` draws over ``n_keys`` seeded 20-byte keys with P(rank i) ∝
    1/i^s (the bounded Zipf of YCSB's request distribution).  Returns
    (keys as bytes, uint32 [n, 5] draws, ranks)."""
    rng = np.random.default_rng(seed)
    keys = IK.ids_to_bytes(rng.integers(0, 2 ** 32, size=(n_keys, 5),
                                        dtype=np.uint32))
    p = 1.0 / np.arange(1, n_keys + 1) ** s
    ranks = rng.choice(n_keys, size=n, p=p / p.sum())
    return ([k.tobytes() for k in keys], IK.ids_from_bytes(keys[ranks]),
            ranks)


def _both(**cfg):
    """A JAX and a port observatory on the same config, each with a
    subscriber recording the lists it is handed."""
    seen = {"jax": [], "port": []}
    j = JObs(JConfig(**cfg), node="ks-twin")
    p = KeyspaceObservatory(KeyspaceConfig(**cfg), node="ks-twin",
                            device=CPU)
    j.subscribe(lambda top: seen["jax"].append(
        [(t["_key"], t["estimate"], t["hot"]) for t in top]))
    p.subscribe(lambda top: seen["port"].append(
        [(t["_key"], t["estimate"], t["hot"]) for t in top]))
    return j, p, seen


def _same_state(j, p) -> None:
    assert p.snapshot() == j.snapshot()
    assert p.top_keys() == j.top_keys()
    assert p.imbalance() == j.imbalance()
    assert np.array_equal(p.hist_window(), j.hist_window())
    if j._sketch is not None:
        assert np.array_equal(p._sketch.numpy(), np.asarray(j._sketch))
        assert np.array_equal(p._hist.numpy(), np.asarray(j._hist))
    assert p._candidates == j._candidates


@pytest.mark.parametrize("stride,s", [(8, 1.1), (1, 0.99), (3, 1.4)])
def test_observatory_matches_jax_step_by_step(stride, s):
    """Waves of Zipf ids, stored keys (buffered, flushed by the next
    wave or the tick) and ticks: the same snapshot, sketch and
    candidate set after every step, the same hot keys."""
    keys, draws, _ = zipf_keys(7, 300, 2400, s)
    j, p, seen = _both(sample_stride=stride, candidates=64,
                       hot_min_count=8)
    rng = np.random.default_rng(8)
    pos = 0
    for step in range(12):
        q = int(rng.integers(1, 200))
        batch = draws[pos:pos + q]
        pos += q
        for obs in (j, p):
            obs.observe_ids(batch, source="wave")
        _same_state(j, p)
        for kb in rng.choice(len(keys), size=int(rng.integers(0, 9))):
            j.note_stored(JHash(keys[kb]))
            p.note_stored(PK.InfoHash(keys[kb]))
        if step % 3 == 2:
            assert p.tick() == j.tick()
            _same_state(j, p)
    assert p.tick() == j.tick()
    _same_state(j, p)
    assert seen["port"] == seen["jax"] and seen["jax"]
    if s > 1.0:
        assert p.snapshot()["hot_keys"], "the Zipf head turned hot"


def test_idle_ticks_flush_stores_and_decay_to_quiet():
    """A put-only node: stored keys flushed by the tick alone, the
    window decaying to zero, the store buffer's drop-oldest bound."""
    keys, _, _ = zipf_keys(9, 50, 1, 1.0)
    j, p, seen = _both(store_buffer=16, hot_min_count=2)
    for i in range(40):
        j.note_stored(JHash(keys[i % 7]))
        p.note_stored(PK.InfoHash(keys[i % 7]))
    assert len(p._pending_store) == len(j._pending_store) == 16
    for _ in range(8):
        assert p.tick() == j.tick()
        _same_state(j, p)
    assert p._window_total == j._window_total == 0.0
    assert seen["port"] == seen["jax"]


@pytest.mark.parametrize("where", ["update", "query", "decay"])
def test_go_dark_on_a_failing_device_call(monkeypatch, where):
    """A device call that raises turns the observatory off and clears
    its products, as in JAX: the same snapshot afterwards, unknown
    imbalance, and the same lists handed to the subscribers."""
    _, draws, _ = zipf_keys(10, 20, 400, 1.2)
    j, p, seen = _both(hot_min_count=4, min_observed=8)
    for obs in (j, p):
        obs.observe_ids(draws[:200])
        obs.tick()
    _same_state(j, p)

    def boom(*a, **k):
        raise RuntimeError("device lost")
    name = {"update": "sketch_update", "query": "sketch_query",
            "decay": "sketch_decay"}[where]
    monkeypatch.setattr(PS, name, boom)
    monkeypatch.setattr(JS, name, boom)
    for obs in (j, p):
        obs.observe_ids(draws[200:])
        obs.tick()
    assert not p.enabled and not j.enabled
    assert p.snapshot() == j.snapshot()
    assert p.imbalance() is None and j.imbalance() is None
    assert seen["port"] == seen["jax"]
    if where != "update":
        # a failure inside the tick tells the subscribers at once (a
        # failed update leaves the dark observatory's ticks silent)
        assert seen["port"][-1] == []


def test_the_sketch_lives_on_the_node_device_and_dark_without_it(
        monkeypatch):
    """The sketch is allocated on the observatory's device; a device that
    does not work (None = the card, absent here) degrades to a disabled
    observatory on first use, as the JAX package's missing backend
    does, instead of failing the node."""
    p = KeyspaceObservatory(device=CPU)
    p.observe_ids(_ids(3, 8))
    assert p._sketch.device.type == "cpu" and p.enabled
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dark = KeyspaceObservatory(device=None)
    dark.observe_ids(_ids(3, 8))
    assert not dark.enabled and dark.snapshot()["enabled"] is False
