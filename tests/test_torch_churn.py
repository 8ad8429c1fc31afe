"""Parity of the port's churn path with the JAX package, bit for bit.

Kernel tier: ``unpack_tomb_bits``, ``packed_churn_merge`` and
``churn_lookup_topk`` (fast3 and fast2, pack widths, tombstone
densities, an empty base, tomb-heavy windows, the narrow-delta cascade,
a forced fast2 tie repair, the perf_budgets.json shape) on the same
numpy inputs through the JAX function and the port on CPU tensors.
Table tier: the same mutation stream applied to the JAX ``NodeTable``
and the port's ``NodeTable(device="cpu")`` answers the same after every
batch, through the churn view, background compactions and their swaps;
``convert`` carries a pending churn state across.  Every output is an
integer array: the tolerance is exact equality.  Geometries follow
tests/test_table_churn.py and tests/test_topk.py:584-660.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import opendht_tpu.core.table as jax_table
import opendht_tpu_torch.core.table as port_table
from opendht_tpu.infohash import InfoHash as JaxHash
from opendht_tpu.ops import ids as JK
from opendht_tpu.ops import sorted_table as JS
from opendht_tpu_torch import convert, telemetry, tracing
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.ops import sorted_table as TS

from test_torch_fast2 import _pack_bits
from test_torch_ops import _eq, _keys, _rand_raw


# ------------------------------------------------------------ kernel tier

@pytest.mark.parametrize("n", [1000, 32, 31, 4096])
def test_unpack_tomb_bits_matches_jax(n):
    mask = np.random.default_rng(105 + n).random(n) < 0.3
    mask[-1] = True                               # bit 31 of a word: sign
    bits = _pack_bits(mask)
    got = TS.unpack_tomb_bits(TS.tomb_tensor(bits, "cpu"), n)
    _eq(JS.unpack_tomb_bits(jnp.asarray(bits), n), got)
    np.testing.assert_array_equal(got.numpy(), mask)


class _Churn:
    """One churn state on both backends: a sorted base with tombstones
    and a delta slab, as (jax, port) argument tuples of
    churn_lookup_topk."""

    def __init__(self, base_raw, dead, delta_u32, n_delta, *, valid=None,
                 base_stride=64, base_limbs=5, d_stride=32, d_limbs=5,
                 wide=False, luts=False):
        ids = JK.ids_from_bytes(base_raw) if base_raw.dtype == np.uint8 \
            else base_raw
        jv = None if valid is None else jnp.asarray(valid)
        tv = None if valid is None else torch.from_numpy(valid)
        js, _, jn = JS.sort_table(jnp.asarray(ids), jv)
        ts, _, tn = TS.sort_table(_keys(ids), tv)
        dvalid = np.arange(delta_u32.shape[0]) < n_delta
        jds, _, jdn = JS.sort_table(jnp.asarray(delta_u32),
                                    jnp.asarray(dvalid))
        tds, _, tdn = TS.sort_table(_keys(delta_u32),
                                    torch.from_numpy(dvalid))
        words = _pack_bits(dead)
        self.jax = (js, JS.expand_table(js, stride=base_stride,
                                        limbs=base_limbs), jn,
                    jnp.asarray(words), jds,
                    JS.expand_table(jds, stride=d_stride, limbs=d_limbs), jdn)
        self.port = (ts, TS.expand_table(ts, stride=base_stride,
                                         limbs=base_limbs), tn,
                     TS.tomb_tensor(words, "cpu"), tds,
                     TS.expand_table(tds, stride=d_stride, limbs=d_limbs),
                     tdn)
        self.jkw, self.tkw = {}, {}
        if wide:
            self.jkw["d_exp_wide"] = JS.expand_table(jds, stride=64,
                                                     limbs=d_limbs)
            self.tkw["d_exp_wide"] = TS.expand_table(tds, stride=64,
                                                     limbs=d_limbs)
        if luts:
            self.jkw.update(lut=JS.build_prefix_lut(js, jn),
                            d_lut=JS.build_prefix_lut(jds, jdn))
            self.tkw.update(lut=TS.build_prefix_lut(ts, tn),
                            d_lut=TS.build_prefix_lut(tds, tdn))
        self.sorted_np = np.asarray(js)
        self.delta_sorted_np = np.asarray(jds)
        self.live = ~dead & (np.arange(len(dead)) < int(jn))
        self.n_delta = n_delta

    def run(self, q_u32, **kw):
        jout = JS.churn_lookup_topk(*self.jax, jnp.asarray(q_u32),
                                    **self.jkw, **kw)
        tout = TS.churn_lookup_topk(*self.port, _keys(q_u32), **self.tkw,
                                    **kw)
        return jout, tout

    def launch(self, q_u32, **kw):
        return TS.churn_lookup_launch(*self.port, _keys(q_u32), **self.tkw,
                                      **kw)

    def oracle(self, q_u32, k):
        """Brute-force top-k over (live base ∪ delta) → (dist, id rows)."""
        cand = np.concatenate([self.sorted_np[self.live],
                               self.delta_sorted_np[:self.n_delta]])
        d = cand[None, :, :] ^ q_u32[:, None, :]
        order = [np.lexsort(tuple(d[i, :, l] for l in range(4, -1, -1)))[:k]
                 for i in range(len(q_u32))]
        # fewer than k live rows: all-ones padding, as the lookup gives
        pad = np.full((k, 5), 0xFFFFFFFF, np.uint32)
        return (np.stack([np.concatenate([d[i, o], pad])[:k]
                          for i, o in enumerate(order)]),
                [np.concatenate([cand[o], pad])[:k] for o in order])

    def ids_of(self, enc):
        N = self.sorted_np.shape[0]
        none = np.full(5, 0xFFFFFFFF, np.uint32)
        return [np.stack([none if e < 0 else self.sorted_np[e] if e < N
                          else self.delta_sorted_np[e - N] for e in row])
                for row in enc]


def _same(jout, tout, what=""):
    if jout[0] is None:
        assert tout[0] is None, what
    else:
        _eq(jout[0], tout[0], f"{what} dist")
    _eq(jout[1], tout[1], f"{what} idx")
    _eq(jout[2], tout[2], f"{what} cert")


def _merge_case(dens, seed=120):
    rng = np.random.default_rng(seed + int(dens * 100))
    valid = np.ones(2048, bool)
    valid[int(2048 * 0.9):] = False
    dead = rng.random(2048) < dens
    n_delta = 37 if dens < 0.5 else 5
    delta = np.zeros((64, 5), np.uint32)
    delta[:n_delta] = JK.ids_from_bytes(_rand_raw(n_delta, seed + 1))
    return dead, delta, n_delta, valid


@pytest.mark.parametrize("pack", [1, 2, 16])
@pytest.mark.parametrize("dens", [0.0, 0.1, 0.95, 1.0])
def test_packed_churn_merge_sweep_matches_jax(pack, dens):
    """pack widths × tombstone density × ragged Q (107) × fast3 / fast2,
    each against JAX, and fast3 against brute force."""
    dead, delta, n_delta, valid = _merge_case(dens)
    base_raw = _rand_raw(2048, 120)
    dead &= valid
    k = 16 if dens == 0.95 else 8
    q = JK.ids_from_bytes(_rand_raw(107, 121))
    c3 = _Churn(base_raw, dead, delta, n_delta, valid=valid)
    jout, tout = c3.run(q, k=k, merge_pack=pack)
    _same(jout, tout, ("fast3", pack, dens))
    d_o, ids_o = c3.oracle(q, k)
    np.testing.assert_array_equal(np.asarray(jout[0]), d_o)
    got_ids = c3.ids_of(tout[1].numpy())
    for a, b in zip(got_ids, ids_o):
        np.testing.assert_array_equal(a, b)
    c2 = _Churn(base_raw, dead, delta, n_delta, valid=valid, base_limbs=2,
                d_stride=16, d_limbs=2, wide=True)
    jout, tout = c2.run(q, k=k, merge_pack=pack, select="fast2", planes=2)
    _same(jout, tout, ("fast2", pack, dens))


def test_packed_churn_merge_budget_shape_matches_jax():
    """The perf_budgets.json packed_churn_merge shape (Q=256, k=8, nl=2,
    pack=16) on random planes, plus a ragged Q, directly."""
    rng = np.random.default_rng(14)
    for Q, pack in ((256, 16), (107, 16), (107, 3), (256, 1)):
        planes = [rng.integers(0, 2**32, size=(Q, 8), dtype=np.uint32)
                  for _ in range(4)]
        planes[0][:5] = planes[2][:5]               # base/delta top-64 ties
        planes[1][:5] = planes[3][:5]
        m_idx = rng.integers(-1, 4096, size=(Q, 8)).astype(np.int32)
        d_idx = rng.integers(-1, 512, size=(Q, 8)).astype(np.int32)
        jenc, jl = JS.packed_churn_merge(
            tuple(jnp.asarray(p) for p in planes[:2]), jnp.asarray(m_idx),
            tuple(jnp.asarray(p) for p in planes[2:]), jnp.asarray(d_idx),
            4096, k=8, nl=2, pack=pack)
        tenc, tl = TS.packed_churn_merge(
            tuple(_keys(p) for p in planes[:2]), torch.from_numpy(m_idx),
            tuple(_keys(p) for p in planes[2:]), torch.from_numpy(d_idx),
            4096, k=8, nl=2, pack=pack)
        _eq(jenc, tenc, (Q, pack))
        for a, b in zip(jl, tl):
            _eq(a, b, (Q, pack))


def test_merge_pack_rejects_invalid_width():
    c = _Churn(_rand_raw(256, 121), np.zeros(256, bool),
               np.zeros((64, 5), np.uint32), 0)
    q = JK.ids_from_bytes(_rand_raw(4, 122))
    for mod, args, qq in ((JS, c.jax, jnp.asarray(q)),
                          (TS, c.port, _keys(q))):
        with pytest.raises(ValueError, match="merge_pack"):
            mod.churn_lookup_topk(*args, qq, k=8, merge_pack=0)
    assert TS._resolve_merge_pack("auto", 8) == 1


def test_churn_lookup_empty_base_matches_jax():
    """Fresh node: an empty base, every peer in the delta slab."""
    ids = np.zeros((256, 5), np.uint32)
    delta = np.zeros((64, 5), np.uint32)
    delta[:17] = JK.ids_from_bytes(_rand_raw(17, 103))
    c = _Churn(ids, np.zeros(256, bool), delta, 17,
               valid=np.zeros(256, bool))
    q = JK.ids_from_bytes(_rand_raw(16, 104))
    jout, tout = c.run(q, k=8)
    _same(jout, tout, "empty base")
    assert (tout[1].numpy() >= 256).sum() == 16 * 8


@pytest.mark.parametrize("select", ["fast3", "fast2"])
def test_churn_lookup_tomb_heavy_fallback_matches_jax(select):
    """95 % tombstoned: nearly every base window decertifies and the
    base rescan (tombstones masked) gives the answer."""
    rng = np.random.default_rng(102)
    dead = rng.random(4096) < 0.95
    delta = np.zeros((64, 5), np.uint32)
    delta[:9] = JK.ids_from_bytes(_rand_raw(9, 106))
    two = select == "fast2"
    c = _Churn(_rand_raw(4096, 102), dead, delta, 9,
               base_limbs=2 if two else 5, d_limbs=2 if two else 5)
    q = JK.ids_from_bytes(_rand_raw(64, 107))
    kw = dict(k=8, select=select, planes=2 if two else 5)
    jout, tout = c.run(q, **kw)
    _same(jout, tout, select)
    flags = c.launch(q, **kw).flags
    assert int(((flags & 1) != 0).sum()) > 32      # the base rescan ran


def test_churn_lookup_narrow_delta_cascade_matches_jax():
    """Stride-16 narrow delta windows over a clustered delta: rows the
    narrow margin decertifies repair against the wide expansion, and
    more than d_cap=64 of them leave residual rows for the rescan."""
    rng = np.random.default_rng(81)
    dead = np.zeros(4096, bool)
    dead[rng.choice(4096, size=200, replace=False)] = True
    d_raw = _rand_raw(1024, 83, cluster=6)
    c = _Churn(_rand_raw(4096, 82), dead, JK.ids_from_bytes(d_raw), 1024,
               base_stride=32, base_limbs=2, d_stride=16, d_limbs=2,
               wide=True, luts=True)
    q = JK.ids_from_bytes(np.concatenate([_rand_raw(96, 84), d_raw[:32]]))
    kw = dict(k=8, select="fast2", lut_steps=0, planes=2, d_cap=64)
    jout, tout = c.run(q, **kw)
    _same(jout, tout, "cascade")
    assert int(((c.launch(q, **kw).flags & 2) != 0).sum()) > 0


def test_churn_lookup_forced_fast2_tie_repair_matches_jax():
    """Base and delta ids sharing their top 64 bits: the 64-bit merge
    ties across the two sides and the full-distance re-merge decides."""
    rng = np.random.default_rng(91)
    base = JK.ids_from_bytes(_rand_raw(4096, 92))
    delta = np.zeros((256, 5), np.uint32)
    delta[:200] = JK.ids_from_bytes(_rand_raw(200, 93))
    pick = rng.choice(4096, size=40, replace=False)
    delta[:40, :2] = base[pick, :2]                 # same top 64 bits
    q = base[pick].copy()
    q[:, 2:] = rng.integers(0, 2**32, size=(40, 3), dtype=np.uint32)
    q = np.concatenate([q, JK.ids_from_bytes(_rand_raw(24, 94))])
    c = _Churn(base, np.zeros(4096, bool), delta, 200, base_limbs=2,
               d_stride=16, d_limbs=2, wide=True)
    kw = dict(k=8, select="fast2", planes=2)
    jout, tout = c.run(q, **kw)
    _same(jout, tout, "tie repair")
    flags = c.launch(q, **kw).flags
    assert int(((flags & 4) != 0).sum()) >= 20      # the merge tied
    c3 = _Churn(base, np.zeros(4096, bool), delta, 200)
    assert torch.equal(tout[1], c3.run(q, k=8)[1][1])    # fast2 ≡ fast3


def test_churn_lookup_budget_shape_matches_jax():
    """perf_budgets.json churn_lookup_topk: N=4096, D=512, Q=256, k=8,
    fast3, merge_pack=16, with ~10 % tombstones, against brute force."""
    rng = np.random.default_rng(15)
    dead = rng.random(4096) < 0.10
    delta = JK.ids_from_bytes(_rand_raw(512, 16))
    c = _Churn(_rand_raw(4096, 17), dead, delta, 300, luts=True)
    q = JK.ids_from_bytes(_rand_raw(256, 18))
    jout, tout = c.run(q, k=8, merge_pack=16)
    _same(jout, tout, "budget shape")
    d_o, ids_o = c.oracle(q, 8)
    np.testing.assert_array_equal(np.asarray(jout[0]), d_o)
    for a, b in zip(c.ids_of(tout[1].numpy()), ids_o):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- table tier

def _hashes(raw, H):
    return [H(bytes(b)) for b in raw]


def _tables(seed, n, delta_cap, monkeypatch, tomb_min=None):
    """A JAX table and a port table with the same bulk-loaded slab and a
    'reachable' base built on both."""
    if tomb_min is not None:             # the limit is tomb_min itself
        for mod in (jax_table, port_table):
            monkeypatch.setattr(mod, "TOMB_MIN", tomb_min)
            monkeypatch.setattr(mod, "TOMB_FRAC", 1 << 30)
    me = _rand_raw(1, seed)[0].tobytes()
    jt = jax_table.NodeTable(JaxHash(me), k=1 << 20, capacity=1024,
                             delta_cap=delta_cap)
    pt = port_table.NodeTable(InfoHash(me), k=1 << 20, capacity=1024,
                              delta_cap=delta_cap, device="cpu")
    ids = JK.ids_from_bytes(_rand_raw(n, seed + 1))
    for t in (jt, pt):
        t.bulk_load(ids, now=1.0)
        t.snapshot(now=2.0)
    return jt, pt, ids


def _settle(jt):
    """Let the JAX table's background build finish, so both tables swap
    at the same view() (the port's CPU build is ready at once)."""
    if jt._pending_base is not None:
        jt._pending_base["n_valid"].block_until_ready()


def _same_answers(jt, pt, q, k=8, now=10.0):
    _settle(jt)
    want = jt.find_closest(q, k=k, now=now)
    got = pt.find_closest(q, k=k, now=now)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert pt.compactions == jt.compactions
    assert pt.churn_pending == jt.churn_pending
    assert (pt._pending_base is None) == (jt._pending_base is None)
    return got


def _batch(t, H, b, rng_seed, ids):
    """Batch ``b`` of the mutation stream (the same on both tables):
    bulk loads first (a bulk load that does not fit the delta rebuilds
    the view), then inserts, which may overflow the delta into a
    background compaction, then evictions, expiries, auth strikes and
    revivals."""
    rng = np.random.default_rng(rng_seed + b)
    fresh = _rand_raw(40, rng_seed + 100 + b)
    live = np.nonzero(t._valid & ~t._expired)[0]
    exp_rows = np.nonzero(t._valid & t._expired)[0]
    pick = rng.choice(live, size=30, replace=False)
    t.bulk_load(JK.ids_from_bytes(fresh[20:]), now=7.0 + b)
    if len(exp_rows) > 5:
        t.bulk_load(t._ids[exp_rows[5:8]], now=7.5 + b)   # bulk revival
    for i, raw in enumerate(fresh[:20]):
        t.insert(H(bytes(raw)), ("10.0.0.1", 4000 + i), 5.0 + b, confirm=2)
    for r in pick[:10]:
        t.remove(t.id_of(int(r)))
    for r in pick[10:20]:
        t.on_expired(t.id_of(int(r)))
    for r in pick[20:24]:
        for _ in range(3):
            t.on_auth_error(t.id_of(int(r)))
    for r in exp_rows[:5]:                           # revivals
        t.insert(t.id_of(int(r)), None, 6.0 + b, confirm=2)
    if b == 3:
        t.clear_bad()


@pytest.mark.parametrize("delta_cap,tomb_min", [(4096, None), (4096, 48),
                                                (32, 1 << 20)])
def test_mutation_stream_matches_jax(delta_cap, tomb_min, monkeypatch):
    """Six batches of bulk loads, inserts, removes, expiries, auth
    strikes, revivals and a clear_bad: the churn view answers like the
    JAX table after every batch — past the tombstone limit (48) and
    through delta overflow (cap 32), with background compactions
    dispatched, pending while mutations land, and swapped."""
    jt, pt, ids = _tables(5, 6000, delta_cap, monkeypatch, tomb_min)
    q = np.concatenate([JK.ids_from_bytes(_rand_raw(88, 60)), ids[:8]])
    q[:8, 4] ^= 1
    pending_seen = 0
    for b in range(6):
        _batch(jt, JaxHash, b, 7, ids)
        _batch(pt, InfoHash, b, 7, ids)
        pending_seen += pt._pending_base is not None
        assert (pt._pending_base is None) == (jt._pending_base is None)
        _same_answers(jt, pt, q)
        assert isinstance(pt.view(10.0), port_table.ChurnView) \
            == isinstance(jt.view(10.0), jax_table.ChurnView)
    if tomb_min is not None:
        assert pt.compactions >= 1 and pending_seen >= 1
    pt.snapshot(now=11.0)                            # forced compaction
    jt.snapshot(now=11.0)
    assert pt.churn_pending == 0
    _same_answers(jt, pt, q)


def test_revival_returned_once_matches_jax(monkeypatch):
    jt, pt, ids = _tables(8, 5000, 64, monkeypatch)
    raw0 = JK.ids_to_bytes(ids[0]).tobytes()
    for t, H in ((jt, JaxHash), (pt, InfoHash)):
        t.on_expired(H(raw0))
        t.insert(H(raw0), None, now=3.0, confirm=2)
    q = np.repeat(ids[:1], 80, axis=0)
    rows, _ = _same_answers(jt, pt, q, k=20)
    got = [pt._ids[r].tobytes() for r in rows[0]]
    assert got.count(ids[0].tobytes()) == 1 and len(set(got)) == 20


def test_replay_overflow_counts_one_compaction_matches_jax(monkeypatch):
    jt, pt, ids = _tables(53, 5000, 4, monkeypatch)
    late = _rand_raw(11, 540)
    for t, H in ((jt, JaxHash), (pt, InfoHash)):
        for raw in late[:5]:                  # the 5th overflows cap 4
            t.insert(H(bytes(raw)), None, now=3.0, confirm=2)
        assert t._pending_base is not None
        for raw in late[5:]:                  # more than a fresh slab holds
            t.insert(H(bytes(raw)), None, now=4.0, confirm=2)
    c0 = pt.compactions
    q = np.concatenate([JK.ids_from_bytes(late), ids[:70]])
    rows, dist = _same_answers(jt, pt, q, k=1)
    assert pt.compactions == c0 + 1           # one swap, no double count
    assert (dist[:11] == 0).all()             # every late insert found


def test_bulk_load_during_pending_compaction_matches_jax(monkeypatch):
    jt, pt, ids = _tables(41, 5000, 128, monkeypatch, tomb_min=16)
    fresh = JK.ids_from_bytes(_rand_raw(12, 420))
    for t in (jt, pt):
        for r in np.nonzero(t._valid)[0][:20]:
            t.on_expired(t.id_of(int(r)))     # crosses the patched limit
        assert t._pending_base is not None
        t.bulk_load(fresh, now=3.0)           # lands while pending
        assert any(op == "i" for op, _ in t._pending_base["mutlog"])
    q = np.concatenate([fresh, ids[100:170]])
    rows, dist = _same_answers(jt, pt, q, k=1)
    assert pt._pending_base is None and (dist[:12] == 0).all()


def test_swap_telemetry_and_flight_event(monkeypatch):
    """The swap books dht_table_compactions_total and a table_churn_swap
    event; churn lookups feed their counters, gauges and histogram."""
    reg = telemetry.get_registry()
    tr = tracing.get_tracer()
    before = reg.snapshot()
    n_ev = len(tr.events(name="table_churn_swap"))
    _, pt, ids = _tables(61, 5000, 8, monkeypatch)
    for raw in _rand_raw(9, 620):
        pt.insert(InfoHash(bytes(raw)), None, now=3.0, confirm=2)
    assert pt._pending_base is not None
    pt.find_closest(ids[:80], now=4.0)        # swaps, then looks up
    pt.insert(InfoHash(bytes(_rand_raw(1, 630)[0])), None, now=5.0,
              confirm=2)
    assert isinstance(pt.view(6.0), port_table.ChurnView)
    pt.find_closest(ids[:80], now=6.0)
    diff = telemetry.snapshot_diff(before, reg.snapshot())
    text = repr(diff)
    for name in ("dht_table_compactions_total", "dht_churn_lookups_total",
                 "dht_churn_lookup_seconds"):
        assert name in text, name
    assert reg.gauge("dht_churn_delta_rows").value == pt._churn.n_delta
    evs = tr.events(name="table_churn_swap")
    assert len(evs) == n_ev + 1
    assert evs[-1]["attrs"]["compactions"] == pt.compactions


def test_convert_carries_churn_state_matches_jax(monkeypatch):
    """A JAX table with pending tombstones and delta rows, carried across
    with its base snapshot and churn view, answers the same — and keeps
    answering the same under further mutations."""
    jt, _, ids = _tables(71, 6000, 256, monkeypatch)
    for b in range(2):
        _batch(jt, JaxHash, b, 72, ids)
    assert jt.churn_pending > 0 and jt._pending_base is None
    ch, snap = jt._churn, jt._snap
    state = {"ids": jt._ids, "valid": jt._valid, "expired": jt._expired,
             "time_reply": jt._time_reply, "time_seen": jt._time_seen,
             "auth_err": jt._auth_err, "bucket": jt._bucket,
             "bucket_count": jt._bucket_count, "free": list(jt._free),
             "compactions": jt.compactions}
    churn = {"sorted_ids": np.asarray(snap.sorted_ids),
             "perm": np.asarray(snap.perm), "n_valid": int(snap.n_valid),
             "tomb_np": ch.tomb_np, "delta_ids_np": ch.delta_ids_np,
             "delta_rows": ch.delta_rows, "n_delta": ch.n_delta}
    pt = convert.node_table_from_numpy(bytes(jt.self_id), state,
                                       addrs=jt._addrs, device="cpu",
                                       k=jt.k, delta_cap=256, churn=churn)
    pt._cached = dict(jt._cached)
    assert pt.churn_pending == jt.churn_pending
    assert isinstance(pt.view(10.0), port_table.ChurnView)
    q = np.concatenate([JK.ids_from_bytes(_rand_raw(90, 73)), ids[:6]])
    _same_answers(jt, pt, q)
    for b in range(2, 4):
        _batch(jt, JaxHash, b, 72, ids)
        _batch(pt, InfoHash, b, 72, ids)
        _same_answers(jt, pt, q)
