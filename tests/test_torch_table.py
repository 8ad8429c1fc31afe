"""The port's NodeTable against the JAX package's, answer for answer.

Both tables go through the same insert / bulk_load / on_reply /
on_expired / on_auth_error / remove sequence (numpy-seeded ids), and a
third table is carried across with ``convert.node_table_from_numpy``
from the JAX slab.  ``find_closest`` and ``find_closest_launch().consume()``
must give identical (rows, dist) in the host-scan regime (≤ 4096 rows,
≤ 64 targets) and in the device regime (more rows, more targets), where
the port runs its snapshot lookup on CPU tensors.  Exact equality.
"""

import numpy as np
import pytest
import torch

from opendht_tpu.core.table import NodeTable as JaxTable
from opendht_tpu.infohash import InfoHash as JaxHash
from opendht_tpu_torch import convert
from opendht_tpu_torch.core.table import NodeTable, PendingLookup
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.ops import ids as TK
from opendht_tpu_torch.ops.sorted_table import lookup_topk


def _raw(n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(n, 20),
                                                dtype=np.uint8)


def _state(t):
    return {"ids": t._ids, "valid": t._valid, "expired": t._expired,
            "time_reply": t._time_reply, "time_seen": t._time_seen,
            "auth_err": t._auth_err, "bucket": t._bucket,
            "bucket_count": t._bucket_count}


def _same_answers(tables, targets, k):
    jt = tables[0]
    want_r, want_d = jt.find_closest(targets, k=k, now=100.0)
    for t in tables[1:]:
        for got in (t.find_closest(targets, k=k, now=100.0),
                    t.find_closest_launch(targets, k=k, now=100.0).consume()):
            np.testing.assert_array_equal(got[0], want_r)
            np.testing.assert_array_equal(got[1], want_d)
    return want_r


def _mutate(tables, raw, now=50.0):
    """One protocol-style mutation sequence applied to every table."""
    for i, b in enumerate(raw):
        for t, H in tables:
            t.insert(H(bytes(b)), ("10.0.0.1", 4000 + i), now,
                     confirm=i % 3)
    for b in raw[::5]:
        for t, H in tables:
            t.on_reply(H(bytes(b)), now + 1)
    for b in raw[1::7]:
        for t, H in tables:
            t.on_expired(H(bytes(b)))
    for b in raw[2::11]:
        for t, H in tables:
            for _ in range(3):
                t.on_auth_error(H(bytes(b)))
    for b in raw[3::13]:
        for t, H in tables:
            t.remove(H(bytes(b)))


def test_host_scan_regime_matches_jax():
    me = _raw(1, 1)[0].tobytes()
    jt = JaxTable(JaxHash(me))
    pt = NodeTable(InfoHash(me), device="cpu")
    raw = _raw(400, 2)
    raw[200:260, :2] = np.frombuffer(me[:2], np.uint8)   # deep buckets
    _mutate([(jt, JaxHash), (pt, InfoHash)], raw)
    assert len(jt) == len(pt) and len(pt) <= 4096
    ct = convert.node_table_from_numpy(me, _state(jt), addrs=jt._addrs,
                                       device="cpu")
    targets = TK.ids_from_bytes(_raw(48, 3))
    rows = _same_answers([jt, pt, ct], targets, k=8)
    assert (rows >= 0).all()
    assert pt.find_closest_launch(targets, k=8).ready()
    for r in rows[0]:
        assert pt.id_of(int(r)) == InfoHash(bytes(jt.id_of(int(r))))
        assert pt.addr_of(int(r)) == jt.addr_of(int(r))
        assert ct.row_of(pt.id_of(int(r))) == int(r)
    assert pt.ids_of_rows(np.array([-1, rows[0, 0]]))[0] is None


@pytest.mark.parametrize("k", [8, 16])
def test_device_regime_matches_jax(k):
    me = _raw(1, 4)[0].tobytes()
    jt = JaxTable(JaxHash(me))
    pt = NodeTable(InfoHash(me), device="cpu")
    ids = TK.ids_from_bytes(_raw(6000, 5))
    ids[100:110] = ids[5]                     # batch-internal duplicates
    ids[3000:3400, :2] = ids[3000, :2]        # a clustered region
    for t in (jt, pt):
        t.bulk_load(ids, now=10.0)
    extra = _raw(40, 6)
    _mutate([(jt, JaxHash), (pt, InfoHash)], extra)
    for t in (jt, pt):
        for r in (7, 3001, 3002, 4500):
            t.on_expired(t.id_of(r))
        t.bulk_load(ids[:50], now=20.0)       # revives the expired row 7
    assert len(jt) == len(pt) > 4096
    ct = convert.node_table_from_numpy(me, _state(jt), device="cpu")
    targets = TK.ids_from_bytes(_raw(96, 7))
    targets[:8] = ids[3000:3008]
    targets[:8, 4] ^= 1
    targets[8:12] = ids[3001:3005]            # an expired id among them
    rows = _same_answers([jt, pt, ct], targets, k=k)
    assert (rows >= 0).all()
    # the snapshot lookup really ran the fallback for some rows
    snap = pt.snapshot(now=100.0)
    _, _, cert = lookup_topk(snap.sorted_ids, snap.n_valid,
                             TK.to_keys(targets, "cpu"), k=k,
                             expanded=snap._expanded, fallback=False)
    assert not cert.all()


def test_snapshot_from_numpy_answers_like_the_jax_snapshot():
    me = _raw(1, 8)[0].tobytes()
    jt = JaxTable(JaxHash(me))
    jt.bulk_load(TK.ids_from_bytes(_raw(5000, 9)), now=1.0)
    js = jt.snapshot(now=2.0)
    ps = convert.snapshot_from_numpy(np.asarray(js.sorted_ids),
                                     np.asarray(js.perm), int(js.n_valid),
                                     device="cpu")
    q = TK.ids_from_bytes(_raw(80, 10))
    want = js.lookup(q, k=8)
    got = ps.lookup(q, k=8)
    pending = ps.lookup_launch(q, k=8)
    assert isinstance(pending, PendingLookup) and pending.ready()
    for a, b in ((want, got), (want, pending.consume())):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert torch.equal(ps.perm, torch.from_numpy(np.array(js.perm)))
