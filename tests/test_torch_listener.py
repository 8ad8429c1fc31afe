"""The port's listener table (``opendht_tpu_torch/listeners.py`` and
``ops/listener_match.py``) against the JAX package's, and batched
delivery on a port node against the JAX node and against
``listen_batching="off"``.

- ``listener_match`` on the CPU, bit-identical to the JAX function and
  to the numpy mirror ``match_host``, at the budget shape
  (``perf_budgets.json`` ``kernels.listener_match``: S=64, L=1,024) and
  at edge cases: tombstoned rows, duplicate stored keys, an all-invalid
  table, ids with the top bit set, a duplicate row behind a tombstone.
- ``ListenerTable``, step by step against the JAX class on one clock: a
  seeded stream of listener syncs (inserts, tombstones, compaction,
  overflow past capacity and its promotion), buffered stored puts,
  flushes, TTL sweeps against a live-count oracle and frame ticks; the
  same flushed deliveries, host mirror, slots and snapshot after every
  step; the go-dark contract (the whole buffer handed back).
- Twin nodes at the defaults (``tests/test_torch_hotcache.TwinNode``):
  local and remote listeners, a capacity that overflows, cancels that
  tombstone and waves of stored puts — the same deliveries at the same
  virtual times and the same datagrams (tell_listener pushes included)
  on the JAX and the port node; and on the port node, per listener, the
  same values in the same order as with ``listen_batching="off"``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from opendht_tpu.listeners import ListenerTable as JTable
from opendht_tpu.listeners import ListenerTableConfig as JCfg
from opendht_tpu.ops import listener_match as JLM
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.listeners import ListenerTable, ListenerTableConfig
from opendht_tpu_torch.ops import ids as IK
from opendht_tpu_torch.ops import listener_match as PLM

from test_torch_hotcache import (JAX, PORT, TwinNode, client_requests,
                                 fresh_registries)

CPU = "cpu"


# ------------------------------------------------------------ the match
def match_inputs(seed: int, s: int, l: int):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2 ** 32, size=(l, 5), dtype=np.uint32)
    table[::5, 0] |= np.uint32(0x80000000)
    valid = rng.random(l) < 0.8
    if l >= 8:
        table[6] = table[2]
        valid[2], valid[6] = False, True        # tombstone, then the copy
    stored = rng.integers(0, 2 ** 32, size=(s, 5), dtype=np.uint32)
    stored[: s // 2] = table[rng.integers(0, l, size=s // 2)]
    if s >= 4:
        stored[3] = stored[0]
    return table, valid, stored


@pytest.mark.parametrize("s,l", [(64, 1024), (1, 1024), (64, 1), (100, 9)])
@pytest.mark.parametrize("valid_kind", ["mixed", "none"])
def test_listener_match_equals_jax_and_numpy(s, l, valid_kind):
    table, valid, stored = match_inputs(s * 7 + l, s, l)
    if valid_kind == "none":
        valid[:] = False
    want = [np.asarray(x) for x in JLM.listener_match(table, valid, stored)]
    host = PLM.match_host(table, valid, stored)
    got = PLM.listener_match(IK.to_keys(table, CPU),
                             torch.from_numpy(valid), stored)
    for w, h, g in zip(want, host, got):
        assert np.array_equal(g.numpy(), w) and np.array_equal(h, w)
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32


# ------------------------------------------------------------ the table
class _TwinTables:
    def __init__(self, **cfg):
        self.now = {"t": 0.0}
        self.live: dict = {}
        self.armed = {"jax": [], "port": []}
        clock = lambda: self.now["t"]               # noqa: E731
        self.j = JTable(JCfg(**cfg), live_count=self.live.get, clock=clock,
                        request_flush=self.armed["jax"].append)
        self.p = ListenerTable(ListenerTableConfig(**cfg),
                               live_count=self.live.get, clock=clock,
                               request_flush=self.armed["port"].append,
                               device=CPU)

    def same(self):
        assert self.p.snapshot() == self.j.snapshot()
        assert np.array_equal(self.p._ids, self.j._ids)
        assert np.array_equal(self.p._valid, self.j._valid)
        assert self.p._slot_of == self.j._slot_of
        assert self.p._overflow == self.j._overflow
        assert self.p._expires == self.j._expires
        assert (self.p._top, self.p._tombstones) == \
            (self.j._top, self.j._tombstones)
        assert self.p.lag_p95() == self.j.lag_p95()
        assert self.armed["port"] == self.armed["jax"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_table_matches_jax_step_by_step(monkeypatch, seed):
    fresh_registries(monkeypatch)
    t = _TwinTables(capacity=16, compact_min=4, entry_ttl=3.0,
                    buffer_max=12)
    keys = [bytes(InfoHash.get(f"lt-{seed}-{i}")) for i in range(40)]
    rng = np.random.default_rng(seed)
    for step in range(120):
        t.now["t"] += float(rng.random() * 0.4)
        op = rng.random()
        kb = keys[int(rng.integers(0, len(keys)))]
        if op < 0.35:
            n = int(rng.integers(0, 3))
            t.live[kb] = n
            t.j.sync_key(kb, n)
            t.p.sync_key(kb, n)
        elif op < 0.75:
            item = (step, bool(rng.random() < 0.8))
            assert t.p.note_stored(kb, *item) == t.j.note_stored(kb, *item)
        elif op < 0.95:
            assert t.p.flush() == t.j.flush()
        else:
            t.j.frame_tick()
            t.p.frame_tick()
        t.same()
    assert t.p.flush() == t.j.flush()
    t.same()
    snap = t.p.snapshot()
    assert snap["compactions"] > 0 and snap["matches"] > 0


def test_overflow_promotes_when_a_slot_frees(monkeypatch):
    fresh_registries(monkeypatch)
    t = _TwinTables(capacity=4, compact_min=1)
    keys = [bytes(InfoHash.get(f"lt-of-{i}")) for i in range(7)]
    for kb in keys:
        t.j.sync_key(kb, 1)
        t.p.sync_key(kb, 1)
    t.same()
    assert len(t.p._overflow) == 3
    for kb in keys[:2]:
        t.j.sync_key(kb, 0)
        t.p.sync_key(kb, 0)
        t.same()
    for kb in keys:
        t.j.note_stored(kb, kb[:2], True)
        t.p.note_stored(kb, kb[:2], True)
    assert t.p.flush() == t.j.flush()
    t.same()


def test_go_dark_hands_the_whole_buffer_back(monkeypatch):
    fresh_registries(monkeypatch)
    t = _TwinTables()
    kb = bytes(InfoHash.get("lt-dark"))
    other = bytes(InfoHash.get("lt-dark-other"))
    for table in (t.j, t.p):
        table.sync_key(kb, 1)
        table.note_stored(kb, "v1", True)
        table.note_stored(other, "v2", True)

    def boom(*a, **kw):
        raise RuntimeError("device lost")
    import opendht_tpu_torch.listeners as PL
    monkeypatch.setattr(PL, "listener_match", boom)
    monkeypatch.setattr(JLM, "listener_match", boom)
    assert t.p.flush() == t.j.flush() == [(kb, [("v1", True)]),
                                           (other, [("v2", True)])]
    assert not t.p.enabled and not t.j.enabled
    assert t.p.snapshot() == t.j.snapshot()
    assert t.p.note_stored(kb, "v3", True) is False


def test_the_table_lives_on_the_node_device_and_dark_without_it(
        monkeypatch):
    fresh_registries(monkeypatch)
    kb = bytes(InfoHash.get("lt-dev"))
    p = ListenerTable(device=CPU, clock=lambda: 0.0)
    p.sync_key(kb, 1)
    p.note_stored(kb, "v", True)
    assert p.flush() == [(kb, [("v", True)])]
    assert p._ids_dev.device.type == "cpu" and p._ids_dev.shape == (1024, 5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dark = ListenerTable(device=None, clock=lambda: 0.0)
    dark.sync_key(kb, 1)
    dark.note_stored(kb, "v", True)
    assert dark.flush() == [(kb, [("v", True)])]     # late, never lost
    assert not dark.enabled


# ------------------------------------------------- twin nodes, on and off
def run_listen_scenario(node: TwinNode) -> dict:
    """12 keys listened locally and 4 by a remote client (capacity 8:
    the rest overflow), then 6 waves of 16 stored puts over listened
    and unlistened keys (repeats within a wave), with two cancels and a
    re-listen between waves, each wave 20 virtual ms after the last."""
    dht, M = node.dht, node.M
    rng = np.random.default_rng(4)
    keys = [InfoHash.get(f"ln-twin-{i}").__bytes__() for i in range(24)]
    heard: dict = {}
    tokens = {}

    def listener(i):
        return lambda vals, exp: heard.setdefault(i, []).append(
            (node.clock["t"], exp, [(v.id, bytes(v.data)) for v in vals]))
    for i in range(12):
        tokens[i] = dht.listen(node.key(keys[i]), listener(i))
    token = dht._make_token(M["SockAddr"]("10.0.0.5", 4000), False)
    for raw in client_requests(lambda ceng, peer, JM: [
            ceng.send_listen(peer(dht.myid), JM["InfoHash"](keys[12 + i]),
                             JM["Query"](), token, None,
                             socket_cb=lambda *a: None)
            for i in range(4)]):
        node.feed(raw)
    t = 0.05
    node.advance(t)
    vid = 0
    for wave in range(6):
        for _ in range(16):
            k = keys[int(rng.integers(0, 20))]
            vid += 1
            dht.storage_store(node.key(k), M["Value"](
                b"w%d-%d" % (wave, vid), value_id=vid), node.clock["t"])
        if wave == 2:
            dht.cancel_listen(node.key(keys[0]), tokens[0])
            dht.cancel_listen(node.key(keys[5]), tokens[5])
        if wave == 4:
            tokens[0] = dht.listen(node.key(keys[0]), listener(0))
        t += 0.02
        node.advance(t)
    node.advance(t + 0.5)
    return {"heard": heard, "sent": node.sent, "token": token,
            "table": dht.listener_table.snapshot()}


def _values_only(heard: dict) -> dict:
    """Per listener, the delivered values in order (times and the
    batching's coalescing left out)."""
    return {i: [v for _t, exp, vals in calls for v in vals if not exp]
            for i, calls in heard.items()}


def test_twin_nodes_deliver_listen_waves_alike(monkeypatch):
    from opendht_tpu.listeners import ListenerTableConfig as JC
    sweeps = []
    want = run_listen_scenario(TwinNode(JAX, monkeypatch, sweeps,
                                        "ln-twin", listeners=JC(capacity=8)))
    got = run_listen_scenario(TwinNode(
        PORT, monkeypatch, sweeps, "ln-twin",
        listeners=ListenerTableConfig(capacity=8)))
    assert not sweeps
    assert got["token"] == want["token"]
    assert want["table"]["overflow"] > 0 and want["table"]["matches"] > 0
    assert got["heard"] == want["heard"] and len(want["heard"]) == 12
    assert got["table"] == want["table"]
    assert got["sent"] == want["sent"]


def test_batched_delivery_keeps_each_listeners_order(monkeypatch):
    """On the port node, listen_batching="on" and "off" deliver the same
    values to each listener in the same order (on coalesces them per
    wave)."""
    on = run_listen_scenario(TwinNode(PORT, monkeypatch, None, "ln-order",
                                      listeners=ListenerTableConfig(
                                          capacity=8)))
    off = run_listen_scenario(TwinNode(PORT, monkeypatch, None, "ln-order",
                                       listen_batching="off"))
    assert _values_only(on["heard"]) == _values_only(off["heard"])
    calls_on = sum(len(c) for c in on["heard"].values())
    calls_off = sum(len(c) for c in off["heard"].values())
    assert calls_on < calls_off
    assert off["table"] == {"enabled": False, "batching": "off"}
