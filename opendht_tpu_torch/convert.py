"""Carry node state across from the JAX package.

The JAX ``NodeTable`` keeps its slab as numpy columns, its snapshot as
device arrays and its churn view as numpy; a caller hands those over as
numpy (``tbl._ids``, ``np.asarray(snap.sorted_ids)``, ``view.tomb_np``
…) and gets the port's objects with the same contents.
:func:`dht_from_jax` carries a whole serving node: its tables, its
value store and its planes' state; :func:`secure_dht_from_jax` a node with its crypto overlay,
and :func:`identity_from_jax` a key and certificate (through DER);
:func:`proxy_server_from_jax` a REST proxy's permanent puts and push
listeners; :func:`stores_from_jax` a cluster's stored values, runner by
runner.  Nothing here imports the JAX package: the JAX objects are read
through their attributes and methods.
"""

from __future__ import annotations

import base64
import socket

import numpy as np
import torch

from ._device import resolve_device
from .core.table import DELTA_CAP, TARGET_NODES, ChurnView, NodeTable, \
    Snapshot, _stored_addr
from .infohash import InfoHash
from .ops import ids as IK
from .sockaddr import SockAddr
from .utils import lazy_module

# the crypto layer imports ``cryptography`` / ``argon2``: loaded at first use
crypto = lazy_module("opendht_tpu_torch.crypto")

SLAB_COLUMNS = ("ids", "valid", "expired", "time_reply", "time_seen",
                "auth_err", "bucket")


def node_table_from_numpy(self_id: bytes, state: dict, addrs=None,
                          device=None, *, k: int = TARGET_NODES,
                          delta_cap: int = DELTA_CAP, churn=None
                          ) -> NodeTable:
    """A port ``NodeTable`` holding the slab ``state``: the columns
    ``ids``, ``valid``, ``expired``, ``time_reply``, ``time_seen``,
    ``auth_err``, ``bucket`` (one row each) and ``bucket_count`` [160];
    optionally ``free`` (the free list, handed out from its end) and
    ``compactions``.  ``addrs``: one address per row, or None.

    ``row_of`` is rebuilt from the valid rows, and without ``free`` the
    free list from the others (lowest row handed out first); rows keep
    their numbers, so ``find_closest`` answers with the same rows.
    ``churn`` (see :func:`churn_view_from_numpy`) installs the JAX
    table's base snapshot and churn view, so pending tombstones and
    delta rows carry across.  Bucket replacement candidates are not
    carried.
    """
    cap = int(np.asarray(state["ids"]).shape[0])
    t = NodeTable(InfoHash(self_id), k=k, capacity=cap, delta_cap=delta_cap,
                  device=device)
    for name in SLAB_COLUMNS:
        col = getattr(t, "_" + name)
        col[...] = np.asarray(state[name], dtype=col.dtype)
    t._bucket_count[...] = np.asarray(state["bucket_count"], np.int32)
    if addrs is not None:
        if len(addrs) != cap:
            raise ValueError(f"addrs has {len(addrs)} entries for {cap} rows")
        t._addrs = [_stored_addr(a) for a in addrs]
    rows = np.nonzero(t._valid)[0]
    raw = IK.ids_to_bytes(t._ids[rows])
    t._row_of = {raw[i].tobytes(): int(r) for i, r in enumerate(rows)}
    t._free = ([int(r) for r in state["free"]] if "free" in state
               else [int(r) for r in np.nonzero(~t._valid)[0][::-1]])
    t.compactions = int(state.get("compactions", 0))
    if churn is not None:
        t._snap = snapshot_from_numpy(churn["sorted_ids"], churn["perm"],
                                      churn["n_valid"], device=t.device)
        t._churn = churn_view_from_numpy(t._snap, cap, churn)
    return t


def churn_view_from_numpy(base: Snapshot, cap_rows: int,
                          churn: dict) -> ChurnView:
    """A port ``ChurnView`` over ``base`` with the JAX view's pending
    churn: ``tomb_np`` (packed uint32 tombstone words), ``delta_ids_np``
    [D,5] uint32, ``delta_rows`` [D] and ``n_delta`` (slots prefix-dense,
    ``D`` the slab's current capacity)."""
    delta_ids = np.asarray(churn["delta_ids_np"], np.uint32)
    view = ChurnView(base, cap_rows, delta_cap=delta_ids.shape[0])
    view.tomb_np[...] = np.asarray(churn["tomb_np"], np.uint32)
    view.tomb_count = int(np.unpackbits(view.tomb_np.view(np.uint8)).sum())
    view.delta_ids_np[...] = delta_ids
    view.delta_rows[...] = np.asarray(churn["delta_rows"], np.int64)
    view.n_delta = int(churn["n_delta"])
    view._delta_pos = {int(view.delta_rows[s]): s
                       for s in range(view.n_delta)}
    return view


def snapshot_from_numpy(sorted_ids, perm, n_valid, device=None) -> Snapshot:
    """A port ``Snapshot`` of a sorted table: ``sorted_ids`` uint32
    [N,5], ``perm`` int32 [N] sorted→slab row (-1 past ``n_valid``)."""
    dev = resolve_device(device)
    return Snapshot(IK.to_keys(sorted_ids, dev),
                    torch.from_numpy(np.asarray(perm, np.int32).copy()).to(dev),
                    int(n_valid), version=0, mask_key=("reachable", 0))


#: the scalar ``Config`` fields a carried node keeps
_CONFIG_FIELDS = ("network", "is_bootstrap", "maintain_storage",
                  "storage_limit", "max_req_per_sec", "ingest_batching",
                  "ingest_fill_target", "ingest_deadline",
                  "ingest_queue_max", "ingest_admit_per_sec",
                  "ingest_pipeline_depth", "chaos_enabled",
                  "listen_batching", "resolve_mesh_t")
#: the planes' config objects, rebuilt field by field as the port's
_PLANE_CONFIGS = ("keyspace", "cache", "listeners", "reshard")


def _addr(a):
    """A JAX ``SockAddr`` (or None) as the port's."""
    return None if a is None else SockAddr(a.host, a.port)


def dht_from_jax(src, send_fn, scheduler=None, *, device=None):
    """A port ``Dht`` carrying a JAX ``Dht``'s state: its id and scalar
    config, one table per address family (every slab row with its
    liveness columns and address, through :func:`node_table_from_numpy`),
    its write-token secrets (tokens the JAX node handed out stay valid),
    and every stored value (re-stored from its packed bytes with its
    creation time), then the planes' state (:func:`carry_planes`), and
    ``resolve_mesh_t``.  Left behind: bucket replacement candidates,
    searches, listeners and per-IP quota buckets.  ``scheduler`` should share
    ``src``'s clock, since the stored values' times and the planes'
    deadlines are on it."""
    import dataclasses
    from .core.value import Value
    from .runtime import Config, Dht
    cfg = Config(node_id=InfoHash(bytes(src.myid)),
                 **{f: getattr(src.config, f) for f in _CONFIG_FIELDS})
    for f in _PLANE_CONFIGS:
        setattr(cfg, f, type(getattr(cfg, f))(
            **dataclasses.asdict(getattr(src.config, f))))
    afs = set(src.tables)
    dst = Dht(send_fn, cfg, scheduler, has_v4=socket.AF_INET in afs,
              has_v6=socket.AF_INET6 in afs, device=device)
    for af, t in src.tables.items():
        state = {name: getattr(t, "_" + name) for name in SLAB_COLUMNS}
        state["bucket_count"] = t._bucket_count
        state["free"] = list(t._free)
        dst.tables[af] = node_table_from_numpy(
            bytes(src.myid), state, [_addr(a) for a in t._addrs],
            device=device, k=t.k)
    dst._secret, dst._oldsecret = src._secret, src._oldsecret
    for key, st in src.store.items():
        for vs in st.values:
            dst.storage_store(InfoHash(bytes(key)),
                              Value.from_packed(vs.data.get_packed()),
                              vs.created)
    carry_planes(src, dst)
    return dst


def _values(vals) -> list:
    """JAX ``Value`` objects as the port's (through their packed bytes)."""
    from .core.value import Value
    return [Value.from_packed(v.get_packed()) for v in vals]


def _rearm(src_job, dst, dst_job):
    """``dst_job`` moved to ``src_job``'s time on ``dst``'s scheduler."""
    if src_job is None or dst_job is None or src_job.time is None:
        return dst_job
    return dst.scheduler.edit(dst_job, src_job.time)


def carry_planes(src, dst) -> None:
    """Overwrite ``dst``'s (a port ``Dht``) planes with the state of
    ``src``'s (a JAX ``Dht``), read as numpy and host objects: the
    keyspace observatory's sketch, histogram, candidates, published top
    and hot set, pending stored keys and window totals; the hot-value
    cache's entries (values re-packed), id table with its valid mask
    and slots, hot set, freshness tokens and hit window; the listener
    table's rows, valid mask, slots, TTLs, tombstones, overflow and
    delivery buffer; the resharder's layout (generation, edges,
    ``bin_loads``), sustain latch, last swap and counters.  Each plane's
    tick or flush job is moved to the JAX job's time.  Run after the
    value store is restored (storing feeds the planes)."""
    dev = dst.device
    ks, jks = dst.keyspace, src.keyspace
    if jks._sketch is not None:
        ks._sketch = torch.from_numpy(np.asarray(jks._sketch, np.int32)
                                      .copy()).to(dev)
        ks._hist = torch.from_numpy(np.asarray(jks._hist, np.int32)
                                    .copy()).to(dev)
    for name in ("_device_ok", "_sample_phase", "_observed_total",
                 "_window_total", "_window_published", "_since_tick",
                 "_shard_t", "_shard_virtual", "_imbalance"):
        setattr(ks, name, getattr(jks, name))
    ks._pending_store = list(jks._pending_store)
    ks._candidates = dict(jks._candidates)
    ks._top = [dict(t) for t in jks._top]
    ks._hot = set(jks._hot)
    ks._loads = list(jks._loads)
    ks._hist_host = np.array(jks._hist_host, np.int64)
    ks._job = _rearm(jks._job, dst, ks._job)

    hc, jhc = dst.hotcache, src.hotcache
    from .hotcache import _Entry
    hc._entries = {}
    for kb, e in jhc._entries.items():
        ent = hc._entries[kb] = _Entry(kb, _values(e.values), e.expires,
                                       e.store_backed)
        ent.hits = e.hits
    for name in ("_device_ok", "_dirty", "_win_hits", "_win_misses",
                 "_ratio"):
        setattr(hc, name, getattr(jhc, name))
    hc._hot = set(jhc._hot)
    hc._inval_seq = dict(jhc._inval_seq)
    hc._slots = list(jhc._slots)
    if jhc._ids_dev is not None:
        hc._ids_dev = IK.to_keys(np.asarray(jhc._ids_dev), dev)
        hc._valid_dev = torch.from_numpy(
            np.asarray(jhc._valid_dev, bool).copy()).to(dev)
    elif hc._device_ok:
        hc._device_ok = None      # the port allocates its table lazily

    lt, jlt = dst.listener_table, src.listener_table
    lt._ids = np.array(jlt._ids, np.uint32)
    lt._valid = np.array(jlt._valid, bool)
    for name in ("_top", "_tombstones", "_device_ok", "_lag_p95"):
        setattr(lt, name, getattr(jlt, name))
    lt._slot_of = dict(jlt._slot_of)
    lt._expires = dict(jlt._expires)
    lt._overflow = set(jlt._overflow)
    lt._buf = {kb: [(v, nv) for v, nv in zip(
        _values([v for v, _ in items]), [nv for _, nv in items])]
        for kb, items in jlt._buf.items()}
    lt._buf_t0 = dict(jlt._buf_t0)
    lt._win_lags = list(jlt._win_lags)
    if jlt._ids_dev is not None:
        lt._ids_dev = IK.to_keys(np.asarray(jlt._ids_dev), dev)
        lt._valid_dev = torch.from_numpy(
            np.asarray(jlt._valid_dev, bool).copy()).to(dev)
    elif lt._device_ok:
        lt._device_ok = None      # the port allocates its table lazily
    lt._dirty = jlt._dirty or lt._ids_dev is None
    if jlt._buf and src._listener_flush_job is not None:
        dst._arm_listener_flush(
            max(0.0, src._listener_flush_job.time - dst.scheduler.time()))

    from .reshard import ReshardLayout
    rs, jrs = dst.reshard, src.reshard
    lay = jrs._layout
    rs._layout = None if lay is None else ReshardLayout(
        gen=int(lay.gen), t=int(lay.t),
        edges=tuple(float(e) for e in lay.edges),
        bin_loads=np.array(lay.bin_loads, np.int64),
        load_weight=float(lay.load_weight))
    for name in ("_gen", "_above_since", "_last_swap", "_last_mode",
                 "_post_imbalance", "_ticks", "_swaps"):
        setattr(rs, name, getattr(jrs, name))
    rs._skips = dict(jrs._skips)
    rs._job = _rearm(jrs._job, dst, rs._job)


def _pem_body(pem: bytes) -> bytes:
    """The DER inside a PEM block."""
    return base64.b64decode(b"".join(
        line for line in pem.split(b"\n")
        if line and not line.startswith(b"-----")))


def identity_from_jax(src):
    """The port's ``crypto.Identity`` for a JAX ``crypto.Identity`` (or
    ``(key, cert)`` pair; either half may be None): the private key as
    PKCS#8 DER and the certificate chain as concatenated DER, loaded by
    the port's own crypto layer."""
    key, cert = src if src else (None, None)
    return crypto.Identity(
        crypto.PrivateKey(_pem_body(key.serialize())) if key else None,
        crypto.Certificate(cert.pack()) if cert else None)


def secure_dht_from_jax(src, send_fn, scheduler=None, *, device=None):
    """A port ``SecureDht`` carrying a JAX ``SecureDht``: the inner node
    through :func:`dht_from_jax`, the identity through
    :func:`identity_from_jax`, the certificates and public keys it has
    cached for other nodes, and ``forward_all``.  Like the original, the
    new overlay announces its own certificate (a permanent put) when it
    has one."""
    from .runtime.secure_dht import SecureDht
    dht = dht_from_jax(src._dht, send_fn, scheduler, device=device)
    ident = identity_from_jax((src.key, src.certificate))
    dst = SecureDht(dht, ident if (ident.first or ident.second) else None)
    for nid, cert in src.node_certificates.items():
        dst.node_certificates[InfoHash(bytes(nid))] = \
            crypto.Certificate(cert.pack())
    for nid, pk in src.node_pubkeys.items():
        dst.node_pubkeys[InfoHash(bytes(nid))] = \
            crypto.PublicKey(pk.export_der())
    dst.forward_all = src.forward_all
    return dst


def _plan_from_jax(plan):
    """A port ``chaos.FaultPlan`` with the phases, membership and seed of
    a JAX one (the plan grammar's dataclasses, field for field)."""
    from . import chaos

    def part(p):
        return None if p is None else chaos.Partition(
            block=[tuple(b) for b in p.block], symmetric=p.symmetric)
    phases = [chaos.Phase(
        ph.name, start=ph.start, duration=ph.duration,
        rules=[chaos.LinkRule(**vars(r)) for r in ph.rules],
        partition=part(ph.partition),
        storm=None if ph.storm is None else chaos.Storm(**vars(ph.storm)),
        poison=None if ph.poison is None else chaos.Poison(**vars(ph.poison)))
        for ph in plan.phases]
    return chaos.FaultPlan(phases, membership=dict(plan.membership),
                           seed=plan.seed)


def swarm_from_jax(sim, *, device=None):
    """A port ``ops.swarm.SwarmSim`` carrying a JAX ``SwarmSim``: its
    plan, its knobs, its state arrays (as numpy), its tick counters and
    the phase names and verdict it last saw, on ``device`` (None = the
    card; a JAX host-oracle sim becomes a port oracle sim).  The JAX
    sim's ``jax.random`` key cannot be carried: feed both sims the same
    bits through ``SwarmSim.advance``."""
    from .ops import swarm
    state = {k: np.asarray(sim.state[k]) for k in swarm.STATE_KEYS}
    dst = swarm.SwarmSim(
        _plan_from_jax(sim.plan), n_nodes=int(state["ids"].shape[0]),
        n_keys=int(state["keys"].shape[0]), n_groups=sim.n_groups,
        tick_dt=sim.tick_dt, sweep_sample=sim.sweep_sample,
        repub_every=sim.repub_every, repub_rate=sim.repub_rate,
        stale_age=sim.stale_age, device=device, oracle=not sim.device,
        _state=state)
    dst.t, dst.tick_no = sim.t, sim.tick_no
    dst._verdict = sim._verdict
    dst._phase_names = tuple(sim._phase_names)
    return dst


def proxy_server_from_jax(jax_server, runner, *, port: int = 0,
                          address: str = "127.0.0.1"):
    """A port ``proxy.DhtProxyServer`` in front of ``runner`` (a port
    ``DhtRunner``) carrying a JAX ``DhtProxyServer``'s state: its push
    gateway (the injected sender and the Gorush address), every
    permanent put (value through its packed bytes, deadline on the shared
    monotonic clock, client id), re-put on ``runner`` as permanent so it
    announces and refreshes it, and every push listener (key, client id,
    deadline, gateway token, platform, client token, refresh flag),
    subscribed on ``runner`` with the server's push callback.  The JAX
    server keeps running; both then serve the same ``GET`` and keep the
    same puts and subscriptions alive.  Left behind: open ``LISTEN``
    streams (their clients reconnect) and the request-rate window."""
    from .core.value import Value
    from .proxy import server as S
    gorush = getattr(jax_server, "_gorush", None)
    dst = S.DhtProxyServer(runner, port, address=address,
                           push_sender=jax_server._push_sender,
                           push_server=gorush.push_server if gorush else None)
    with jax_server._lock:
        puts = [(bytes(k), vid, p.value.get_packed(), p.deadline,
                 p.client_id) for (k, vid), p in jax_server._puts.items()]
        subs = [(bytes(k), cid, r.deadline, r.push_token, r.is_android,
                 r.client_token, r.refresh_sent)
                for (k, cid), r in jax_server._push_listeners.items()]
    for kb, vid, packed, deadline, client_id in puts:
        key, value = InfoHash(kb), Value.from_packed(packed)
        runner.put(key, value, permanent=True)
        with dst._lock:
            dst._puts[(key, vid)] = S._PermanentPut(value, deadline,
                                                    client_id)
    for kb, cid, deadline, push_token, is_android, ctok, sent in subs:
        key = InfoHash(kb)
        rec = S._PushListener(key, cid, None, deadline,
                              push_token=push_token, is_android=is_android,
                              client_token=ctok)
        rec.refresh_sent = sent

        def cb(values, expired, _rec=rec, _key=key, _cid=cid):
            # the data shape of DhtProxyServer's SUBSCRIBE callback
            dst._notify_push(_rec, {"key": _key.hex(), "to": _cid,
                                    "token": str(_rec.client_token)},
                             extra={"expired": bool(expired),
                                    "ids": [v.id for v in values]})
            return True
        with dst._lock:
            dst._push_listeners[(key, cid)] = rec
        rec.token = runner.listen(key, cb)
    with dst._lock:
        dst.stats.put_count = len(dst._puts)
        dst.stats.push_listeners_count = len(dst._push_listeners)
    return dst


def _restore_values(dht, items) -> None:
    """Store ``(key bytes, packed value, created, expiration)`` items on
    ``dht`` (a port ``Dht`` or ``SecureDht``), each keeping its
    expiration."""
    from .core.value import Value
    for kb, packed, created, expiration in items:
        key, value = InfoHash(kb), Value.from_packed(packed)
        dht.storage_store(key, value, created)
        st = dht.store.get(key)
        for vs in (st.values if st is not None else ()):
            if vs.data.id == value.id:
                vs.expiration = expiration


def stores_from_jax(jax_runners, port_runners, *,
                    timeout: float = 30.0) -> int:
    """Copy every value stored on a JAX cluster's runners (key, packed
    value bytes, creation time and expiration) into the port runners
    with the same node ids, so that the replica-coverage probe
    (``testing.health_monitor.replica_coverage``) reads the same answer
    over both clusters.  A running port runner stores them on its DHT
    thread (waiting up to ``timeout`` s); any other object with a
    ``_dht`` and ``get_node_id()`` directly.  Both clusters must share
    a clock (the runners' monotonic one).  Raises KeyError for a JAX
    runner no port runner matches.  Returns the values carried."""
    import concurrent.futures
    by_id = {bytes(r.get_node_id()): r for r in port_runners}
    carried = 0
    for jr in jax_runners:
        dst = by_id.get(bytes(jr.get_node_id()))
        if dst is None:
            raise KeyError("no port runner has node id %s"
                           % jr.get_node_id())
        items = [(bytes(key), vs.data.get_packed(), vs.created,
                  vs.expiration)
                 for key, st in list(jr._dht.store.items())
                 for vs in list(st.values)]
        carried += len(items)
        if getattr(dst, "is_running", lambda: False)():
            done = concurrent.futures.Future()

            def op(dht, _items=items, _done=done):
                try:
                    _restore_values(dht, _items)
                    _done.set_result(None)
                except Exception as e:         # handed to the caller
                    _done.set_exception(e)
            dst._post_node(op, prio=True)
            done.result(timeout)
        else:
            _restore_values(dst._dht, items)
    return carried
