"""Device-resident swarm stepper: tens of thousands of simulated DHT
nodes advanced through a :class:`~opendht_tpu_torch.chaos.FaultPlan` on
the card — the port of the JAX package's ``ops/swarm.py``.

Per-simulated-node state is batched into flat tensors — node ids (keys
[S, 5]), liveness + last-seen, **routing-table occupancy limbs** (160
buckets x 4-bit counts nibble-packed into 20 32-bit limbs per node — a
100k-node swarm's routing state is 8 MB resident), a parallel
attacker-occupancy plane for eclipse/sybil phases, and the stored-key
replica assignment (int32 [K, R] rows).  One :func:`swarm_step` call
advances the whole swarm one tick:

- **join/leave storms** — per-node uniform draws against the phase's
  :class:`~opendht_tpu_torch.chaos.Storm` rates;
- **asymmetric partitions** — a [G, G] reachability matrix derived from
  the phase's :class:`~opendht_tpu_torch.chaos.Partition` gates every
  maintenance/refresh/republish interaction (healing = the phase ends
  and the matrix goes all-True);
- **routing maintenance** — the bucket-maintenance sweep over a
  rotating sample of nodes (:func:`~.radix.maintenance_sweep_batched`,
  the JAX step's ``vmap`` of ``maintenance_sweep``) computes each
  sampled node's TRUE per-bucket reachable-alive occupancy against the
  whole population, refilling its table exactly; every other node that
  wins its maintenance draw refreshes to the analytic steady-state
  k-bucket fill ``min(k, reachable >> (b+1))`` (``model_err`` in the
  returned metrics is the integer sum of their disagreement over the
  sampled rows);
- **eclipse/sybil poisoning** — attacker entries are admitted into at
  most the FREE slots of each victim bucket (the reference routing
  table's full-bucket admission rule, src/routing_table.cpp:204-262)
  and evicted by the first successful maintenance pass after the
  poison phase ends;
- **republish** — on calendar ticks, due keys re-resolve their
  closest-R replica set over the currently alive+reachable population
  (one batched 5-limb lexicographic selection, :func:`_closest_r`).

**Determinism and the host oracle.**  The step consumes PRE-DRAWN
random bits (uint32), so :func:`swarm_step` and the numpy oracle
:func:`swarm_step_host` (a copy of the JAX package's) consume the same
entropy and are bit-identical; so is the JAX ``swarm_step`` on the same
bits and state (tests/test_torch_swarm.py).  All in-step reductions are
integer or boolean, so equality is exact.  ``jax.random`` cannot be
reproduced in torch: :func:`init_swarm` and :class:`SwarmSim` draw their
bits from seeded host ``torch.Generator``s and upload them, so one seed
replays one storm on the CPU and on the card.

**The port's forms.**  Ids and keys are int32 keys (``ops/ids.py``);
the occupancy limbs are int32 holding the uint32 bit patterns; random
bits arrive as uint32 numpy (or int32 bit patterns) and are widened to
int64 before any shift, since torch has no uint32 ``>>`` or ``<``.
:func:`state_to_device` / :func:`state_to_numpy` convert at the numpy
boundary, where the arrays are the JAX package's dtypes.

Probes (:func:`lookup_success_probe`, :func:`replica_coverage`) are the
measurement half; :class:`SwarmSim` publishes both as ``dht_swarm_*``
gauges and ``swarm_verdict``/``chaos_phase`` flight events.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import chaos, telemetry, tracing
from .._device import resolve_device
from ..health import DEGRADED, HEALTHY, UNHEALTHY
from .ids import (FLIP, ID_BITS, KEY_MAX, N_LIMBS, common_bits, from_keys,
                  ids_to_bytes, to_keys)
from .radix import maintenance_sweep_batched

K_BUCKET = 8                     # slots per bucket (TARGET_NODES)
NIB_PER_LIMB = 8                 # 8 x 4-bit counts per 32-bit limb
OCC_LIMBS = ID_BITS // NIB_PER_LIMB      # 20 occupancy limbs per node
REPLICAS = 8                     # stored-key replica factor

_U32_MAX = 0xFFFFFFFF
_I32 = torch.int32

STATE_KEYS = ("ids", "group", "alive", "last_seen", "table_fresh",
              "occ", "poison", "keys", "key_src", "replicas")
METRIC_KEYS = ("n_alive", "n_leave", "n_join", "n_maint_ok", "occ_sum",
               "poison_sum", "stale_buckets", "model_err")


# ------------------------------------------------------------- shared math
# Each helper takes ``xp``: ``np`` (the host oracle, the JAX package's
# code) or ``torch`` (the device step).

def _unif(xp, r):
    """uint32 bits -> float32 in [0, 1): top 24 bits scaled by 2^-24 —
    every value is exactly representable, so device and host agree
    bit-for-bit.  torch: ``r`` int64 holding the uint32 values."""
    if xp is np:
        return (r >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)
    return (r >> 8).to(torch.float32) * (2.0 ** -24)


def _unpack_occ(xp, limbs):
    """nibble-packed limbs [..., 20] -> int32 [..., 160] counts (numpy
    uint32, or torch int32 bit patterns: the arithmetic shift's sign
    bits fall outside the nibble mask)."""
    if xp is np:
        shifts = (np.arange(NIB_PER_LIMB).astype(np.uint32) * np.uint32(4))
        nib = (limbs[..., :, None] >> shifts) & np.uint32(0xF)
        return nib.reshape(limbs.shape[:-1] + (ID_BITS,)).astype(np.int32)
    shifts = torch.arange(NIB_PER_LIMB, dtype=_I32, device=limbs.device) * 4
    nib = (limbs[..., :, None] >> shifts) & 0xF
    return nib.reshape(limbs.shape[:-1] + (ID_BITS,))


def _pack_occ(xp, counts):
    """int32 [..., 160] counts (0..15) -> limbs [..., 20] (numpy uint32;
    torch int32 bit patterns, summed in int64 and wrapped)."""
    nib = counts.reshape(tuple(counts.shape[:-1]) + (OCC_LIMBS, NIB_PER_LIMB))
    if xp is np:
        shifts = (np.arange(NIB_PER_LIMB).astype(np.uint32) * np.uint32(4))
        return np.sum(nib.astype(np.uint32) << shifts, axis=-1,
                      dtype=np.uint32)
    shifts = torch.arange(NIB_PER_LIMB, dtype=torch.int64,
                          device=counts.device) * 4
    u = (nib.to(torch.int64) << shifts).sum(dim=-1)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(_I32)


def _avail(xp, rc, n_buckets=ID_BITS):
    """Analytic steady-state k-bucket fill: bucket b of a node with
    ``rc`` reachable alive peers holds ~``rc >> (b+1)`` of them (the
    Kademlia prefix-partition), capped at K_BUCKET.  int32 [..., 160]."""
    if xp is np:
        sh = np.minimum(np.arange(n_buckets, dtype=np.int32) + 1, 31)
        return np.minimum(rc[..., None] >> sh, K_BUCKET).astype(np.int32)
    sh = torch.clamp(torch.arange(n_buckets, dtype=_I32, device=rc.device)
                     + 1, max=31)
    return torch.clamp(rc[..., None] >> sh, max=K_BUCKET).to(_I32)


def _pair_key(hi, lo):
    """Two int32 keys → one int64 whose order is the (hi, lo) order."""
    return hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) - FLIP)


def _closest_r(xp, keys, ids, valid, r):
    """Rows of the ``r`` XOR-closest valid ids per key — the batched
    closest-node selection (one 5-limb lexicographic sort per key, index
    tiebreak so the result is unique and device == host).  Invalid rows
    sort last; returns (sel int32 [K, r], sel_valid bool [K, r]).

    numpy: the JAX package's ``lexsort`` over uint32 ids.  torch: key
    tensors; the same order from three stable sorts over int64 pairs of
    distance limbs, least significant first, so ties keep the row
    index order (torch has no multi-key sort)."""
    S = ids.shape[0]
    if xp is np:
        valid = np.broadcast_to(valid, (keys.shape[0], S))
        d = np.bitwise_xor(keys[:, None, :], ids[None, :, :])
        dm = np.where(valid[:, :, None], d, np.uint32(_U32_MAX))
        idx = np.broadcast_to(np.arange(S, dtype=np.int32), dm.shape[:2])
        order = np.lexsort((idx, dm[..., 4], dm[..., 3], dm[..., 2],
                            dm[..., 1], dm[..., 0]), axis=-1)
        sel = order[:, :r].astype(np.int32)
        sel_valid = np.take_along_axis(valid, sel, axis=1)
        return sel, sel_valid
    valid = valid.expand(keys.shape[0], S)
    # distance keys, invalid rows the all-ones distance
    dk = torch.where(valid[..., None], keys[:, None, :] ^ ids[None, :, :]
                     ^ FLIP, KEY_MAX)
    order = None
    for key in (_pair_key(dk[..., 3], dk[..., 4]),
                _pair_key(dk[..., 1], dk[..., 2]), dk[..., 0]):
        k = key if order is None else torch.gather(key, 1, order)
        _, p = torch.sort(k, dim=1, stable=True)
        order = p if order is None else torch.gather(order, 1, p)
    sel = order[:, :r]
    return sel.to(_I32), torch.gather(valid, 1, sel)


# ============================================================ conversions
def state_to_device(host: Dict, device=None) -> Dict:
    """A swarm state of numpy arrays (the JAX package's dtypes: uint32
    ids / keys / occupancy limbs) → the port's tensors on ``device``
    (None = the card)."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.from_numpy(np.array(x, dtype)).to(dev)
    return {
        "ids": to_keys(np.asarray(host["ids"], np.uint32), dev),
        "group": t(host["group"], np.int32),
        "alive": t(host["alive"], bool),
        "last_seen": t(host["last_seen"], np.float32),
        "table_fresh": t(host["table_fresh"], np.float32),
        "occ": t(np.asarray(host["occ"], np.uint32).view(np.int32),
                 np.int32),
        "poison": t(np.asarray(host["poison"], np.uint32).view(np.int32),
                    np.int32),
        "keys": to_keys(np.asarray(host["keys"], np.uint32), dev),
        "key_src": t(host["key_src"], np.int32),
        "replicas": t(host["replicas"], np.int32),
    }


def state_to_numpy(state: Dict) -> Dict:
    """The inverse of :func:`state_to_device`: numpy arrays in the JAX
    package's dtypes (a numpy state is returned as it is)."""
    if not isinstance(state["alive"], torch.Tensor):
        return state
    out = {}
    for k in STATE_KEYS:
        v = state[k]
        if k in ("ids", "keys"):
            out[k] = from_keys(v)
        elif k in ("occ", "poison"):
            out[k] = v.cpu().numpy().view(np.uint32)
        else:
            out[k] = v.cpu().numpy()
    return out


def _bits(x, dev) -> torch.Tensor:
    """Pre-drawn random bits (uint32 numpy, or an int32 / int64 tensor)
    as int64 values in [0, 2^32) on ``dev``; uploaded as 4-byte words."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, np.uint32).view(np.int32))
    return x.to(dev).to(torch.int64) & _U32_MAX


def _on(x, dtype, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.from_numpy(np.array(x)).to(device=dev, dtype=dtype)


def _f32(x) -> float:
    """A host scalar rounded to float32 (exact as a Python float)."""
    return float(np.float32(x))


# ================================================================ device
def swarm_step(state, now, leave_rate, join_rate, loss, repub_rate,
               stale_age, reach, poison_on, poison_mask, poison_pressure,
               repub_on, sweep_idx, rand_node, rand_key):
    """Advance the whole swarm one tick on the state's device (see module
    docstring).  ``state`` is a dict of tensors (:func:`state_to_device`);
    ``now``, the rates, ``stale_age``, ``poison_on``, ``poison_pressure``
    and ``repub_on`` are host scalars (float32 values); ``reach`` [G, G]
    and ``poison_mask`` [S] bool; ``sweep_idx`` [M] host ints, distinct;
    ``rand_node`` [S, 3] / ``rand_key`` [K] pre-drawn uint32 bits.
    Returns (new state, metrics): the metrics are 0-d int32 tensors
    (:data:`METRIC_KEYS`), nothing is read back."""
    ids = state["ids"]
    dev = ids.device
    group = state["group"].long()
    alive = state["alive"]
    S = ids.shape[0]
    idx_np = np.asarray(sweep_idx, np.int64).reshape(-1)
    # the rows are written back with index_put_, exact only without
    # duplicates (the JAX step's .at[].set takes one of them)
    assert np.unique(idx_np).size == idx_np.size, \
        "sweep_idx must not repeat a row"
    sw = torch.from_numpy(idx_np).to(dev)
    reach = _on(reach, torch.bool, dev)
    G = reach.shape[0]
    rn = _bits(rand_node, dev)
    now_f = _f32(now)

    # -- churn: leave/join storms
    u0 = _unif(torch, rn[:, 0])
    u1 = _unif(torch, rn[:, 1])
    leave = alive & (u0 < _f32(leave_rate))
    join = (~alive) & (u1 < _f32(join_rate))
    alive2 = (alive & ~leave) | join
    last_seen2 = torch.where(alive2, now_f, state["last_seen"])

    # -- partition-aware reachable population per node (integer-exact)
    gcount = torch.zeros(G, dtype=_I32, device=dev).index_add_(
        0, group, alive2.to(_I32))
    rc_group = (reach.to(_I32) * gcount[None, :]).sum(dim=1, dtype=_I32)
    self_reach = torch.diagonal(reach)[group]
    rc = rc_group[group] - (alive2 & self_reach).to(_I32)
    n_alive = alive2.sum(dtype=_I32)

    # -- maintenance draw: (1-loss) x reachable fraction, in float32
    denom = torch.clamp(n_alive - 1, min=1).to(torch.float32)
    keep = float(np.float32(1.0) - np.float32(loss))
    p_maint = keep * (rc.to(torch.float32) / denom)
    ok_maint = alive2 & (_unif(torch, rn[:, 2]) < p_maint)

    # -- the bucket-maintenance sweep over the rotating sample: exact
    # per-bucket reachable-alive occupancy + staleness (valid = alive &
    # reachable-from-me & not-me)
    g_sw = group[sw]
    valid_m = (alive2[None, :] & reach[g_sw][:, group]
               & (torch.arange(S, device=dev)[None, :] != sw[:, None]))
    counts, stale = maintenance_sweep_batched(ids[sw], ids, valid_m,
                                              last_seen2, now, stale_age)

    # -- occupancy planes (nibble-unpacked)
    occ_n = _unpack_occ(torch, state["occ"])
    poi_n = _unpack_occ(torch, state["poison"])
    victim = _on(poison_mask, torch.bool, dev) & bool(poison_on)
    # sybil admission: only the FREE slots of a bucket admit attacker
    # entries (full-bucket rejection, src/routing_table.cpp:204-262)
    poi2 = torch.where(victim[:, None],
                       torch.minimum(poi_n + int(poison_pressure),
                                     torch.clamp(K_BUCKET - occ_n, min=0)),
                       poi_n)
    # attacker entries expire on the first successful maintenance pass
    # once the poison phase is over (sybils stop answering)
    poi3 = torch.where((ok_maint & ~victim)[:, None], 0, poi2)
    av = _avail(torch, rc)
    target = torch.minimum(av, K_BUCKET - poi3)
    occ2 = torch.where(ok_maint[:, None], target, occ_n)
    # exact refill for the swept rows (counts from the sweep)
    sweep_fill = torch.minimum(counts, K_BUCKET - poi3[sw])
    swept_alive = alive2[sw]
    sweep_fill = torch.where(swept_alive[:, None], sweep_fill, 0)
    occ2[sw] = sweep_fill
    # joiners bootstrap sparse (one known peer per non-empty bucket);
    # dead nodes hold no table
    occ2 = torch.where(join[:, None], torch.clamp(av, max=1), occ2)
    occ2 = torch.where(alive2[:, None], occ2, 0)
    poi3 = torch.where(alive2[:, None] & ~join[:, None], poi3, 0)

    fresh = torch.where(ok_maint | join, now_f, state["table_fresh"])
    fresh[sw] = torch.where(swept_alive, now_f, fresh[sw])

    # -- republish: due keys re-resolve closest-R over alive+reachable.
    # repub_on is a host bool, so this branch is the JAX step's
    # lax.cond(repub_on, ...) taken exactly, on the host
    replicas = state["replicas"]
    keys = state["keys"]
    key_src = state["key_src"]
    if bool(repub_on):
        due = _unif(torch, _bits(rand_key, dev)) < _f32(repub_rate)
        valid_ks = alive2[None, :] & reach[group[key_src.long()]][:, group]
        sel, sel_valid = _closest_r(torch, keys, ids, valid_ks,
                                    replicas.shape[1])
        newrep = torch.where(sel_valid, sel, -1)
        replicas = torch.where(due[:, None], newrep, replicas)

    new_state = {
        "ids": ids, "group": state["group"], "alive": alive2,
        "last_seen": last_seen2, "table_fresh": fresh,
        "occ": _pack_occ(torch, occ2), "poison": _pack_occ(torch, poi3),
        "keys": keys, "key_src": key_src, "replicas": replicas,
    }
    # integer-only metrics (no float accumulation order): ratios are
    # derived host-side
    analytic_at_sweep = target[sw]
    alive_rows = swept_alive[:, None]
    metrics = {
        "n_alive": n_alive,
        "n_leave": leave.sum(dtype=_I32),
        "n_join": join.sum(dtype=_I32),
        "n_maint_ok": ok_maint.sum(dtype=_I32),
        "occ_sum": occ2.sum(dtype=_I32),
        "poison_sum": poi3.sum(dtype=_I32),
        "stale_buckets": torch.where(alive_rows, stale.to(_I32),
                                     0).sum(dtype=_I32),
        "model_err": torch.where(
            alive_rows, (analytic_at_sweep - sweep_fill).abs(),
            0).sum(dtype=_I32),
    }
    return new_state, metrics


def read_metrics(metrics: Dict) -> Dict:
    """The step's metric tensors as Python ints, in one device read."""
    vals = torch.stack([metrics[k].to(torch.int64)
                        for k in METRIC_KEYS]).tolist()
    return dict(zip(METRIC_KEYS, vals))


# ================================================================== host
def _host_buckets(ids_bits, i):
    """Bucket index of every id relative to row ``i`` (first differing
    bit, clipped to 159; self reads 159 but callers mask self out) —
    the numpy mirror of radix.bucket_of."""
    x = ids_bits ^ ids_bits[i]
    anynz = x.any(axis=1)
    first = np.argmax(x, axis=1)
    cb = np.where(anynz, first, ID_BITS)
    return np.minimum(cb, ID_BITS - 1).astype(np.int64)


def swarm_step_host(state, now, leave_rate, join_rate, loss,
                    repub_rate, stale_age, reach, poison_on,
                    poison_mask, poison_pressure, repub_on, sweep_idx,
                    rand_node, rand_key):
    """Scalar-flavored numpy oracle, bit-identical to :func:`swarm_step`
    on the same pre-drawn random bits — a copy of the JAX package's.
    ``state`` holds numpy arrays; the metrics come back as ints."""
    xp = np
    ids = np.asarray(state["ids"], np.uint32)
    group = np.asarray(state["group"], np.int32)
    alive = np.asarray(state["alive"], bool)
    S = ids.shape[0]
    G = reach.shape[0]
    now = np.float32(now)
    leave_rate = np.float32(leave_rate)
    join_rate = np.float32(join_rate)
    loss = np.float32(loss)
    repub_rate = np.float32(repub_rate)
    stale_age = np.float32(stale_age)
    reach = np.asarray(reach, bool)
    sweep_idx = np.asarray(sweep_idx, np.int32)
    rand_node = np.asarray(rand_node, np.uint32)
    rand_key = np.asarray(rand_key, np.uint32)

    u0 = _unif(xp, rand_node[:, 0])
    u1 = _unif(xp, rand_node[:, 1])
    leave = alive & (u0 < leave_rate)
    join = (~alive) & (u1 < join_rate)
    alive2 = (alive & ~leave) | join
    last_seen2 = np.where(alive2, now,
                          np.asarray(state["last_seen"], np.float32))

    gcount = np.zeros((G,), np.int32)
    np.add.at(gcount, group, alive2.astype(np.int32))
    reach_i = reach.astype(np.int32)
    rc_group = np.sum(reach_i * gcount[None, :], axis=1, dtype=np.int32)
    self_reach = np.diagonal(reach)[group]
    rc = rc_group[group] - (alive2 & self_reach).astype(np.int32)
    n_alive = np.int32(alive2.astype(np.int32).sum())

    denom = np.float32(max(int(n_alive) - 1, 1))
    p_maint = (np.float32(1.0) - loss) * (rc.astype(np.float32) / denom)
    ok_maint = alive2 & (_unif(xp, rand_node[:, 2]) < p_maint)

    # maintenance_sweep mirror over the sample
    ids_bits = np.unpackbits(
        ids_to_bytes(ids).astype(np.uint8), axis=-1)        # [S, 160]
    M = sweep_idx.shape[0]
    counts = np.zeros((M, ID_BITS), np.int32)
    stale = np.zeros((M, ID_BITS), bool)
    probes = np.arange(ID_BITS)
    for m, i in enumerate(sweep_idx):
        valid_i = (alive2 & reach[group[i], group]
                   & (np.arange(S) != i))
        b = _host_buckets(ids_bits, i)
        bm = np.where(valid_i, b, -1)
        hit = bm[None, :] == probes[:, None]
        counts[m] = hit.sum(axis=1)
        vals = np.where(valid_i & (last_seen2 > 0), last_seen2,
                        -np.inf).astype(np.float32)
        last = np.max(np.where(hit, vals[None, :], -np.inf),
                      axis=1).astype(np.float32)
        stale[m] = (counts[m] > 0) & (last < now - stale_age)

    occ_n = _unpack_occ(xp, np.asarray(state["occ"], np.uint32))
    poi_n = _unpack_occ(xp, np.asarray(state["poison"], np.uint32))
    victim = bool(poison_on) & np.asarray(poison_mask, bool)
    poi2 = np.where(victim[:, None],
                    np.minimum(poi_n + int(poison_pressure),
                               np.maximum(K_BUCKET - occ_n, 0)),
                    poi_n)
    poi3 = np.where((ok_maint & ~victim)[:, None], 0, poi2)
    av = _avail(xp, rc)
    target = np.minimum(av, K_BUCKET - poi3)
    occ2 = np.where(ok_maint[:, None], target, occ_n)
    sweep_fill = np.minimum(counts, K_BUCKET - poi3[sweep_idx])
    sweep_fill = np.where(alive2[sweep_idx][:, None], sweep_fill, 0)
    occ2[sweep_idx] = sweep_fill
    occ2 = np.where(join[:, None], np.minimum(av, 1), occ2)
    occ2 = np.where(alive2[:, None], occ2, 0)
    poi3 = np.where(alive2[:, None] & ~join[:, None], poi3, 0)

    fresh = np.where(ok_maint | join, now,
                     np.asarray(state["table_fresh"], np.float32))
    fresh[sweep_idx] = np.where(alive2[sweep_idx], now,
                                fresh[sweep_idx]).astype(np.float32)

    replicas = np.asarray(state["replicas"], np.int32)
    keys = np.asarray(state["keys"], np.uint32)
    key_src = np.asarray(state["key_src"], np.int32)
    R = replicas.shape[1]
    if bool(repub_on):
        due = _unif(xp, rand_key) < repub_rate
        valid_ks = (alive2[None, :]
                    & reach[group[key_src][:, None], group[None, :]])
        sel, sel_valid = _closest_r(xp, keys, ids, valid_ks, R)
        newrep = np.where(sel_valid, sel, -1).astype(np.int32)
        replicas2 = np.where(due[:, None], newrep, replicas)
    else:
        replicas2 = replicas

    new_state = {
        "ids": ids, "group": group, "alive": alive2,
        "last_seen": last_seen2.astype(np.float32),
        "table_fresh": fresh.astype(np.float32),
        "occ": _pack_occ(xp, occ2), "poison": _pack_occ(xp, poi3),
        "keys": keys, "key_src": key_src,
        "replicas": replicas2.astype(np.int32),
    }
    analytic_at_sweep = target[sweep_idx]
    swept_alive = alive2[sweep_idx]
    metrics = {
        "n_alive": int(n_alive),
        "n_leave": int(leave.sum()),
        "n_join": int(join.sum()),
        "n_maint_ok": int(ok_maint.sum()),
        "occ_sum": int(occ2.sum()),
        "poison_sum": int(poi3.sum()),
        "stale_buckets": int(
            np.where(swept_alive[:, None], stale.astype(np.int32),
                     0).sum()),
        "model_err": int(
            np.where(swept_alive[:, None],
                     np.abs(analytic_at_sweep - sweep_fill), 0).sum()),
    }
    return new_state, metrics


# ================================================================ probes
def lookup_success_probe(state, reach, probe_keys, src, replicas):
    """Batched structural lookup-success probe on the state's device: a
    lookup for key ``h`` from source ``s`` succeeds when ``s`` is alive,
    its routing bucket toward ``h`` holds at least one live reachable
    honest entry, and some ASSIGNED replica of ``h`` is alive and
    reachable from ``s``'s side of any partition.  Returns bool [P] on
    the device."""
    ids = state["ids"]
    dev = ids.device
    group = state["group"].long()
    alive = state["alive"]
    reach = _on(reach, torch.bool, dev)
    probe_keys = (probe_keys if isinstance(probe_keys, torch.Tensor)
                  else to_keys(np.asarray(probe_keys, np.uint32), dev))
    src = _on(src, torch.int64, dev)
    replicas = _on(replicas, torch.int64, dev)
    S = ids.shape[0]
    g_src = group[src]
    rep = torch.clamp(replicas, 0, S - 1)
    rep_ok = (replicas >= 0) & alive[rep]
    any_rep = (rep_ok & reach[g_src[:, None], group[rep]]).any(dim=1)

    src_ids = ids[src]
    b = torch.clamp(common_bits(src_ids, probe_keys), max=ID_BITS - 1)
    cb_all = common_bits(src_ids[:, None, :], ids[None, :, :])
    bucket_all = torch.clamp(cb_all, max=ID_BITS - 1)
    inb = ((bucket_all == b[:, None]) & alive[None, :]
           & reach[g_src[:, None], group[None, :]]
           & (torch.arange(S, device=dev)[None, :] != src[:, None]))
    live_b = inb.sum(dim=1, dtype=_I32)
    occ_n = _unpack_occ(torch, state["occ"][src])
    occ_b = torch.gather(occ_n, 1, b[:, None].long())[:, 0]
    eff = torch.minimum(occ_b, live_b)
    total_occ = occ_n.sum(dim=1)
    routing_ok = torch.where(live_b > 0, eff > 0, total_occ > 0)
    return alive[src] & routing_ok & any_rep


def lookup_success_probe_host(state, reach, probe_keys, src, replicas):
    """numpy mirror of :func:`lookup_success_probe` (oracle pin)."""
    ids = np.asarray(state["ids"], np.uint32)
    group = np.asarray(state["group"], np.int32)
    alive = np.asarray(state["alive"], bool)
    reach = np.asarray(reach, bool)
    probe_keys = np.asarray(probe_keys, np.uint32)
    src = np.asarray(src, np.int32)
    replicas = np.asarray(replicas, np.int32)
    S = ids.shape[0]
    g_src = group[src]
    rep = np.clip(replicas, 0, S - 1)
    rep_ok = (replicas >= 0) & alive[rep]
    any_rep = np.any(rep_ok & reach[g_src[:, None], group[rep]], axis=1)

    ids_bits = np.unpackbits(ids_to_bytes(ids).astype(np.uint8), axis=-1)
    key_bits = np.unpackbits(ids_to_bytes(probe_keys).astype(np.uint8),
                             axis=-1)
    out = np.zeros((len(src),), bool)
    for p, s in enumerate(src):
        xk = ids_bits[s] ^ key_bits[p]
        b = min(int(np.argmax(xk)) if xk.any() else ID_BITS,
                ID_BITS - 1)
        buckets = _host_buckets(ids_bits, s)
        inb = ((buckets == b) & alive & reach[g_src[p], group]
               & (np.arange(S) != s))
        live_b = int(inb.sum())
        occ_n = _unpack_occ(np, np.asarray(state["occ"], np.uint32)[s])
        eff = min(int(occ_n[b]), live_b)
        routing_ok = (eff > 0) if live_b > 0 else (int(occ_n.sum()) > 0)
        out[p] = bool(alive[s]) and routing_ok and bool(any_rep[p])
    return out


def replica_coverage(state):
    """Per-key fraction of the key's TRUE closest-R alive nodes that
    are in its current replica assignment — the replica-coverage
    invariant's structural form.  A partition skews assignments to one
    side, so coverage drops the moment the network heals and the true
    closest set is global again; republish restores it.  float64 numpy
    [K] in [0, 1].  A state of tensors selects on its device (the same
    rows as the numpy selection) and reads back two integer vectors;
    the ratio is numpy's either way."""
    if isinstance(state["alive"], torch.Tensor):
        rep = state["replicas"]
        sel, sel_valid = _closest_r(torch, state["keys"], state["ids"],
                                    state["alive"], rep.shape[1])
        hit = ((sel[:, :, None] == rep[:, None, :]).any(dim=2)
               & sel_valid).sum(dim=1)
        both = torch.stack([hit, sel_valid.sum(dim=1)]).cpu().numpy()
        return both[0] / np.maximum(both[1], 1)
    rep = np.asarray(state["replicas"], np.int32)
    alive = np.asarray(state["alive"], bool)
    ids = np.asarray(state["ids"], np.uint32)
    keys = np.asarray(state["keys"], np.uint32)
    sel, sel_valid = _closest_r(np, keys, ids, alive, rep.shape[1])
    hit = (sel[:, :, None] == rep[:, None, :]).any(axis=2) & sel_valid
    denom = np.maximum(sel_valid.sum(axis=1), 1)
    return hit.sum(axis=1) / denom


# ================================================================ driver
def draw_bits(gen: torch.Generator, shape) -> np.ndarray:
    """uint32 numpy bits from a host ``torch.Generator``."""
    return torch.randint(0, 1 << 32, tuple(shape), dtype=torch.int64,
                         generator=gen).numpy().astype(np.uint32)


def init_swarm(seed: int, n_nodes: int, n_keys: int = 64, *,
               replicas: int = REPLICAS, n_groups: int = 2) -> Dict:
    """Build a converged swarm (numpy arrays in the JAX package's dtypes;
    :func:`state_to_device` moves them).  Ids and keys are drawn from a
    ``torch.Generator`` seeded with ``seed``.  Groups are balanced index
    ranges ``g0..g{G-1}`` — the names :class:`~opendht_tpu_torch.chaos.
    Partition`/:class:`~opendht_tpu_torch.chaos.Poison` phases refer
    to."""
    gen = torch.Generator().manual_seed(seed)
    ids = draw_bits(gen, (n_nodes, N_LIMBS))
    keys = draw_bits(gen, (n_keys, N_LIMBS))
    group = ((np.arange(n_nodes, dtype=np.int64) * n_groups)
             // n_nodes).astype(np.int32)
    alive = np.ones((n_nodes,), bool)
    rc = np.full((n_nodes,), n_nodes - 1, np.int32)
    occ = _pack_occ(np, _avail(np, rc))
    key_src = (np.arange(n_keys, dtype=np.int64) % n_nodes).astype(np.int32)
    # initial replica assignment: closest-R over the full population (the
    # torch selection on the host: numpy's 6-key lexsort gives the same
    # rows, seconds slower at 50,000 nodes)
    sel, sel_valid = _closest_r(torch, to_keys(keys, "cpu"),
                                to_keys(ids, "cpu"),
                                torch.ones(n_nodes, dtype=torch.bool),
                                replicas)
    return {
        "ids": ids, "group": group, "alive": alive,
        "last_seen": np.zeros((n_nodes,), np.float32),
        "table_fresh": np.zeros((n_nodes,), np.float32),
        "occ": occ,
        "poison": np.zeros((n_nodes, OCC_LIMBS), np.uint32),
        "keys": keys, "key_src": key_src,
        "replicas": torch.where(sel_valid, sel, -1).numpy().astype(np.int32),
    }


def params_at(plan: chaos.FaultPlan, rel: float, n_groups: int,
              group: np.ndarray) -> Dict:
    """Fold the plan's phases active at relative time ``rel`` into the
    stepper's tick parameters: storm rates, wildcard loss, the [G,G]
    reachability matrix (partitions reference groups ``g0..``;
    healing = the phase window ends), and the poison mask/pressure."""
    storm = plan.storm_at(rel) or chaos.Storm()
    loss = 0.0
    for ph in plan.phases_at(rel):
        for rule in ph.rules:
            if rule.src == chaos.ANY and rule.dst == chaos.ANY:
                loss = 1.0 - (1.0 - loss) * (1.0 - rule.loss)
    names = ["g%d" % i for i in range(n_groups)]
    reach = np.ones((n_groups, n_groups), bool)
    for _pname, part in plan.partitions_at(rel):
        for i, a in enumerate(names):
            for j, b in enumerate(names):
                if part.blocks(a, b):
                    reach[i, j] = False
    poison = plan.poison_at(rel)
    if poison is not None and poison.victim in names:
        vidx = names.index(poison.victim)
        poison_mask = np.asarray(group) == vidx
        poison_on = True
        pressure = int(poison.per_bucket)
    else:
        poison_mask = np.zeros((len(group),), bool)
        poison_on = False
        pressure = 0
    return {
        "leave_rate": np.float32(storm.leave_rate),
        "join_rate": np.float32(storm.join_rate),
        "loss": np.float32(loss),
        "reach": reach,
        "poison_on": bool(poison_on),
        "poison_mask": poison_mask,
        "poison_pressure": np.int32(pressure),
    }


class SwarmSim:
    """Host driver: advances a swarm through a FaultPlan, one
    :func:`swarm_step` per tick on ``device`` (None = the card), or
    through the numpy oracle :func:`swarm_step_host` with
    ``oracle=True`` (the state then stays numpy), publishing
    ``dht_swarm_*`` gauges and ``chaos_phase``/``swarm_verdict`` flight
    events.  Each tick's bits come from a host ``torch.Generator``
    seeded from ``seed``, so two sims of one seed — on the card, on the
    CPU or the oracle — draw the same bits and step alike."""

    def __init__(self, plan: chaos.FaultPlan, *, n_nodes: int,
                 n_keys: int = 64, n_groups: int = 2, seed: int = 7,
                 tick_dt: float = 1.0, sweep_sample: int = 32,
                 repub_every: int = 4, repub_rate: float = 1.0,
                 stale_age: float = 5.0, device=None, oracle: bool = False,
                 _state: "Dict | None" = None):
        self.plan = plan
        self.n_groups = n_groups
        self.tick_dt = tick_dt
        self.sweep_sample = min(sweep_sample, n_nodes)
        self.repub_every = repub_every
        self.repub_rate = repub_rate
        self.stale_age = stale_age
        self.oracle = oracle
        self.device = resolve_device(device)
        self.t = 0.0
        self.tick_no = 0
        # the tick bits' generator: its own stream, apart from init's
        self._gen = torch.Generator().manual_seed(seed + 0x9E3779B9)
        host = (init_swarm(seed, n_nodes, n_keys, n_groups=n_groups)
                if _state is None else _state)
        self._group_host = np.asarray(host["group"], np.int32)
        self.state = host if oracle else state_to_device(host, self.device)
        self._verdict = HEALTHY
        self._phase_names: tuple = ()
        reg = telemetry.get_registry()
        self._g = {name: reg.gauge("dht_swarm_" + name)
                   for name in ("alive", "lookup_success",
                                "replica_coverage", "poison_occupancy",
                                "occupancy", "model_err")}
        self._tracer = tracing.get_tracer()

    # -- one step per tick --------------------------------------------------
    def draw(self):
        """The next tick's (rand_node [S, 3], rand_key [K]) uint32 bits."""
        S = self._group_host.shape[0]
        K = self.state["keys"].shape[0]
        return draw_bits(self._gen, (S, 3)), draw_bits(self._gen, (K,))

    def tick(self) -> Dict:
        return self.advance(*self.draw())

    def advance(self, rand_node, rand_key) -> Dict:
        """One tick on the given bits (:meth:`tick` draws them)."""
        rel = self.t
        p = params_at(self.plan, rel, self.n_groups, self._group_host)
        self._note_phases(rel)
        S = self._group_host.shape[0]
        M = self.sweep_sample
        sweep_idx = ((np.arange(M, dtype=np.int64) + self.tick_no * M)
                     % S).astype(np.int32)
        repub_on = (self.tick_no % self.repub_every) == 0
        now = np.float32(rel + self.tick_dt)
        step = swarm_step_host if self.oracle else swarm_step
        self.state, metrics = step(
            self.state, now, p["leave_rate"], p["join_rate"], p["loss"],
            np.float32(self.repub_rate), np.float32(self.stale_age),
            p["reach"], p["poison_on"], p["poison_mask"],
            p["poison_pressure"], repub_on, sweep_idx, rand_node, rand_key)
        self.t += self.tick_dt
        self.tick_no += 1
        metrics = (dict(metrics) if self.oracle
                   else read_metrics(metrics))
        self._g["alive"].set(metrics["n_alive"])
        self._g["poison_occupancy"].set(metrics["poison_sum"])
        # total replica-slot occupancy per tick: the storage-pressure
        # series the history frames carry into bundles
        self._g["occupancy"].set(metrics["occ_sum"])
        self._g["model_err"].set(metrics["model_err"])
        return metrics

    def _note_phases(self, rel: float) -> None:
        names = tuple(ph.name for ph in self.plan.phases_at(rel))
        if names != self._phase_names:
            if self._tracer.enabled:
                self._tracer.event("chaos_phase", active=",".join(names)
                                   or "(none)", t=rel)
            self._phase_names = names

    # -- invariants --------------------------------------------------------
    def probe(self, n_probes: int = 32) -> Dict:
        """Lookup-success + replica-coverage invariants at the current
        tick, rolled into a healthy|degraded|unhealthy verdict
        (unhealthy < 0.5, degraded < 0.9)."""
        st = self.state
        alive = (st["alive"].cpu().numpy() if not self.oracle
                 else np.asarray(st["alive"]))
        K = st["keys"].shape[0]
        P = min(n_probes, K)
        # lookups originate at ALIVE nodes (a dead source is not a
        # failed lookup, it is no lookup) — deterministic stride sample
        live = np.nonzero(alive)[0]
        if len(live) == 0:
            return {"lookup_success": 0.0, "replica_coverage": 0.0,
                    "verdict": UNHEALTHY}
        src = live[((np.arange(P, dtype=np.int64) * 997 + self.tick_no)
                    % len(live))].astype(np.int32)
        rel = self.t
        p = params_at(self.plan, rel, self.n_groups, self._group_host)
        if self.oracle:
            ok = lookup_success_probe_host(st, p["reach"], st["keys"][:P],
                                           src, st["replicas"][:P])
        else:
            ok = lookup_success_probe(st, p["reach"], st["keys"][:P], src,
                                      st["replicas"][:P]).cpu().numpy()
        cov = replica_coverage(st)
        success = float(ok.sum()) / max(len(ok), 1)
        coverage = float(cov.mean()) if len(cov) else 1.0
        worst = min(success, coverage)
        verdict = (UNHEALTHY if worst < 0.5
                   else DEGRADED if worst < 0.9 else HEALTHY)
        self._g["lookup_success"].set(success)
        self._g["replica_coverage"].set(coverage)
        if verdict != self._verdict:
            if self._tracer.enabled:
                self._tracer.event("swarm_verdict", to=verdict,
                                   frm=self._verdict,
                                   lookup_success=round(success, 4),
                                   coverage=round(coverage, 4))
            self._verdict = verdict
        return {"lookup_success": success, "replica_coverage": coverage,
                "verdict": verdict}

    def run(self, ticks: int, *, probe_every: int = 1) -> list:
        out = []
        for i in range(ticks):
            m = self.tick()
            if probe_every and (i % probe_every) == 0:
                m.update(self.probe())
            out.append(m)
        return out
