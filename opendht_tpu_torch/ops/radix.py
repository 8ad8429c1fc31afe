"""k-bucket partition and the bucket-maintenance sweep.

The reference's routing table splits only around the node's own id
(src/routing_table.cpp:176-262), so at steady state bucket b holds the
peers that share exactly b leading bits with self.  This module is the
port of the JAX package's ``ops/radix.py``:

- ``bucket_of``          peer → bucket (clipped commonBits with self)
- ``bucket_counts``      per-bucket occupancy
- ``bucket_last_seen``   per-bucket latest reply; -inf where no peer ever
                         replied (↔ Bucket::time = time_point::min(),
                         src/routing_table.cpp:210-211): never-replied
                         buckets are stale from birth
- ``maintenance_sweep``  occupancy + staleness + a refresh target per
                         bucket in one pass (↔ Dht::bucketMaintenance,
                         src/dht.cpp:1780-1838)
- ``random_id_in_bucket`` uniform id in a bucket's range
                         (↔ RoutingTable::randomId,
                         src/routing_table.cpp:67-85)
- ``estimate_network_size`` k·2^depth (↔ callbacks.h:54)

**No [160, N] broadcast.**  The JAX package counts and maxes through a
[160, N] compare-and-reduce because scatters serialize on the TPU.  At
N = 10M that is a 1.6 GB mask on the card; counts and maxima do not
depend on order, so one ``bincount`` and one ``scatter_reduce("amax")``
over the N bucket indices give the same exact values (the scatter into
spread copies of the bins, see :func:`_last`).

**Reply times are float32.**  The JAX package runs without x64, so
``jnp.asarray`` turns the table's float64 reply times into float32 and
``last < now - age`` compares in float32; the port casts once, in
:func:`_reply_times`.

**Randomness.**  ``jax.random.bits`` cannot be reproduced in torch: the
port draws from a ``torch.Generator`` and :func:`_random_id_from_bits`
does the mask arithmetic on given bits, which is what the parity tests
hold against the JAX function.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .ids import (FLIP, ID_BITS, N_LIMBS, as_keys, common_bits, get_bit,
                  set_bit)

MAX_BUCKET = ID_BITS - 1  # deepest distinct bucket (bit 159)

# host-precomputed prefix masks: row b = mask of the first b bits
_PREFIX_MASKS = np.zeros((ID_BITS + 1, N_LIMBS), dtype=np.uint32)
for _b in range(ID_BITS + 1):
    full, rem = divmod(_b, 32)
    _PREFIX_MASKS[_b, :full] = 0xFFFFFFFF
    if rem and full < N_LIMBS:
        _PREFIX_MASKS[_b, full] = (0xFFFFFFFF << (32 - rem)) & 0xFFFFFFFF
del _b


def prefix_masks(prefix_len: torch.Tensor) -> torch.Tensor:
    """Raw-bit int32 masks [..., 5] of the first ``prefix_len`` bits
    (clipped to [0, 160])."""
    table = torch.from_numpy(_PREFIX_MASKS.view(np.int32)).to(
        prefix_len.device)
    return table[prefix_len.clamp(0, ID_BITS).long()]


def bucket_of(self_id: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Bucket index of each id relative to ``self_id``: min(commonBits, 159).

    self_id: key tensor [5]; ids: key tensor [..., 5] → int32 [...].
    The own id (cb=160) lands in bucket 159 with its closest peers.
    """
    cb = common_bits(self_id.expand_as(ids), ids)
    return torch.clamp(cb, max=MAX_BUCKET)


def _reply_times(last_seen: torch.Tensor) -> torch.Tensor:
    # float32 on purpose: the JAX package's NodeTable hands its float64
    # _time_reply to the device with jnp.asarray, which without x64 is
    # float32 (opendht_tpu/core/table.py:1131-1133, 1157-1160)
    return last_seen.to(torch.float32)


def _valid_buckets(self_id, ids, valid) -> torch.Tensor:
    """Bucket of each valid row, ``ID_BITS`` (a 161st bin) for the rest."""
    return torch.where(valid, bucket_of(self_id, ids), ID_BITS).long()


def _counts(bm: torch.Tensor) -> torch.Tensor:
    return torch.bincount(bm, minlength=ID_BITS + 1)[:ID_BITS].to(
        torch.int32)


# copies of the bins of the last-reply scatter (see _last)
_SPREAD = 1024


def _last(bm: torch.Tensor, valid, last_seen) -> torch.Tensor:
    ls = _reply_times(last_seen)
    vals = torch.where(valid & (ls > 0), ls, -torch.inf)
    # a max does not depend on order: row i goes to copy i % _SPREAD of
    # the 161 bins, then the copies are maxed.  Same exact values as one
    # 161-bin scatter, whose float atomics all collide on the ~24
    # occupied bins of a uniform table.
    nb = ID_BITS + 1
    copy = torch.arange(bm.shape[0], device=bm.device) % _SPREAD
    init = torch.full((_SPREAD * nb,), -torch.inf, dtype=torch.float32,
                      device=bm.device)
    per_copy = init.scatter_reduce(0, copy * nb + bm, vals, reduce="amax",
                                   include_self=True)
    return per_copy.view(_SPREAD, nb).amax(dim=0)[:ID_BITS]


def bucket_counts(self_id, ids, valid) -> torch.Tensor:
    """Occupancy of each of the 160 buckets.  int32 [160]."""
    return _counts(_valid_buckets(self_id, ids, valid))


def bucket_last_seen(self_id, ids, valid, last_seen) -> torch.Tensor:
    """Per-bucket max of ``last_seen`` [N] over valid rows that ever
    replied (``last_seen > 0``); -inf for buckets with no such row.
    float32 [160]."""
    return _last(_valid_buckets(self_id, ids, valid), valid, last_seen)


def maintenance_sweep(self_id, ids, valid, last_reply, now, age,
                      generator=None, *, device=None):
    """The bucket-maintenance pass over the [N, 5] id table, everything
    ``Dht::bucketMaintenance`` needs:

    - ``counts``  int32 [160]     bucket occupancy
    - ``last``    float32 [160]   per-bucket last reply, -inf when no
                                  peer of the bucket ever replied
    - ``stale``   bool [160]      occupied and silent for ``age`` seconds
    - ``targets`` keys [160, 5]   a uniform refresh id in every bucket's
                                  range; the caller picks the stale rows

    ``self_id`` / ``ids``: key tensors or uint32 numpy; ``valid`` bool
    [N]; ``last_reply`` [N] seconds (cast to float32).  ``now`` and
    ``age`` are float32 scalars, as they are inside the JAX package's
    jit, and so is ``now - age``.  ``generator``: a ``torch.Generator``
    on the device for the targets' bits.  ``device=None`` is the card.
    """
    dev = resolve_device(device)
    self_id, ids = as_keys(self_id, dev), as_keys(ids, dev)
    valid = torch.as_tensor(valid).to(dev)
    last_reply = torch.as_tensor(last_reply).to(dev)
    bm = _valid_buckets(self_id, ids, valid)       # one bucket pass, shared
    counts = _counts(bm)
    last = _last(bm, valid, last_reply)
    f32 = dict(dtype=torch.float32, device=dev)
    stale = (counts > 0) & (last < torch.tensor(now, **f32)
                            - torch.tensor(age, **f32))
    targets = random_id_in_bucket(
        self_id, torch.arange(ID_BITS, device=dev), generator)
    return counts, last, stale, targets


def maintenance_sweep_batched(self_ids, ids, valid, last_reply, now, age):
    """:func:`maintenance_sweep`'s occupancy and staleness for M nodes at
    once — the JAX package's ``jax.vmap(maintenance_sweep)`` over a
    batch of ``self_ids`` (the swarm stepper's rotating sample).

    ``self_ids`` keys [M, 5]; ``ids`` keys [N, 5]; ``valid`` bool [M, N]
    (row m: which ids node m sees); ``last_reply`` [N] seconds (float32,
    shared); ``now`` / ``age`` host floats, taken as float32.  Returns
    (counts int32 [M, 160], stale bool [M, 160]), row m equal to
    ``maintenance_sweep(self_ids[m], ids, valid[m], ...)``'s.  The refresh
    targets and the per-bucket last reply are not computed: the swarm
    reads neither.

    One launch chain for the batch, not M sweeps.  A bucket is stale
    when it is occupied and its latest reply is older than ``now - age``:
    no row of it replied at or after that threshold.  So staleness is a
    count too, and both come from one integer scatter over [M, 2·161]
    bins (bucket, and whether the row replied in time): exact, with no
    float atomics."""
    dev = self_ids.device
    M = self_ids.shape[0]
    nb = ID_BITS + 1
    b = torch.clamp(common_bits(self_ids[:, None, :], ids[None, :, :]),
                    max=MAX_BUCKET)
    bm = torch.where(valid, b, ID_BITS).long()
    ls = _reply_times(last_reply)
    thr = np.float32(now) - np.float32(age)
    # last < thr fails exactly when some valid replied row has ls >= thr
    # (rows that never replied read -inf, below any finite threshold)
    fresh = valid & (ls > 0) & ~(ls < float(thr))
    slot = (torch.arange(M, device=dev)[:, None] * (2 * nb) + bm
            + nb * fresh.long())
    bins = torch.zeros(M * 2 * nb, dtype=torch.int32, device=dev)
    bins.index_add_(0, slot.reshape(-1),
                    torch.ones(slot.numel(), dtype=torch.int32, device=dev))
    bins = bins.view(M, 2, nb)[:, :, :ID_BITS]
    counts = bins.sum(dim=1, dtype=torch.int32)
    # a bucket with no replied row reads -inf: stale only below a
    # threshold above -inf (as ``-inf < now - age`` in the single sweep)
    stale = (counts > 0) & (bins[:, 1] == 0) & bool(-np.inf < thr)
    return counts, stale


def random_id_in_bucket(self_id: torch.Tensor, bucket,
                        generator=None) -> torch.Tensor:
    """Uniform random id in bucket ``bucket``'s range: shares the first
    ``bucket`` bits with self, differs at bit ``bucket``, random after
    (↔ RoutingTable::randomId).  ``bucket`` int [...]; returns key
    tensor [..., 5].  Bits come from ``generator`` (torch's default
    generator of the device when None)."""
    bucket = torch.as_tensor(bucket, device=self_id.device)
    rand = torch.randint(-(1 << 31), 1 << 31, tuple(bucket.shape) + (N_LIMBS,),
                         dtype=torch.int32, device=self_id.device,
                         generator=generator)
    return _random_id_from_bits(self_id, bucket, rand)


def _random_id_from_bits(self_id: torch.Tensor, bucket,
                         rand: torch.Tensor) -> torch.Tensor:
    """:func:`random_id_in_bucket` on given random bits: ``rand`` int32
    [..., 5] holding raw uint32 bit patterns (not keys).  The JAX
    package's ``random_id_in_bucket`` with the same bits gives the same
    id."""
    bucket = torch.as_tensor(bucket, dtype=torch.int64,
                             device=self_id.device)
    shape = tuple(bucket.shape) + (N_LIMBS,)
    masks = prefix_masks(bucket)
    me = self_id.expand(shape)
    out = (((me ^ FLIP) & masks) | (rand & ~masks)) ^ FLIP
    # force the differing bit: flip self's bit at ``bucket``
    return set_bit(out, bucket, ~get_bit(me, bucket))


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 modulo 2^32, as the JAX package's int32 math wraps."""
    return (((x + (1 << 31)) % (1 << 32)) - (1 << 31)).to(torch.int32)


def estimate_network_size(self_id, ids, valid, k: int = 8) -> torch.Tensor:
    """Network size estimate k·2^depth (↔ NodeStats, callbacks.h:47-67):
    depth = the deepest d such that ≥ k valid nodes share a ≥ d-bit
    prefix with self; the node count when no such d exists.  0-d int32,
    with the JAX package's int32 wrap of k·2^30."""
    counts = bucket_counts(self_id, ids, valid)
    ge = counts.flip(0).cumsum(0).flip(0)          # nodes with cb >= d
    idx = torch.arange(ID_BITS, device=counts.device)
    depth = torch.where(ge >= k, idx, -1).max()
    est = k * torch.pow(2, depth.clamp(0, 30))
    return torch.where(depth < 0, counts.sum(dtype=torch.int32),
                       _wrap_int32(est))
