"""Batched hot-cache membership probe.

The port of the JAX package's ``ops/cache_probe.py``.  The hot-value
cache (``opendht_tpu_torch/hotcache.py``) keeps a bounded device table of
the hot keys' ids; before an ingest wave launches its ``[Q]``
closest-node resolve, one XOR-compare pass answers "which of the wave's
targets are cached?" — a hit peels the carried get off the wave (it is
served from the cache's host-side value payloads), the misses fall
through to the unchanged lookup.  The JAX function is a ``jax.jit``
program; here it is plain torch on the table's device.

A match is all five limbs equal (XOR distance exactly zero), and the
slot is the lowest matching valid row, as the JAX ``argmax`` of the
mask gives.  The compare is five ``[Q, C]`` limb compares ANDed in
place, never a ``[Q, C, 5]`` temporary: ``listener_match`` runs the
same compare at L up to a million rows.  ``probe_host`` is the JAX
package's bit-exact numpy mirror, copied as is.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .ids import N_LIMBS, as_keys

#: default bounded cache table capacity (slots of 20-byte ids); the
#: [Q, C] probe stays tiny against the [Q, N] lookup it replaces
CACHE_CAPACITY = 64


def first_equal(table, valid, queries, device=None):
    """``(hit [Q] bool, slot [Q] int32)``: for each query id, whether a
    valid row of ``table`` equals it and the lowest such row (-1 on a
    miss).  ``table`` [L, 5] and ``queries`` [Q, 5] are key tensors or
    uint32 ids, ``valid`` bool [L]; the work runs on ``table``'s device
    when it is a tensor, else on ``device`` (None = the card).  Nothing
    here reads the device back."""
    dev = table.device if isinstance(table, torch.Tensor) \
        else resolve_device(device)
    t = as_keys(table, dev).reshape(-1, N_LIMBS)
    q = as_keys(queries, dev).reshape(-1, N_LIMBS)
    v = torch.as_tensor(valid, dtype=torch.bool, device=dev).reshape(-1)
    if t.shape[0] == 0:
        return (torch.zeros(q.shape[0], dtype=torch.bool, device=dev),
                torch.full((q.shape[0],), -1, dtype=torch.int32, device=dev))
    eq = q[:, None, 0] == t[None, :, 0]                       # [Q, L]
    for limb in range(1, N_LIMBS):
        eq &= q[:, None, limb] == t[None, :, limb]
    eq &= v[None, :]
    hit = eq.any(dim=1)
    # argmax returns the first maximum: the lowest matching row
    first = eq.view(torch.uint8).argmax(dim=1).to(torch.int32)
    return hit, torch.where(hit, first, -1)


def cache_probe(cache_ids, valid, targets, device=None):
    """One batched XOR-compare over a wave: ``(hit [Q] bool, slot [Q]
    int32)`` for the wave's targets against the cache table.

    ``cache_ids``: key tensor (or uint32 ids) ``[C, 5]``, ``valid``: bool
    ``[C]`` (False rows never match), ``targets``: ``[Q, 5]``.
    ``slot[i]`` is the matching cache row, -1 on a miss."""
    return first_equal(cache_ids, valid, targets, device)


def probe_host(cache_ids, valid, targets) -> tuple:
    """Bit-exact numpy mirror of :func:`cache_probe` — the tests' oracle
    and the batching-off path's per-op membership test (the two serving
    paths must take the same decision)."""
    c = np.asarray(cache_ids, np.uint32).reshape(-1, N_LIMBS)
    v = np.asarray(valid, bool).reshape(-1)
    t = np.asarray(targets, np.uint32).reshape(-1, N_LIMBS)
    eq = np.all(t[:, None, :] == c[None, :, :], axis=-1) & v[None, :]
    hit = eq.any(axis=1)
    slot = np.where(hit, eq.argmax(axis=1).astype(np.int32),
                    np.int32(-1))
    return hit, slot
