"""Batched listener-table membership match.

The port of the JAX package's ``ops/listener_match.py``: "which of this
ingest wave's stored-put keys have listeners?" answered for the whole
wave in one XOR-equality pass over the listener table (``[L, 5]`` key
ids, tombstoned rows ``valid=False``), instead of a dict probe per put.
The JAX function is a ``jax.jit`` program; here it is plain torch on
the table's device, the same compare as the hot-cache probe
(:func:`~opendht_tpu_torch.ops.cache_probe.first_equal`: five ``[S, L]``
limb compares ANDed in place, the lowest matching live row).  At the
canonical wave S=64 and L=1,000,000 that is 64 MB of mask, not the
320 MB of a ``[S, L, 5]`` compare.  ``match_host`` is the JAX package's
bit-exact numpy mirror, copied as is.
"""

from __future__ import annotations

import numpy as np

from .cache_probe import first_equal
from .ids import N_LIMBS

#: default bounded listener table capacity (slots of 20-byte key ids)
LISTENER_CAPACITY = 1024


def listener_match(table_ids, valid, stored, device=None):
    """One batched XOR-equality pass: ``(hit [S] bool, slot [S] int32)``
    for a wave's stored-put keys against the listener table.

    ``table_ids``: key tensor (or uint32 ids) ``[L, 5]``, ``valid``: bool
    ``[L]`` (tombstoned rows never match), ``stored``: ``[S, 5]``.
    ``slot[i]`` is the matching table row, -1 on a miss."""
    return first_equal(table_ids, valid, stored, device)


def match_host(table_ids, valid, stored) -> tuple:
    """Bit-exact numpy mirror of :func:`listener_match` — the tests'
    oracle and the ``listen_batching="off"`` path's membership decision
    (the two delivery paths must reach the same hit set)."""
    t = np.asarray(table_ids, np.uint32).reshape(-1, N_LIMBS)
    v = np.asarray(valid, bool).reshape(-1)
    s = np.asarray(stored, np.uint32).reshape(-1, N_LIMBS)
    eq = np.all(s[:, None, :] == t[None, :, :], axis=-1) & v[None, :]
    hit = eq.any(axis=1)
    slot = np.where(hit, eq.argmax(axis=1).astype(np.int32),
                    np.int32(-1))
    return hit, slot
