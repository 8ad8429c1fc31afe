"""Carry node-table state across from the JAX package as numpy arrays.

The JAX ``NodeTable`` keeps its slab as numpy columns and its snapshot
as device arrays; a caller hands those over as numpy (``tbl._ids``,
``np.asarray(snap.sorted_ids)`` …) and gets the port's objects with the
same contents.  Nothing here imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.table import TARGET_NODES, NodeTable, Snapshot
from .infohash import InfoHash
from .ops import ids as IK

SLAB_COLUMNS = ("ids", "valid", "expired", "time_reply", "time_seen",
                "auth_err", "bucket")


def node_table_from_numpy(self_id: bytes, state: dict, addrs=None,
                          device=None, *, k: int = TARGET_NODES) -> NodeTable:
    """A port ``NodeTable`` holding the slab ``state``: the columns
    ``ids``, ``valid``, ``expired``, ``time_reply``, ``time_seen``,
    ``auth_err``, ``bucket`` (one row each) and ``bucket_count`` [160].
    ``addrs``: one address per row, or None.

    ``row_of`` is rebuilt from the valid rows and the free list from the
    others (lowest row handed out first); rows therefore keep their
    numbers, so ``find_closest`` answers with the same rows.  Bucket
    replacement candidates are not carried.
    """
    cap = int(np.asarray(state["ids"]).shape[0])
    t = NodeTable(InfoHash(self_id), k=k, capacity=cap, device=device)
    for name in SLAB_COLUMNS:
        col = getattr(t, "_" + name)
        col[...] = np.asarray(state[name], dtype=col.dtype)
    t._bucket_count[...] = np.asarray(state["bucket_count"], np.int32)
    if addrs is not None:
        if len(addrs) != cap:
            raise ValueError(f"addrs has {len(addrs)} entries for {cap} rows")
        t._addrs = list(addrs)
    rows = np.nonzero(t._valid)[0]
    raw = IK.ids_to_bytes(t._ids[rows])
    t._row_of = {raw[i].tobytes(): int(r) for i, r in enumerate(rows)}
    t._free = [int(r) for r in np.nonzero(~t._valid)[0][::-1]]
    return t


def snapshot_from_numpy(sorted_ids, perm, n_valid, device=None) -> Snapshot:
    """A port ``Snapshot`` of a sorted table: ``sorted_ids`` uint32
    [N,5], ``perm`` int32 [N] sorted→slab row (-1 past ``n_valid``)."""
    dev = resolve_device(device)
    return Snapshot(IK.to_keys(sorted_ids, dev),
                    torch.from_numpy(np.asarray(perm, np.int32).copy()).to(dev),
                    int(n_valid), version=0, mask_key=("reachable", 0))
