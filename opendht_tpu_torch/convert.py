"""Carry node-table state across from the JAX package as numpy arrays.

The JAX ``NodeTable`` keeps its slab as numpy columns, its snapshot as
device arrays and its churn view as numpy; a caller hands those over as
numpy (``tbl._ids``, ``np.asarray(snap.sorted_ids)``, ``view.tomb_np``
…) and gets the port's objects with the same contents.  Nothing here
imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.table import DELTA_CAP, TARGET_NODES, ChurnView, NodeTable, \
    Snapshot
from .infohash import InfoHash
from .ops import ids as IK

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
        t._addrs = list(addrs)
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
