"""Sharded node tables over a device mesh, with an exact top-k merge — the
port of the JAX package's ``parallel/sharded.py``.

- mesh axis ``t`` (table-parallel): the [N, 5] id table is sharded by
  rows; every shard scans or searches only its rows.
- mesh axis ``q`` (query-parallel): the query batch is split; each q row
  of the mesh answers its slice of the queries.

One lookup = per-shard exact top-k (a scan or a sorted-window lookup),
then an all-gather of the per-shard winners and one [Q_local, n_t·k]
lexicographic re-sort.  The merge is exact: the global top-k is a subset
of the union of the per-shard top-ks.

**The mesh in torch.**  The JAX package is one controller driving a
``jax.sharding.Mesh`` through ``shard_map``; here it is one Python
process driving a :class:`Mesh`, a ``(q, t)`` array of ``torch.device``s:

- a shard's operands are tensors on its device (``partition.place``);
- each per-shard program runs in a Python loop over the shards, and its
  launches are asynchronous (nothing in the loop reads the device back
  unless a step below says so);
- the collectives are explicit tensor operations on one merge device
  (``mesh.devices[qi, 0]`` for q row qi): ``all_gather`` is a
  ``torch.stack`` of the shards' results moved there, ``psum`` their
  sum, ``pmax`` their ``maximum``.

A device may repeat in the mesh.  ``make_mesh(n, devices="cpu")`` gives
n virtual shards on the CPU, as the JAX tests run 8 virtual CPU devices;
``Dht(device="cpu")`` with ``resolve_mesh_t = t`` builds such a mesh, so
the CPU tests drive the node's sharded path.  On one card, t virtual
shards on ``cuda:0`` are BASELINE config 5's one-chip form.  A multi-GPU
host (shards on ``cuda:0..t-1``, copies between cards) runs the same
code, but is untested.  ``torch.distributed`` is not used: the JAX
package has no multi-process form either.

Results are bit-identical to the unsharded functions
(tests/test_torch_sharded.py), and to the JAX package's sharded ones.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import telemetry
from .._device import resolve_device
from ..ops.ids import N_LIMBS, as_keys, to_keys
from ..ops.xor_topk import mask_invalid, select_topk, xor_topk
from ..ops.sorted_table import (build_prefix_lut, default_lut_bits,
                                expand_table, expanded_topk, scan_tile,
                                sort_table, window_topk)
from ..core.search import (ALPHA, SEARCH_NODES, TARGET_NODES,
                           _guarded_lower_bound, _lookup_engine,
                           _lut_block_bounds, record_wave,
                           table_primitives)
from .partition import (DP_AXIS_RULES, TABLE_AXIS_RULES, P, ShardedTensor,
                        TableState, as_id_keys, from_t_shards, place,
                        replicated, shard_put, shard_table_state)

_I32 = torch.int32
_M32 = 0xFFFFFFFF


class Mesh:
    """A ``(q, t)`` array of ``torch.device``s with axis names
    ``("q", "t")`` — the counterpart of ``jax.sharding.Mesh``.
    ``shape`` maps each axis name to its size; ``merge_device`` is where
    results land (device (0, 0))."""

    axis_names = ("q", "t")

    def __init__(self, devices):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != 2:
            raise ValueError(f"mesh devices must be a (q, t) array, got "
                             f"shape {arr.shape}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx, d in np.ndenumerate(arr):
            self.devices[idx] = torch.device(d)
        self.shape = {"q": int(arr.shape[0]), "t": int(arr.shape[1])}

    @property
    def merge_device(self) -> torch.device:
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return (f"Mesh(q={self.shape['q']}, t={self.shape['t']}, "
                f"devices={[str(d) for d in self.devices.reshape(-1)]})")


def make_mesh(n_devices: Optional[int] = None, *, q: Optional[int] = None,
              t: Optional[int] = None, devices=None) -> Mesh:
    """Build a 2-D (q=query, t=table) mesh over ``n_devices`` devices.

    ``devices`` None: the first ``n_devices`` CUDA cards (default: all);
    raises RuntimeError without a card or when fewer exist.  Otherwise an explicit device
    list (its first ``n_devices``), or one device (a ``torch.device`` or
    a string such as ``"cpu"``) repeated ``n_devices`` times: a virtual
    mesh.  Default split: t gets the larger factor (table rows dominate
    memory; queries are cheap to replicate), as in the JAX package."""
    if devices is None:
        resolve_device(None)              # raises without a card
        avail = torch.cuda.device_count()
        n = avail if n_devices is None else int(n_devices)
        if n < 1 or avail < n:
            raise RuntimeError(
                f"make_mesh: {n} CUDA device(s) asked for, {avail} "
                "available; pass devices= for a virtual mesh")
        devs = [torch.device("cuda", i) for i in range(n)]
    elif isinstance(devices, (str, torch.device)):
        n = 1 if n_devices is None else int(n_devices)
        devs = [torch.device(devices)] * n
    else:
        devs = [torch.device(d) for d in devices]
        n = len(devs) if n_devices is None else int(n_devices)
        if len(devs) < n:
            raise ValueError(f"make_mesh: {n} devices asked for, "
                             f"{len(devs)} given")
        devs = devs[:n]
    if q is None and t is None:
        # largest power-of-two factor ≤ sqrt for q, rest for t
        q = 1
        while q * 2 <= n // (q * 2) and n % (q * 4) == 0:
            q *= 2
        t = n // q
    elif q is None:
        q = n // t
    elif t is None:
        t = n // q
    if q * t != n:
        raise ValueError(f"mesh {q}x{t} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(q, t))


def pad_to_multiple(arr: np.ndarray, m: int, axis: int = 0, fill=0):
    """Pad `arr` along `axis` to a multiple of `m`.  Returns (padded, n)."""
    n = arr.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return arr, n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill), n


_DTYPES = {"int32": (torch.int32, np.int32), "bool": (torch.bool, bool),
           "float32": (torch.float32, np.float32)}


def _as_operand(x, kind: str):
    """Normalize one entry-point operand for placement: ``"ids"`` → a key
    tensor (uint32 host ids are converted on the host, so placement
    slices them there), ``"int32"`` / ``"bool"`` / ``"float32"`` → a
    tensor of that dtype.  A placed leaf passes through."""
    if isinstance(x, ShardedTensor):
        return x
    if kind == "ids":
        return as_id_keys(x)
    tdt, ndt = _DTYPES[kind]
    if isinstance(x, torch.Tensor):
        return x.to(tdt)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, ndt)))


def _gather_and_merge(dists, gidxs, k: int, dev):
    """The all_gather of per-shard winners and the re-select of the top-k,
    on ``dev``.  Stacking gives [n_t, Qs, k]; moving the shard axis
    inside puts each query's candidates in shard-major order, and
    ``select_topk`` breaks full ties by position, as in the JAX package."""
    n_t = len(dists)
    all_dist = torch.stack([d.to(dev) for d in dists])   # [n_t, Qs, k, 5]
    all_idx = torch.stack([i.to(dev) for i in gidxs])    # [n_t, Qs, k]
    Qs = all_dist.shape[1]
    cd = all_dist.movedim(0, 1).reshape(Qs, n_t * k, N_LIMBS)
    ci = all_idx.movedim(0, 1).reshape(Qs, n_t * k)
    d, i, inv = select_topk(cd, ci, (ci < 0).to(_I32), k)
    return mask_invalid(d, i, inv)


def _cat_rows(mesh, parts):
    """Per-q-row results (tensors or tuples of them) concatenated on the
    merge device — the query axis' gather."""
    dev = mesh.merge_device
    if isinstance(parts[0], tuple):
        return tuple(torch.cat([p[j].to(dev) for p in parts])
                     for j in range(len(parts[0])))
    return torch.cat([p.to(dev) for p in parts])


def sharded_xor_topk(mesh: Mesh, queries, table, *, k: int = 8,
                     tile: int = 4096, valid=None):
    """Exact k XOR-closest over a row-sharded table (full-scan path).

    queries: [Q, 5] keys or uint32 ids, Q divisible by mesh.shape['q'].
    table:   [N, 5], N divisible by mesh.shape['t'] (pad with
             ``valid=False`` rows via :func:`pad_to_multiple`).
    valid:   bool [N] or None.

    Returns (dist [Q, k, 5] keys, idx [Q, k] int32 global row indices,
    -1 pad) on the mesh's merge device.
    """
    N = int(table.shape[0])
    shard_n = N // mesh.shape["t"]
    if valid is None:
        valid = torch.ones(N, dtype=torch.bool)
    ops = shard_put(mesh, {"queries": _as_operand(queries, "ids"),
                           "table": _as_operand(table, "ids"),
                           "valid": _as_operand(valid, "bool")},
                    TABLE_AXIS_RULES)
    tile = min(tile, shard_n)
    rows = []
    for qi in range(mesh.shape["q"]):
        dists, gidxs = [], []
        for ti in range(mesh.shape["t"]):
            dist, idx = xor_topk(ops["queries"].shard(qi, ti),
                                 ops["table"].shard(qi, ti), k=k, tile=tile,
                                 valid=ops["valid"].shard(qi, ti))
            dists.append(dist)
            gidxs.append(torch.where(idx >= 0, idx + ti * shard_n, -1))
        rows.append(_gather_and_merge(dists, gidxs, k,
                                      mesh.devices[qi, 0]))
    return _cat_rows(mesh, rows)


def sharded_sort_table(mesh: Mesh, table, valid=None):
    """Sort each table shard locally (rows stay on their device; no
    collectives).  Returns (sorted_ids [N, 5], perm [N], n_valid [n_t]),
    each a ``P('t', ...)`` :class:`~.partition.ShardedTensor`, to feed
    repeated :func:`sharded_window_lookup` calls, so a stable table is
    sorted once and amortized across query batches."""
    N = int(table.shape[0])
    if valid is None:
        valid = torch.ones(N, dtype=torch.bool)
    ops = shard_put(mesh, {"table": _as_operand(table, "ids"),
                           "valid": _as_operand(valid, "bool")},
                    TABLE_AXIS_RULES)
    s, p, nv = [], [], []
    for ti in range(mesh.shape["t"]):
        sorted_ids, perm, n_valid = sort_table(ops["table"].shard(0, ti),
                                               ops["valid"].shard(0, ti))
        s.append(sorted_ids)
        p.append(perm)
        nv.append(n_valid.reshape(1))
    return (from_t_shards(mesh, s), from_t_shards(mesh, p),
            from_t_shards(mesh, nv))


def sharded_expand_table(mesh: Mesh, sorted_ids, n_valid, *, bits: int = 16):
    """Build each shard's expanded window-row table and prefix LUT locally
    (no collectives) from :func:`sharded_sort_table` output.  Returns
    (expanded [n_t·NB, 970], lut [n_t, 2^bits+1]), both ``P('t', None)``,
    to feed the expanded route of :func:`sharded_window_lookup`."""
    ops = shard_put(mesh, {"sorted_ids": _as_operand(sorted_ids, "ids"),
                           "n_valid": _as_operand(n_valid, "int32")},
                    TABLE_AXIS_RULES)
    ex, lu = [], []
    for ti in range(mesh.shape["t"]):
        shard = ops["sorted_ids"].shard(0, ti)
        ex.append(expand_table(shard))
        lu.append(build_prefix_lut(shard, ops["n_valid"].shard(0, ti)[0],
                                   bits=bits)[None])
    return from_t_shards(mesh, ex), from_t_shards(mesh, lu)


class ShardedWindowLaunch:
    """The launched half of :func:`sharded_window_lookup`: every shard's
    window lookup enqueued, nothing read back.  :meth:`finish` reads the
    certificates, runs the fallback, maps rows and merges."""

    __slots__ = ("mesh", "k", "shard_n", "ops", "outs", "event", "_result")

    def __init__(self, mesh, k, shard_n, ops, outs):
        self.mesh, self.k, self.shard_n = mesh, k, shard_n
        self.ops, self.outs = ops, outs
        self._result = None
        self.event = None
        if mesh.merge_device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(mesh.merge_device))

    def ready(self) -> bool:
        return self.event is None or bool(self.event.query())

    def finish(self):
        """(dist [Q, k, 5] keys, idx [Q, k] global rows) on the merge
        device.

        The certificate fallback.  The JAX package reruns a shard's
        whole batch through the exact scan under ``lax.cond(all(cert))``
        and keeps the certified window rows.  Here the host reads one
        bool per shard (all shards' in one device→host copy, as
        ``PendingLookup.consume`` reads the unsharded certificate) and
        rescans only the uncertified rows of a shard that has any — the
        same rows, since each row of the scan is independent.  The JAX
        tile rule (4,096, or 512 for shards over 8M rows) bounds the
        buffers ``lax.cond`` allocates for the whole batch even when the
        branch is not taken; a rescan here allocates only for its own
        rows, and ``scan_tile`` holds those buffers under ~1 GiB."""
        if self._result is not None:
            return self._result
        mesh, k, shard_n, ops = self.mesh, self.k, self.shard_n, self.ops
        nq, nt = mesh.shape["q"], mesh.shape["t"]
        flags = torch.stack([
            self.outs[qi][ti][2].all().to(mesh.merge_device)
            for qi in range(nq) for ti in range(nt)]).tolist()
        rows = []
        for qi in range(nq):
            dists, gidxs = [], []
            for ti in range(nt):
                dist, sidx, cert = self.outs[qi][ti]
                q = ops["queries"].shard(qi, ti)
                shard = ops["sorted_ids"].shard(qi, ti)
                nv = ops["n_valid"].shard(qi, ti)[0]
                if not flags[qi * nt + ti]:
                    bad = torch.nonzero(~cert).reshape(-1)
                    d2, i2 = xor_topk(
                        q[bad], shard, k=k,
                        tile=scan_tile(shard_n, int(bad.numel())),
                        valid=torch.arange(shard_n, device=q.device) < nv)
                    dist, sidx = dist.clone(), sidx.clone()
                    dist[bad] = d2
                    sidx[bad] = i2
                perm = ops["perm"].shard(qi, ti)
                r = torch.where(sidx >= 0,
                                perm[sidx.clamp(0, shard_n - 1).long()], -1)
                dists.append(dist)
                gidxs.append(torch.where(r >= 0, r + ti * shard_n, -1))
            rows.append(_gather_and_merge(dists, gidxs, k,
                                          mesh.devices[qi, 0]))
        self._result = _cat_rows(mesh, rows)
        self.ops = self.outs = None
        return self._result


def sharded_window_launch(mesh: Mesh, queries, sorted_ids, perm, n_valid, *,
                          k: int = 8, window: int = 128, expanded=None,
                          lut=None) -> ShardedWindowLaunch:
    """Enqueue :func:`sharded_window_lookup`'s per-shard lookups without a
    host sync; ``.finish()`` completes it."""
    N = int(sorted_ids.shape[0])
    shard_n = N // mesh.shape["t"]
    tree = {"queries": _as_operand(queries, "ids"),
            "sorted_ids": _as_operand(sorted_ids, "ids"),
            "perm": _as_operand(perm, "int32"),
            "n_valid": _as_operand(n_valid, "int32")}
    if expanded is not None:
        tree["expanded"] = _as_operand(expanded, "ids")
        tree["local_lut"] = _as_operand(lut, "int32")
    ops = shard_put(mesh, tree, TABLE_AXIS_RULES)
    window = min(window, shard_n)
    outs = []
    for qi in range(mesh.shape["q"]):
        row = []
        for ti in range(mesh.shape["t"]):
            q = ops["queries"].shard(qi, ti)
            shard = ops["sorted_ids"].shard(qi, ti)
            nv = ops["n_valid"].shard(qi, ti)[0]
            if expanded is not None:
                # "auto": the window_select kernel on the card
                row.append(expanded_topk(
                    shard, ops["expanded"].shard(qi, ti), nv, q, k=k,
                    lut=ops["local_lut"].shard(qi, ti)[0]))
            else:
                # "auto": the lex_topk_select kernel on the card
                row.append(window_topk(shard, nv, q, k=k, window=window))
        outs.append(row)
    return ShardedWindowLaunch(mesh, k, shard_n, ops, outs)


def sharded_window_lookup(mesh: Mesh, queries, sorted_ids, perm, n_valid, *,
                          k: int = 8, window: int = 128, expanded=None,
                          lut=None):
    """Exact k XOR-closest over a pre-sorted row-sharded table — the
    repeated-lookup fast path.  Takes the output of
    :func:`sharded_sort_table`; each shard answers with its local window
    top-k (per-query certificate; uncertified rows fall back to the
    shard-local exact scan), then the per-shard winners are merged.

    Pass ``expanded``/``lut`` from :func:`sharded_expand_table` to take
    the expanded row-gather route per shard (the ``window_select`` kernel
    on the card) instead of the per-element window gather (the
    ``lex_topk_select`` kernel on the card).

    Same contract as :func:`sharded_xor_topk`: returns (dist [Q, k, 5]
    keys, idx [Q, k]) where idx are **global original-table row
    indices** (-1 padding).
    """
    return sharded_window_launch(mesh, queries, sorted_ids, perm, n_valid,
                                 k=k, window=window, expanded=expanded,
                                 lut=lut).finish()


def sharded_lookup(mesh: Mesh, queries, table, *, k: int = 8,
                   window: int = 128, valid=None):
    """One-shot convenience: :func:`sharded_sort_table` +
    :func:`sharded_window_lookup`."""
    sorted_ids, perm, n_valid = sharded_sort_table(mesh, table, valid)
    return sharded_window_lookup(mesh, queries, sorted_ids, perm, n_valid,
                                 k=k, window=window)


def _tp_row(mesh, qi: int, state: TableState, targets, q_index, q_total,
            seed_u: int, *, k, alpha, search_nodes, max_hops, state_limbs):
    """The table-parallel engine for q row ``qi``: the search state lives
    on the row's merge device; the table primitives run per shard."""
    a = state.arrays
    nt = mesh.shape["t"]
    edev = mesh.devices[qi, 0]
    weighted = state.boundaries is not None
    shard_n = state.shard_n
    bases, widths = state.shard_bases(), state.shard_widths()
    shards = [a["sorted_ids"].shard(qi, ti) for ti in range(nt)]
    devs = [s.device for s in shards]
    # per-shard positioning over the shard's own valid rows (one host
    # read per shard: the tier of the guarded search, as unsharded)
    lowers = [_guarded_lower_bound(shards[ti], widths[ti],
                                   a["local_lut"].shard(qi, ti)[0])
              for ti in range(nt)]
    block_lut = a["block_lut"].shard(qi, 0)

    def lower(flat):
        # global lower bound = Σ_shards (local rows < q): the global
        # sorted order is the in-order concatenation of the shard
        # ranges (the JAX package's psum, once per wave)
        tot = None
        for ti in range(nt):
            r = lowers[ti](flat.to(devs[ti])).to(edev)
            tot = r if tot is None else tot + r
        return tot

    def block_bounds(t0, prefix_len):
        # no collective: the replicated global block LUT, read locally
        return _lut_block_bounds(block_lut, t0, prefix_len)

    def gather_planar(rows, limbs=N_LIMBS):
        # distributed row fetch: the owning shard contributes the row's
        # limbs, every other shard zeros, and the sum reassembles it
        # (the JAX package's psum).  Rows the engine marks absent land
        # on no shard and come back 0, masked by the engine.  Weighted
        # shards own exactly their width; the uniform test keeps the
        # slab width, as in JAX.
        flat = rows.reshape(-1)
        tot = None
        for ti in range(nt):
            f = flat.to(devs[ti]) - bases[ti]
            ok = (f >= 0) & (f < (widths[ti] if weighted else shard_n))
            g = shards[ti][f.clamp(0, shard_n - 1).long(), :limbs]
            g = torch.where(ok[:, None], g, 0).to(edev)
            tot = g if tot is None else tot + g
        return [tot[:, l].reshape(rows.shape) for l in range(limbs)]

    return _lookup_engine(gather_planar, lower, int(a["n_valid"]),
                          targets, q_index, q_total, seed_u, k=k,
                          alpha=alpha, search_nodes=search_nodes,
                          max_hops=max_hops, state_limbs=state_limbs,
                          block_bounds=block_bounds)


def build_tp_lookup(mesh: Mesh, shard_n: int, q_total: int, k: int,
                    alpha: int, search_nodes: int, max_hops: int,
                    state_limbs: int = N_LIMBS, weighted: bool = False):
    """The table-sharded iterative lookup for one geometry: returns
    ``fn(state, targets, seed)`` over a :class:`~.partition.TableState`
    (:func:`~.partition.shard_table_state`) and ``P('q', None)``-placed
    targets.  The JAX package compiles one program per geometry here;
    the port has nothing to compile, so this binds the geometry and
    checks the state against it.

    Per round the engine does one distributed row fetch (owner shard
    gathers, the rest give zeros, one sum — the JAX package's one psum),
    and reply-block edges are two local reads of the replicated global
    block LUT.  Positioning is one sum of per-shard lower bounds, once
    per wave."""
    q_local = q_total // mesh.shape["q"]

    def fn(state: TableState, targets: ShardedTensor, seed: int):
        if state.shard_n != shard_n or (state.boundaries is not None) \
                != weighted:
            raise ValueError("table state does not match the geometry "
                             "build_tp_lookup was given")
        outs = []
        for qi in range(mesh.shape["q"]):
            edev = mesh.devices[qi, 0]
            q_index = qi * q_local + torch.arange(q_local, dtype=_I32,
                                                  device=edev)
            outs.append(_tp_row(
                mesh, qi, state, targets.shard(qi, 0), q_index, q_total,
                int(seed) & _M32, k=k, alpha=alpha,
                search_nodes=search_nodes, max_hops=max_hops,
                state_limbs=state_limbs))
        dev = mesh.merge_device
        return {key: torch.cat([o[key].to(dev) for o in outs])
                for key in ("nodes", "dist", "hops", "converged")}
    return fn


def tp_simulate_lookups(mesh: Mesh, sorted_ids=None, n_valid=None,
                        targets=None, *, seed: int = 0, k: int = TARGET_NODES,
                        alpha: int = ALPHA, search_nodes: int = SEARCH_NODES,
                        max_hops: int = 48, state_limbs: int = N_LIMBS,
                        state: "TableState | None" = None):
    """Iterative lookups with the sorted table ROW-SHARDED over ``t``:
    tables larger than one device's memory are searched, not just
    scanned.

    ``sorted_ids`` must be GLOBALLY sorted; each ``t`` shard then owns
    one contiguous range of the global sorted order, which makes the
    distributed primitives cheap (see :func:`build_tp_lookup`).  Search
    state is split over ``q``.  Results are BIT-IDENTICAL to
    :func:`~opendht_tpu_torch.core.search.simulate_lookups` on the same
    table (the reply hash is seeded by global query identity): a dict
    ``nodes`` / ``dist`` / ``hops`` / ``converged`` on the merge device.

    Callers serving a stable table pass ``state=`` from
    :func:`~.partition.shard_table_state` (built once, reused across
    waves); the raw ``sorted_ids``/``n_valid`` form builds one per call.
    targets [Q, 5]: Q divisible by mesh.shape['q']; N divisible by
    mesh.shape['t'] (pad via :func:`pad_to_multiple`)."""
    if state is None:
        if sorted_ids is None or n_valid is None:
            raise ValueError("pass either (sorted_ids, n_valid) or state=")
        state = shard_table_state(mesh, sorted_ids, n_valid)
    if targets is None:
        raise ValueError("targets are required")
    Q = int(targets.shape[0])
    if Q % mesh.shape["q"]:
        raise ValueError(f"targets ({Q}) not divisible by q axis "
                         f"{mesh.shape['q']}")
    fn = build_tp_lookup(mesh, state.shard_n, Q, k, alpha, search_nodes,
                         max_hops, state_limbs, state.boundaries is not None)
    placed = shard_put(mesh, {"targets": _as_operand(targets, "ids")},
                       TABLE_AXIS_RULES)["targets"]
    reg = telemetry.get_registry()
    if not reg.enabled:
        return fn(state, placed, seed)
    # the single-device entry's envelope (core/search.py), mode="tp"
    with reg.span("dht_search_wave_seconds", record=False) as sp:
        out = fn(state, placed, seed)
        if mesh.merge_device.type == "cuda":
            torch.cuda.synchronize(mesh.merge_device)
    record_wave(out, sp.elapsed, Q, mode="tp", mesh_t=mesh.shape["t"])
    return out


def dp_simulate_lookups(mesh: Mesh, sorted_ids, n_valid, targets, *,
                        seed: int = 0, k: int = TARGET_NODES,
                        alpha: int = ALPHA, search_nodes: int = SEARCH_NODES,
                        max_hops: int = 48, lut=None,
                        state_limbs: int = N_LIMBS,
                        compact_after: "int | None" = None,
                        compact_cap: int = 0, block_mode: str = "lut"):
    """Data-parallel batched iterative lookups: targets split over the
    whole mesh (both axes, q major), sorted table replicated.  Each
    device runs the engine on its slice with the slice's global query
    ids and the whole batch's size, so the result is bit-identical to
    :func:`~opendht_tpu_torch.core.search.simulate_lookups` on the whole
    batch.  ``lut`` (built once via ``build_prefix_lut``) lets repeated
    waves skip the rebuild; when absent it is built once on the merge
    device and replicated."""
    placed = shard_put(mesh, {"targets": _as_operand(targets, "ids"),
                              "sorted_ids": _as_operand(sorted_ids, "ids")},
                       DP_AXIS_RULES)
    n = int(n_valid)
    table = placed["sorted_ids"]
    if lut is None:
        lut = build_prefix_lut(table.shard(0, 0), n,
                               bits=default_lut_bits(table.shape[0]))
    luts = replicated(mesh, lut)
    Q = int(targets.shape[0])
    nq, nt = mesh.shape["q"], mesh.shape["t"]
    q_dev = Q // (nq * nt)
    outs = []
    for qi in range(nq):
        for ti in range(nt):
            dev = mesh.devices[qi, ti]
            gather_planar, lower, block_bounds = table_primitives(
                table.shard(qi, ti), n, luts.shard(qi, ti), block_mode)
            off = (qi * nt + ti) * q_dev
            outs.append(_lookup_engine(
                gather_planar, lower, n, placed["targets"].shard(qi, ti),
                off + torch.arange(q_dev, dtype=_I32, device=dev), Q,
                int(seed) & _M32, k=k, alpha=alpha,
                search_nodes=search_nodes, max_hops=max_hops,
                state_limbs=state_limbs, compact_after=compact_after,
                compact_cap=compact_cap, block_bounds=block_bounds))
    dev = mesh.merge_device
    return {key: torch.cat([o[key].to(dev) for o in outs])
            for key in ("nodes", "dist", "hops", "converged")}


def sharded_maintenance_sweep(mesh: Mesh, self_id, ids, valid, last_reply,
                              now, age, generator=None):
    """Table-parallel twin of :func:`opendht_tpu_torch.ops.radix.
    maintenance_sweep`: occupancy, per-bucket last reply, staleness and a
    refresh target per bucket over an [N, 5] id table ROW-SHARDED over
    ``t``.  Per shard the bucket pass runs locally; the collectives are
    one sum of the [160] counts and one maximum of the [160] last-reply
    times — exact under any split, so the results are bit-identical to
    the single-device sweep.  The refresh targets depend only on
    (self_id, generator): drawn once on the merge device, as the
    single-device sweep draws them.

    ids: [N, 5] with N divisible by mesh.shape['t'] (pad with
    ``valid=False`` rows via :func:`pad_to_multiple`).  Returns (counts
    [160] int32, last [160] float32, stale [160] bool, targets [160, 5]
    keys) on the merge device."""
    from ..ops import radix
    N = int(ids.shape[0])
    if N % mesh.shape["t"]:
        raise ValueError(f"table rows ({N}) not divisible by "
                         f"t={mesh.shape['t']}; pad via pad_to_multiple")
    if valid is None:
        valid = torch.ones(N, dtype=torch.bool)
    ops = shard_put(mesh, {"ids": _as_operand(ids, "ids"),
                           "valid": _as_operand(valid, "bool"),
                           "last_reply": _as_operand(last_reply, "float32")},
                    TABLE_AXIS_RULES)
    dev = mesh.merge_device
    me = as_keys(self_id, dev).reshape(N_LIMBS)
    reg = telemetry.get_registry()
    reg.counter("dht_maintenance_sweeps_total", mode="tp").inc()
    with reg.span("dht_maintenance_sweep_seconds", mode="tp"):
        counts, last = None, None
        for ti in range(mesh.shape["t"]):
            v = ops["valid"].shard(0, ti)
            bm = radix._valid_buckets(me.to(v.device), ops["ids"].shard(0, ti),
                                      v)
            c = radix._counts(bm).to(dev)
            lt = radix._last(bm, v, ops["last_reply"].shard(0, ti)).to(dev)
            counts = c if counts is None else counts + c
            last = lt if last is None else torch.maximum(last, lt)
        f32 = dict(dtype=torch.float32, device=dev)
        stale = (counts > 0) & (last < torch.tensor(now, **f32)
                                - torch.tensor(age, **f32))
        targets = radix.random_id_in_bucket(
            me, torch.arange(radix.ID_BITS, device=dev), generator)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return counts, last, stale, targets


def _split_rows(mesh, ids):
    """Wave ids padded to a multiple of t and placed ``P('t', None)``;
    returns (placed, valid rows n)."""
    keys = ids if isinstance(ids, torch.Tensor) else to_keys(ids, "cpu")
    keys = keys.reshape(-1, N_LIMBS)
    n = int(keys.shape[0])
    pad = (-n) % mesh.shape["t"]
    if pad:
        keys = torch.cat([keys, keys.new_zeros((pad, N_LIMBS))])
    return place(mesh, P("t", None), keys), n


def sharded_sketch_update(mesh: Mesh, sketch, hist, ids):
    """Table-parallel twin of :func:`opendht_tpu_torch.ops.sketch.
    sketch_update`: the wave's observed ids ROW-SPLIT over ``t``, each
    shard building a partial count-min sketch and top-8-bit histogram,
    merged by one sum pair onto the running state.  Pad rows (to a
    multiple of t) carry weight 0.  Integer adds are exact in any order,
    so the result is bit-identical to the single-device update.  Returns
    new ``(sketch, hist)`` on the merge device (the inputs are not
    modified)."""
    from ..ops.sketch import BIN_BITS, _flat_cells
    placed, n = _split_rows(mesh, ids)
    dev = mesh.merge_device
    sketch = sketch.to(dev)
    hist = hist.to(dev)
    depth = int(sketch.shape[0])
    psk, phs = None, None
    rows_per = placed.shape[0] // mesh.shape["t"]
    for ti in range(mesh.shape["t"]):
        q = placed.shard(0, ti)
        sdev = q.device
        w = (ti * rows_per + torch.arange(q.shape[0], device=sdev)
             < n).to(torch.int32)
        part = torch.zeros_like(sketch, device=sdev)
        part.view(-1).index_add_(0, _flat_cells(part, q),
                                 w[:, None].expand(-1, depth).reshape(-1))
        bins = ((q[:, 0] >> (32 - BIN_BITS))
                + (1 << (BIN_BITS - 1))).long()
        ph = torch.zeros_like(hist, device=sdev).index_add_(0, bins, w)
        psk = part.to(dev) if psk is None else psk + part.to(dev)
        phs = ph.to(dev) if phs is None else phs + ph.to(dev)
    return sketch + psk, hist + phs


def _sharded_first_equal(mesh, table_ids, valid, probe):
    from ..ops.cache_probe import first_equal
    placed, n = _split_rows(mesh, probe)
    hits, slots = [], []
    for ti in range(mesh.shape["t"]):
        q = placed.shard(0, ti)
        h, s = first_equal(as_keys(table_ids, q.device), valid, q)
        hits.append(h)
        slots.append(s)
    hit = torch.cat([h.cpu() for h in hits])[:n].numpy()
    slot = torch.cat([s.cpu() for s in slots])[:n].numpy()
    return hit, slot


def sharded_cache_probe(mesh: Mesh, cache_ids, valid, targets):
    """Table-parallel twin of :func:`opendht_tpu_torch.ops.cache_probe.
    cache_probe`: the wave's probe targets ROW-SPLIT over ``t`` against
    the replicated cache table, each shard answering its slice — no
    collective (membership is per target).  Ragged widths pad (the pad
    rows' answers are dropped).  Returns host ``(hit [Q] bool, slot [Q]
    int32)``, bit-identical to the single-device probe."""
    return _sharded_first_equal(mesh, cache_ids, valid, targets)


def sharded_listener_match(mesh: Mesh, table_ids, valid, stored):
    """Table-parallel twin of :func:`opendht_tpu_torch.ops.listener_match.
    listener_match`: the wave's stored-put keys ROW-SPLIT over ``t``
    against the replicated listener table, each shard answering its
    slice — no collective.  Returns host ``(hit [S] bool, slot [S]
    int32)``, bit-identical to the single-device match."""
    return _sharded_first_equal(mesh, table_ids, valid, stored)
