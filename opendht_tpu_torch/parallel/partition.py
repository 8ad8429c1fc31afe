"""Declarative placement of the DHT's table state on a device mesh — the
port of the JAX package's ``parallel/partition.py``.

A list of **regex partition rules** matched against the /-joined names
of a state tree yields one :class:`PartitionSpec` per leaf, and each spec
turns into a **shard function** (slice the leaf for every mesh device and
move the slice there) and a **gather function** (reassemble the slices on
the mesh's merge device).  The JAX package hands the specs to XLA as
``NamedSharding``s; here a placed leaf is a :class:`ShardedTensor`, a
``[q, t]`` grid of tensors, one per mesh device (``sharded.Mesh``).

The named state it exists for is :func:`shard_table_state`'s tree — the
row-sharded sorted table of the table-parallel search engine:

``sorted_ids``   key tensor [N, 5]     ``P('t', None)`` — each ``t``
                 shard owns one contiguous range of the global sorted
                 order.
``local_lut``    int32 [n_t, 2^lb+1]   ``P('t', None)`` — per-shard
                 positioning LUT over the shard's own rows, built once.
``block_lut``    int32 [2^bb+1]        replicated — the GLOBAL prefix
                 LUT, the sum of the per-shard LUTs at build time.  Entry
                 p of a shard's LUT counts its valid rows with prefix < p,
                 so the sum is bit-identical to ``build_prefix_lut`` over
                 the whole table, and a search round reads reply-block
                 edges locally (``sharded.build_tp_lookup``).
``n_valid``      host int              the valid rows of the whole table.

Rules are matched first-hit in order; every leaf must match (the
catch-all ``.*`` → replicated rule closes the list).  Scalars and
one-element leaves never partition.

Where a shard's device repeats in the mesh (a virtual mesh: t shards on
one device, as the tests run them on the CPU and ``chip_smoke.py`` on one
card), ``.to(device)`` of a slice is the slice itself: placement costs
no copy.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.ids import FLIP, to_keys


class PartitionSpec(tuple):
    """Per-dimension mesh axes of one leaf, as ``jax.sharding.
    PartitionSpec``: ``None`` (not partitioned), an axis name (``"q"``,
    ``"t"``) or a tuple of names (partitioned over their product,
    first name major).  ``P()`` is fully replicated."""

    def __new__(cls, *axes):
        return tuple.__new__(cls, axes)

    def __repr__(self) -> str:
        return "P(%s)" % ", ".join(repr(a) for a in self)


P = PartitionSpec


# --------------------------------------------------------------------------
# tree helpers: dicts (keys in sorted order, as jax.tree_util flattens
# them), lists and tuples (NamedTuples by field name) are nodes, anything
# else is a leaf
# --------------------------------------------------------------------------

def _is_node(x) -> bool:
    return isinstance(x, (dict, list)) or (isinstance(x, tuple)
                                           and not isinstance(x, P))


def _children(x):
    """(key, child) pairs of a tree node."""
    if isinstance(x, dict):
        return [(k, x[k]) for k in sorted(x)]
    if hasattr(x, "_fields"):
        return list(zip(x._fields, x))
    return list(enumerate(x))


def _rebuild(x, values):
    if isinstance(x, dict):
        return dict(zip(sorted(x), values))
    if hasattr(x, "_fields"):
        return type(x)(*values)
    return type(x)(values)


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``, which share its structure)."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(tree, *rest)
    kids = _children(tree)
    others = [_children(r) for r in rest]
    return _rebuild(tree, [
        tree_map(fn, child, *(o[i][1] for o in others), is_leaf=is_leaf)
        for i, (_, child) in enumerate(kids)])


def tree_paths(tree):
    """Tree of '/'-joined string names, one per leaf (dict keys, field
    names and sequence indices), the name space the rules match."""
    def walk(x, prefix):
        if not _is_node(x):
            return "/".join(prefix)
        return _rebuild(x, [walk(c, prefix + (str(k),))
                            for k, c in _children(x)])
    return walk(tree, ())


def match_partition_rules(rules, tree):
    """Tree of :class:`PartitionSpec` from ``rules``: an ordered list of
    ``(regex, PartitionSpec)`` searched against each leaf's /-joined
    name.  Scalar leaves are never partitioned; a leaf matching no rule
    is an error (close rule lists with ``(".*", P())``)."""
    def spec_of(name, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return P()                        # never partition scalars
        for rule, spec in rules:
            if re.search(rule, name) is not None:
                return spec
        raise ValueError(f"no partition rule matches leaf {name!r} "
                         f"(shape {shape}) — add a rule or a catch-all")
    return tree_map(spec_of, tree_paths(tree), tree)


# --------------------------------------------------------------------------
# placed leaves
# --------------------------------------------------------------------------

def _axis_split(mesh, axis, qi: int, ti: int):
    """(parts, index) of device (qi, ti) along a spec entry."""
    if axis is None:
        return 1, 0
    names = axis if isinstance(axis, tuple) else (axis,)
    parts, index = 1, 0
    for name in names:
        n = int(mesh.shape[name])
        i = qi if name == "q" else ti
        parts, index = parts * n, index * n + i
    return parts, index


class ShardedTensor:
    """One leaf placed on a mesh: ``shards[qi][ti]`` is the slice that
    mesh device (qi, ti) holds under ``spec`` (the whole tensor where the
    spec replicates).  ``shape`` and ``dtype`` are the global tensor's."""

    __slots__ = ("mesh", "spec", "shards", "shape", "dtype")

    def __init__(self, mesh, spec, shards, shape, dtype):
        self.mesh = mesh
        self.spec = spec
        self.shards = shards
        self.shape = tuple(shape)
        self.dtype = dtype

    def shard(self, qi: int = 0, ti: int = 0) -> torch.Tensor:
        return self.shards[qi][ti]

    @property
    def nbytes(self) -> int:
        """Bytes of the global tensor."""
        return int(np.prod(self.shape)) * self.shards[0][0].element_size()

    def gather(self) -> torch.Tensor:
        """The global tensor, reassembled on the mesh's merge device."""
        dev = self.mesh.merge_device
        dims = [d for d, a in enumerate(self.spec) if a is not None]
        if not dims:
            return self.shards[0][0].to(dev)
        if len(dims) > 1:
            raise ValueError(f"gather of a spec partitioned on more than "
                             f"one dimension ({self.spec!r})")
        d = dims[0]
        parts = {}
        for qi in range(self.mesh.shape["q"]):
            for ti in range(self.mesh.shape["t"]):
                n, i = _axis_split(self.mesh, self.spec[d], qi, ti)
                parts.setdefault(i, self.shards[qi][ti])
        return torch.cat([parts[i].to(dev) for i in range(n)], dim=d)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, ShardedTensor):
        return x.gather()
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def place(mesh, spec, x) -> ShardedTensor:
    """Place one leaf under ``spec``: every mesh device receives only its
    slice, moved there with ``.to(device)`` (a host array is sliced on
    the host, so no replicated staging copy is made).  A leaf already
    placed under the same mesh and spec is returned as it is."""
    if isinstance(x, ShardedTensor) and x.mesh is mesh \
            and tuple(x.spec) == tuple(spec):
        return x
    full = _as_tensor(x)
    if len(spec) > full.dim():
        raise ValueError(f"spec {spec!r} has more entries than the leaf "
                         f"has dimensions ({tuple(full.shape)})")
    nq, nt = int(mesh.shape["q"]), int(mesh.shape["t"])
    shards = [[None] * nt for _ in range(nq)]
    for qi in range(nq):
        for ti in range(nt):
            piece = full
            for d, axis in enumerate(spec):
                n, i = _axis_split(mesh, axis, qi, ti)
                if n == 1:
                    continue
                size = full.shape[d]
                if size % n:
                    raise ValueError(
                        f"dimension {d} of size {size} is not divisible by "
                        f"the {n} shards of mesh axis {axis!r}; pad with "
                        "invalid rows via pad_to_multiple")
                w = size // n
                piece = piece.narrow(d, i * w, w)
            shards[qi][ti] = piece.to(mesh.devices[qi, ti])
    return ShardedTensor(mesh, spec, shards, full.shape, full.dtype)


def from_t_shards(mesh, pieces) -> ShardedTensor:
    """A ``P('t', ...)`` leaf from its t per-shard tensors (computed on
    q-row 0's devices): each q row gets the same pieces on its own
    devices.  The global shape stacks the pieces along dimension 0."""
    spec = P("t", *([None] * (pieces[0].dim() - 1)))
    nq, nt = int(mesh.shape["q"]), int(mesh.shape["t"])
    shards = [[pieces[ti].to(mesh.devices[qi, ti]) for ti in range(nt)]
              for qi in range(nq)]
    shape = (sum(int(p.shape[0]) for p in pieces),) + tuple(pieces[0].shape[1:])
    return ShardedTensor(mesh, spec, shards, shape, pieces[0].dtype)


def replicated(mesh, x) -> ShardedTensor:
    """``x`` on every mesh device (spec ``P()``)."""
    return place(mesh, P(), x)


def make_shard_and_gather_fns(mesh, partition_specs):
    """Per-leaf ``(shard_fns, gather_fns)`` trees from a PartitionSpec
    tree.  A shard fn places ONE leaf (:func:`place`); a gather fn is the
    inverse, the global tensor on the mesh's merge device."""
    is_spec = lambda x: isinstance(x, P)          # noqa: E731

    def shard_fn_for(spec):
        return lambda x: place(mesh, spec, x)

    def gather_fn_for(spec):
        return lambda x: place(mesh, spec, x).gather()

    return (tree_map(shard_fn_for, partition_specs, is_leaf=is_spec),
            tree_map(gather_fn_for, partition_specs, is_leaf=is_spec))


def shard_put(mesh, tree, rules):
    """Place a whole named tree by rule match — the one-call form the
    ``parallel/sharded.py`` entry points use."""
    specs = match_partition_rules(rules, tree)
    shard_fns, _ = make_shard_and_gather_fns(mesh, specs)
    return tree_map(lambda fn, x: fn(x), shard_fns, tree)


def constrain(tree, mesh, rules):
    """The identity.  In the JAX package this pins every leaf of a tree
    inside a jitted body to its rule-matched sharding, a hint to the XLA
    partitioner.  Here there is no partitioner: placement is explicit
    (:func:`shard_put`), and a program runs where its operands are."""
    del mesh, rules
    return tree


# --------------------------------------------------------------------------
# The DHT table-state rules.  First match wins; names are the keys of the
# trees the parallel/ entry points build.
# --------------------------------------------------------------------------

#: row-sharded table state (the t axis owns rows; see module docstring)
TABLE_AXIS_RULES = (
    (r"sorted_ids$|^ids$|^table$|expanded$", P("t", None)),
    (r"local_lut$", P("t", None)),
    (r"block_lut$", P()),
    # load-aware geometry: per-shard (base, width) rows of a
    # traffic-weighted split, one row per shard
    (r"shard_rows$", P("t", None)),
    # `valid$` also covers the sketch twin's `sketch_valid` mask
    (r"perm$|valid$|n_local$|last_reply$", P("t")),
    # keyspace sketch traffic: the wave's observed ids split over t
    (r"sketch_ids$", P("t", None)),
    # hot-cache / listener probe traffic: the wave's targets split over t
    (r"probe_ids$", P("t", None)),
    (r"targets$|queries$", P("q", None)),
    (r".*", P()),
)

#: data-parallel engine state (table replicated, queries over the whole
#: mesh) — dp_simulate_lookups
DP_AXIS_RULES = (
    (r"targets$|queries$", P(("q", "t"), None)),
    (r".*", P()),
)


def as_id_keys(x) -> torch.Tensor:
    """An id table as a key tensor (``ops/ids.py``): a tensor is taken as
    keys already; host data is cast to uint32 first (an int64 table would
    otherwise mis-rank) and converted on the host, so placement slices it
    there."""
    if isinstance(x, ShardedTensor):
        return x.gather()
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            raise TypeError(f"id tensors are int32 keys (got {x.dtype}); "
                            "pass uint32 ids as numpy")
        return x
    return to_keys(np.asarray(x).astype(np.uint32), "cpu")


class TableState(NamedTuple):
    """A row-sharded sorted table, placed once and reused across waves
    (:func:`shard_table_state`).  ``arrays`` holds the placed leaves
    (``sorted_ids``, ``local_lut``, ``block_lut``, and ``shard_rows`` for
    a weighted split) and the host int ``n_valid``; the ints are the
    geometry ``sharded.build_tp_lookup`` runs against."""
    arrays: dict
    shard_n: int
    lut_bits: int
    block_bits: int
    #: interior row boundaries of a load-aware split (None = uniform N/t
    #: rows per shard).  When set, ``arrays`` carries ``shard_rows`` [t,
    #: 2] and ``shard_n`` is the rounded-up per-shard row CAPACITY.
    boundaries: Optional[tuple] = None

    @property
    def sorted_ids(self):
        return self.arrays["sorted_ids"]

    def table_bytes_per_shard(self) -> int:
        """Resident sorted-table bytes on ONE device (N/t·5·4 B)."""
        return self.shard_n * self.sorted_ids.shape[1] * 4

    def shard_widths(self) -> list:
        """Valid rows of each shard, host ints."""
        n = int(self.arrays["n_valid"])
        t = int(self.sorted_ids.mesh.shape["t"])
        if self.boundaries is None:
            return [min(max(n - i * self.shard_n, 0), self.shard_n)
                    for i in range(t)]
        b = [0, *self.boundaries, n]
        return [b[i + 1] - b[i] for i in range(t)]

    def shard_bases(self) -> list:
        """Global sorted row of each shard's first row, host ints."""
        t = int(self.sorted_ids.mesh.shape["t"])
        if self.boundaries is None:
            return [i * self.shard_n for i in range(t)]
        return [0, *self.boundaries]


def _build_state_luts(mesh, ids: ShardedTensor, widths, lut_bits: int,
                      block_bits: int):
    """Per-shard positioning LUTs and the replicated global block LUT: the
    sum over shards of each shard's block-width LUT over its own valid
    rows (its width) — the JAX package's one-shot psum, as one sum on the
    merge device.  The ranges partition the valid rows, so the sum is
    ``build_prefix_lut`` over the whole table, bit for bit."""
    from ..ops.sorted_table import build_prefix_lut
    local, parts = [], []
    for ti in range(mesh.shape["t"]):
        shard = ids.shard(0, ti)
        lut = build_prefix_lut(shard, widths[ti], bits=lut_bits)
        part = (lut if block_bits == lut_bits else
                build_prefix_lut(shard, widths[ti], bits=block_bits))
        local.append(lut[None])
        parts.append(part.to(mesh.merge_device))
    block = torch.stack(parts).sum(dim=0, dtype=torch.int32)
    return from_t_shards(mesh, local), replicated(mesh, block)


#: weighted shard capacities round up to a multiple of this (the JAX
#: package's recompile-avoiding alignment, kept for identical layouts)
RESHARD_ALIGN = 256


def shard_table_state(mesh, sorted_ids, n_valid, *,
                      lut_bits: Optional[int] = None,
                      block_bits: Optional[int] = None,
                      boundaries=None) -> TableState:
    """Split a GLOBALLY sorted id table (key tensor, or uint32 ids on the
    host) over the mesh ``t`` axis and derive its lookup state — built
    ONCE per table, reused across every wave
    (``tp_simulate_lookups(..., state=)``).

    Row count must divide ``mesh.shape['t']`` (pad with invalid rows via
    ``sharded.pad_to_multiple``; pad rows land on the LAST shard).
    ``lut_bits`` sizes the per-shard positioning LUT (default
    ``default_lut_bits(shard_n)``); ``block_bits`` the replicated global
    block LUT (default ``default_lut_bits(N)``, the single-device
    engine's width, which bit-identity requires).

    ``boundaries`` (load-aware resharding) is an optional sequence of
    ``t-1`` interior row indices into the VALID prefix of the sorted
    order (:func:`solve_shard_boundaries`): shard ``i`` then owns rows
    ``[b_i, b_{i+1})``, realized as equal-capacity slabs (each shard's
    rows copied to the start of a ``shard_cap``-row slab) plus a
    ``shard_rows`` [t, 2] operand of each shard's (base, width).  A
    reshard is row movement + LUT rebuild, never a re-sort."""
    from ..ops.sorted_table import default_lut_bits
    if boundaries is not None:
        return _shard_table_state_weighted(
            mesh, sorted_ids, n_valid, boundaries,
            lut_bits=lut_bits, block_bits=block_bits)
    N = int(sorted_ids.shape[0])
    n_t = int(mesh.shape["t"])
    if N % n_t:
        raise ValueError(f"table rows ({N}) not divisible by t={n_t}; "
                         f"pad with invalid rows via pad_to_multiple")
    shard_n = N // n_t
    lb = lut_bits or default_lut_bits(shard_n)
    bb = block_bits or default_lut_bits(N)
    placed = shard_put(mesh, {"sorted_ids": as_id_keys(sorted_ids)},
                       TABLE_AXIS_RULES)
    n = int(n_valid)
    widths = [min(max(n - i * shard_n, 0), shard_n) for i in range(n_t)]
    local_lut, block_lut = _build_state_luts(mesh, placed["sorted_ids"],
                                             widths, lb, bb)
    return TableState(
        arrays={"sorted_ids": placed["sorted_ids"], "local_lut": local_lut,
                "block_lut": block_lut, "n_valid": n},
        shard_n=shard_n, lut_bits=lb, block_bits=bb)


def weighted_bounds(boundaries, n: int, n_t: int):
    """(bounds [t+1], widths [t], shard_cap) of a weighted split: the
    interior boundaries clipped to [0, n] and made nondecreasing, each
    shard's width, and the slab capacity (max width rounded up to
    :data:`RESHARD_ALIGN`)."""
    b = np.asarray(boundaries, np.int64).reshape(-1)
    if b.shape[0] != n_t - 1:
        raise ValueError(f"expected {n_t - 1} interior boundaries for "
                         f"t={n_t}, got {b.shape[0]}")
    bounds = np.maximum.accumulate(np.concatenate([[0], np.clip(b, 0, n),
                                                   [n]]))
    widths = np.diff(bounds)
    shard_cap = int(-(-max(int(widths.max()), 1) // RESHARD_ALIGN)
                    * RESHARD_ALIGN)
    return bounds, widths, shard_cap


def weighted_slabs(x, bounds, widths, cap: int, fill):
    """The slabs of a weighted split: rows ``[b_i, b_{i+1})`` of ``x``
    copied to the start of slab i of ``t·cap`` rows, the rest ``fill``,
    on ``x``'s device."""
    out = torch.full((len(widths) * cap,) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    for i, w in enumerate(widths):
        lo = int(bounds[i])
        out[i * cap:i * cap + int(w)] = x[lo:lo + int(w)]
    return out


def _shard_table_state_weighted(mesh, sorted_ids, n_valid, boundaries, *,
                                lut_bits=None, block_bits=None):
    from ..ops.sorted_table import default_lut_bits
    N = int(sorted_ids.shape[0])
    n_t = int(mesh.shape["t"])
    n = int(n_valid)
    ids = as_id_keys(sorted_ids)
    bounds, widths, shard_cap = weighted_bounds(boundaries, n, n_t)
    # the slabs are built where the table is (on the card for a table on
    # the card); rows past a shard's width are zero ids, as in JAX
    ids_re = weighted_slabs(ids, bounds, widths, shard_cap, FLIP)
    shard_rows = np.stack([bounds[:-1], widths], axis=1).astype(np.int32)
    lb = lut_bits or default_lut_bits(shard_cap)
    # block width stays keyed to the ORIGINAL table size: bit-identity
    # with the single-device engine requires the same global LUT shape
    bb = block_bits or default_lut_bits(N)
    placed = shard_put(mesh, {"sorted_ids": ids_re,
                              "shard_rows": shard_rows}, TABLE_AXIS_RULES)
    local_lut, block_lut = _build_state_luts(
        mesh, placed["sorted_ids"], [int(w) for w in widths], lb, bb)
    return TableState(
        arrays={"sorted_ids": placed["sorted_ids"], "local_lut": local_lut,
                "block_lut": block_lut, "n_valid": n,
                "shard_rows": placed["shard_rows"]},
        shard_n=shard_cap, lut_bits=lb, block_bits=bb,
        boundaries=tuple(int(x) for x in bounds[1:-1]))


# --------------------------------------------------------------------------
# Load-aware boundary solver.  Host numpy, copied from the JAX package —
# it runs on the node scheduler thread per rebalance tick, not on device.
# --------------------------------------------------------------------------

def _blend_bin_weights(meas, loads, load_weight):
    """Per-bin weight: ``(1-λ)·rows/R + λ·loads/L``.  λ clips to
    [0, 1]; a cold table (zero observed load) forces λ=0 so the solve
    degrades to the row-uniform split."""
    meas = np.asarray(meas, np.float64).reshape(-1)
    if loads is None:
        loads = np.zeros_like(meas)
    else:
        loads = np.asarray(loads, np.float64).reshape(-1)
    if loads.shape != meas.shape:
        raise ValueError(f"bin shapes differ: {meas.shape} vs {loads.shape}")
    lam = min(max(float(load_weight), 0.0), 1.0)
    L = float(loads.sum())
    R = float(meas.sum())
    if L <= 0.0:
        lam = 0.0
    w = np.zeros_like(meas)
    if R > 0.0 and lam < 1.0:
        w += (1.0 - lam) * meas / R
    if lam > 0.0:
        w += lam * np.clip(loads, 0.0, None) / L
    return w


def _solve_crossings(w, t):
    """Interior equal-weight crossings of a per-bin weight profile.

    Returns ``t-1`` pairs ``(bin, frac)``: crossing ``i`` sits at
    fraction ``frac ∈ (0, 1]`` through ``bin`` — the first point where
    cumulative weight reaches ``i/t`` of the total (weight is treated as
    uniform WITHIN a bin, as ``keyspace.fold_bins`` does)."""
    w = np.asarray(w, np.float64)
    cumw = np.concatenate([[0.0], np.cumsum(w)])
    W = float(cumw[-1])
    out = []
    for i in range(1, int(t)):
        if W <= 0.0:
            out.append((0, 0.0))
            continue
        T = W * i / float(t)
        # first e with cumw[e] >= T; e >= 1 since cumw[0] = 0 < T
        e = int(np.searchsorted(cumw, T, side="left"))
        e = min(max(e, 1), len(w))
        bin_ = e - 1
        frac = (T - cumw[bin_]) / w[bin_] if w[bin_] > 0.0 else 1.0
        out.append((bin_, float(min(max(frac, 0.0), 1.0))))
    return out


def solve_shard_boundaries(bin_rows, bin_loads, t, *, load_weight=1.0):
    """Traffic-weighted split points, snapped to real row boundaries.

    ``bin_rows[b]`` counts the sorted table's valid rows whose top id
    byte is ``b`` (the 256-bin space of the keyspace observatory's load
    histogram ``bin_loads``).  Returns ``t-1`` nondecreasing row indices
    in ``[0, n]``: boundary ``i`` is the SMALLEST row count r such that
    the blended weight of rows ``[0, r)`` reaches ``i/t`` of the total.
    With ``load_weight=0`` (or a cold histogram) this is the row-uniform
    split ``ceil(i·n/t)``."""
    bin_rows = np.asarray(bin_rows, np.int64).reshape(-1)
    n = int(bin_rows.sum())
    w = _blend_bin_weights(bin_rows, bin_loads, load_weight)
    row_start = np.concatenate([[0], np.cumsum(bin_rows)])
    out = np.zeros(int(t) - 1, np.int64)
    for i, (b, frac) in enumerate(_solve_crossings(w, t)):
        r_b = int(bin_rows[b]) if b < bin_rows.shape[0] else 0
        # within-bin row offset: smallest j with j/r_b >= frac; the tiny
        # eps keeps exact multiples from rounding up a row
        j = int(np.ceil(frac * r_b - 1e-9)) if r_b > 0 else 0
        out[i] = int(row_start[b]) + min(max(j, 0), r_b)
    out = np.clip(out, 0, n)
    return np.maximum.accumulate(out)


def solve_shard_edges(bin_loads, t, *, load_weight=1.0, bin_rows=None):
    """Fractional-bin-coordinate form of the solve, for VIRTUAL
    attribution (no live mesh): ``t-1`` nondecreasing floats in
    ``[0, bins]``, consumable by ``keyspace.fold_bins``.  The cold
    measure defaults to a uniform ring (ones per bin), so a cold table
    yields exactly ``keyspace.bin_edges_uniform(t)``."""
    bin_loads = np.asarray(bin_loads, np.float64).reshape(-1)
    meas = (np.ones_like(bin_loads) if bin_rows is None
            else np.asarray(bin_rows, np.float64).reshape(-1))
    w = _blend_bin_weights(meas, bin_loads, load_weight)
    if float(w.sum()) <= 0.0:
        bins = bin_loads.shape[0]
        return np.asarray([bins * i / float(t) for i in range(1, int(t))],
                          np.float64)
    edges = np.asarray([b + frac for b, frac in _solve_crossings(w, t)],
                       np.float64)
    return np.maximum.accumulate(edges)
