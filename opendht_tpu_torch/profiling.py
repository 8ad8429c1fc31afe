"""Kernel cost ledger: what every shipped device program costs, per
canonical call — the port of the JAX package's ``profiling.py``.

The JAX ledger reads XLA's ``cost_analysis()`` / ``memory_analysis()``
of each lowered program.  Eager torch has no compiler to ask, so the
port's ledger says what torch can say deterministically, and measures
the rest on the card:

- :data:`KERNEL_SPECS` — the same 16 programs as the JAX ledger, each
  pinned at the JAX package's CANONICAL SHAPE (the shape dict equals
  the JAX builder's key for key).  Each builder returns the port's twin
  function and its canonical inputs, drawn from numpy seeds on the
  ledger's device (``jax.random`` cannot be reproduced).
- :class:`KernelLedger` — ``compute()`` runs each canonical call once
  (after one warm-up call) and records, per spec:

  - ``argument_bytes`` / ``output_bytes``: the inputs' and outputs'
    ``nbytes``;
  - ``launches``: the ops the call dispatches below autograd, counted by
    a ``TorchDispatchMode``, split by op name (``launches_by_op``);
    views (ops whose outputs only alias an input) are counted apart
    (``views``) since they launch nothing, and the hand-written CUDA
    kernels, which bypass the dispatcher, join the split under
    ``cuda::<name>`` from their wrappers' launch counts;
  - ``bytes_bound`` and ``flops_model``: an analytic count per spec
    (``_cost_*`` beside its builder), each input byte read once and each
    output byte written once (the roofline of the ``on-chip
    measurement`` practice), and the 32-bit operations the program's
    algorithm needs; data-dependent work (the engine's rounds) is
    counted from this call's output.

  On the card ``compute()`` also counts, under ``torch.profiler``, the
  CUDA kernels and memory copies one call issues (``device_kernels``,
  ``device_copies``; None where the profiler captured none), and ``measure()`` adds ``device_ms`` (the median
  of CUDA-event spans over several timed calls after a warm-up — host
  gaps inside a call that syncs are included), ``peak_temp_bytes``
  (``max_memory_allocated`` over what was allocated before the call)
  and the roofline against :data:`PLATFORM_PEAKS`.  ``measure()``
  refuses a CPU ledger: a CPU time is never a device metric.
- Export: ``dht_kernel_*{kernel=}`` gauges (:meth:`KernelLedger.
  export_to_registry`, the JAX gauge names), ``DhtRunner.get_metrics()``
  through :func:`maybe_export`, a history bundle's ``kernels`` entry,
  and per-wave device-cost attributes on the ``dht.search.wave`` spans
  (:func:`wave_attrs`, :func:`ingest_wave_attrs`).
- The gate: ``python -m opendht_tpu_torch.perf_gate`` diffs the ledger
  against ``opendht_tpu_torch/perf_budgets.json`` (the port's budgets,
  not the JAX package's file).

The ledger never touches the hot path: it runs separate canonical
instances on the device the caller names (``device=None`` = the card),
keeps numbers only, and computes once per process; the hooks cost a
flag check until someone computes it (``OPENDHT_TPU_LEDGER=1`` arms a
serving process).
"""

from __future__ import annotations

import collections
import math
import os
import statistics
import subprocess
import sys
import threading
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "KERNEL_SPECS", "PLATFORM_PEAKS", "KernelLedger", "get_ledger",
    "ledger_computed", "maybe_export", "wave_attrs", "ingest_wave_attrs",
    "platform_peaks",
]

# --------------------------------------------------------------------------
# Peaks for roofline attribution, matched by substring on the card's name
# (``torch.cuda.get_device_name``); a CPU ledger gets the nominal ``cpu``
# row.  ATTRIBUTION DENOMINATORS, not claims: the gate reads the counted
# fields, never a roofline share.  The port's programs do 32-bit integer
# and float work outside the tensor cores, so their operations share is
# taken against ``ops32_per_s``; ``flops_per_s`` is the data sheet's
# headline dense rate.
# --------------------------------------------------------------------------
PLATFORM_PEAKS = {
    "h100": {"flops_per_s": 989e12, "ops32_per_s": 67e12,
             "hbm_bytes_per_s": 3.35e12, "power_limit_w": 700.0,
             "note": "NVIDIA H100 SXM data sheet at 700 W: 989 TFLOP/s "
                     "bf16 dense, 67 TFLOP/s 32-bit outside the tensor "
                     "cores, 3.35 TB/s HBM"},
    "cpu": {"flops_per_s": 2e11, "ops32_per_s": 2e11,
            "hbm_bytes_per_s": 2e10, "power_limit_w": None,
            "note": "nominal shared host core (indicative only)"},
}

_PEAKS_MEMO: Dict[str, dict] = {}


def _power_limit() -> str:
    """The card's power limit as nvidia-smi prints it ("not measured"
    when it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()
        return out[0].strip() if out else "not measured"
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def platform_peaks(device=None) -> dict:
    """Peaks row for ``device`` (None = the card), with the matched key
    as ``peak_key``, the card's name and its ``power.limit`` riding along
    so every roofline export says what it was taken against.  Memoized
    per device type: :func:`wave_attrs` sits on the record_wave path."""
    dev = torch.device("cuda" if device is None else device)
    memo = _PEAKS_MEMO.get(dev.type)
    if memo is not None:
        return dict(memo)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        key = next((k for k in PLATFORM_PEAKS if k in name.lower()), "cpu")
        row = dict(PLATFORM_PEAKS[key], peak_key=key, device_name=name,
                   power_limit=_power_limit())
    else:
        row = dict(PLATFORM_PEAKS["cpu"], peak_key="cpu", device_name="cpu",
                   power_limit="not measured")
    _PEAKS_MEMO[dev.type] = row
    return dict(row)


# --------------------------------------------------------------------------
# Canonical specs.  Each builder takes the device and returns
# (fn, args, kwargs, shape): ``fn`` is the port's twin of the JAX
# builder's program, a function of its arguments alone (so the parity
# tests can hand it the JAX builder's own inputs), and ``shape`` equals
# the JAX builder's shape dict.  Beside each builder, ``_cost_*`` is its
# analytic model: (shape, outputs) -> (bytes_bound, flops_model).
# --------------------------------------------------------------------------

_CANON = {
    "N": 4096,          # base table rows
    "Q": 256,           # query batch
    "K": 8,             # protocol k (routing_table.h:26)
    "D": 512,           # churn delta-slab rows
    "GATHER_M": 2048,   # fused-gather row-vector width
    "R": 24,            # alpha*k reply rows per query (alpha=3)
    "W": 256,           # simulate_lookups wave width
    "INGEST_Q": 64,     # wave-builder fill target (config.ingest_fill_target)
    "INGEST_K": 14,     # refill k (live_search.SEARCH_NODES)
}

_ID = 20                 # bytes of one 5-limb id
_WINDOW = 192            # lanes of an expanded row's window
_EROW = 970              # int32 words of one expanded row


def _log2(n) -> int:
    return max(1, math.ceil(math.log2(max(int(n), 2))))


def _lut_bytes(bits: int) -> int:
    return ((1 << bits) + 1) * 4


def _exp_bytes(n: int) -> int:
    return -(-n // 64) * _EROW * 4


def _topk_out(q: int, k: int) -> int:
    """dist [Q, k, 5] keys + idx [Q, k] int32 + certified [Q] bool."""
    return q * k * (_ID + 4) + q


def _rand_u32(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=shape,
                                                dtype=np.uint32)


def _queries(q: int, dev, seed: int = 12):
    from .ops.ids import to_keys
    return to_keys(_rand_u32((q, 5), seed), dev)


def _canonical_table(n: int, dev, seed: int = 11):
    from .ops.ids import to_keys
    from .ops.sorted_table import (build_prefix_lut, default_lut_bits,
                                   expand_table, sort_table)
    s, _perm, nv = sort_table(to_keys(_rand_u32((n, 5), seed), dev))
    return s, expand_table(s), nv, build_prefix_lut(
        s, nv, bits=default_lut_bits(n))


def _select_ops(q: int, k: int, n: int, w: int = _WINDOW) -> int:
    """A window top-k per query: positioning (a binary search of 5-limb
    compares), ``w`` lanes of XOR + lexicographic compare, k winner
    rounds over the lanes."""
    return q * (10 * _log2(n) + 15 * w + k * 2 * w)


def _lookup_fn(k):
    def fn(s, e, nv, q, lut):
        from .ops.sorted_table import lookup_topk
        return lookup_topk(s, nv, q, k=k, lut=lut, expanded=e)
    return fn


def _spec_find_closest(dev):
    """The shipping find_closest device program: ``lookup_topk`` over the
    expanded table with the exact fallback — the ``window_select`` kernel
    on the card — what ``NodeTable.find_closest`` →
    ``runtime/dht.py find_closest_nodes_batched`` launches per wave."""
    s, e, nv, lut = _canonical_table(_CANON["N"], dev)
    q = _queries(_CANON["Q"], dev)
    return (_lookup_fn(_CANON["K"]), (s, e, nv, q, lut), {},
            {"N": _CANON["N"], "Q": _CANON["Q"], "k": _CANON["K"]})


def _cost_lookup(shape, _out):
    n, q, k = shape["N"], shape["Q"], shape["k"]
    b = n * _ID + _exp_bytes(n) + 4 + q * _ID + _lut_bytes(16)
    return b + _topk_out(q, k), _select_ops(q, k, n)


def _spec_wave_builder(dev):
    """The ingest wave builder's coalesced launch: ``lookup_topk`` at the
    fill target Q=64 refill targets x k=SEARCH_NODES=14."""
    s, e, nv, lut = _canonical_table(_CANON["N"], dev)
    q = _queries(_CANON["INGEST_Q"], dev, seed=24)
    return (_lookup_fn(_CANON["INGEST_K"]), (s, e, nv, q, lut), {},
            {"N": _CANON["N"], "Q": _CANON["INGEST_Q"],
             "k": _CANON["INGEST_K"]})


def _sketch_fn(sketch, hist, ids):
    from .ops.sketch import sketch_update
    return sketch_update(sketch, hist, ids)


def _spec_sketch_update(dev):
    """The keyspace observatory's per-wave update: Q=64 ids into the
    [4, 2048] count-min sketch and the 256-bin histogram (in place)."""
    from .ops.sketch import BINS, SKETCH_DEPTH, SKETCH_WIDTH
    sketch = torch.zeros((SKETCH_DEPTH, SKETCH_WIDTH), dtype=torch.int32,
                         device=dev)
    hist = torch.zeros((BINS,), dtype=torch.int32, device=dev)
    ids = _queries(_CANON["INGEST_Q"], dev, seed=26)
    return (_sketch_fn, (sketch, hist, ids), {},
            {"Q": _CANON["INGEST_Q"], "depth": SKETCH_DEPTH,
             "width": SKETCH_WIDTH, "bins": BINS})


def _cost_sketch(shape, _out):
    q, d = shape["Q"], shape["depth"]
    tables = (d * shape["width"] + shape["bins"]) * 4
    # murmur-style hash columns (~24 ops per row), the cell adds, the bin
    return 2 * tables + q * _ID, q * (d * 24 + 4)


def _probe_fn(table_ids, valid, targets):
    from .ops.cache_probe import cache_probe
    return cache_probe(table_ids, valid, targets, device=table_ids.device)


def _spec_cache_probe(dev):
    """The hot-cache membership probe: Q=64 wave targets against the
    default-capacity [64, 5] cache id table."""
    from .ops.cache_probe import CACHE_CAPACITY
    cache_ids = _queries(CACHE_CAPACITY, dev, seed=27)
    valid = torch.ones((CACHE_CAPACITY,), dtype=torch.bool, device=dev)
    targets = _queries(_CANON["INGEST_Q"], dev, seed=28)
    return (_probe_fn, (cache_ids, valid, targets), {},
            {"Q": _CANON["INGEST_Q"], "C": CACHE_CAPACITY})


def _cost_cache_probe(shape, _out):
    q, c = shape["Q"], shape["C"]
    return c * (_ID + 1) + q * _ID + q * 5, q * c * 7


def _match_fn(table_ids, valid, stored):
    from .ops.listener_match import listener_match
    return listener_match(table_ids, valid, stored, device=table_ids.device)


def _spec_listener_match(dev):
    """The listener-table match: S=64 stored-put keys against the
    default-capacity [1024, 5] listener id table."""
    from .ops.listener_match import LISTENER_CAPACITY
    table_ids = _queries(LISTENER_CAPACITY, dev, seed=29)
    valid = torch.ones((LISTENER_CAPACITY,), dtype=torch.bool, device=dev)
    stored = _queries(_CANON["INGEST_Q"], dev, seed=30)
    return (_match_fn, (table_ids, valid, stored), {},
            {"S": _CANON["INGEST_Q"], "L": LISTENER_CAPACITY})


def _cost_listener_match(shape, _out):
    s, l = shape["S"], shape["L"]
    return l * (_ID + 1) + s * _ID + s * 5, s * l * 7


def _swarm_fn(*args):
    from .ops.swarm import swarm_step
    return swarm_step(*args)


def _spec_swarm_step(dev):
    """The chaos swarm stepper's tick: churn draws, the partition-aware
    analytic refresh, the batched maintenance sweep over the rotating
    sample, poison admission/decay and the closest-R republish, at the
    canonical S=4096-node / M=16-sample / K=32-key shape."""
    from .ops import swarm
    S, M, K, G = 4096, 16, 32, 2
    state = swarm.state_to_device(swarm.init_swarm(33, S, K, n_groups=G),
                                  dev)
    args = (state, np.float32(1.0), np.float32(0.05), np.float32(0.05),
            np.float32(0.1), np.float32(1.0), np.float32(5.0),
            np.ones((G, G), bool), True, np.zeros((S,), bool), np.int32(4),
            True, np.arange(M, dtype=np.int32), _rand_u32((S, 3), 34),
            _rand_u32((K,), 35))
    return (_swarm_fn, args, {}, {"S": S, "M": M, "K": K, "G": G})


def _cost_swarm(shape, _out):
    S, M, K, G = shape["S"], shape["M"], shape["K"], shape["G"]
    R = 8
    state = S * (_ID + 4 + 1 + 4 + 4 + 80 + 80) + K * (_ID + 4 + R * 4)
    ins = state + G * G + S + M * 4 + S * 12 + K * 4
    ops = (S * 160 * 12                    # occupancy planes, per bucket
           + M * S * 24                    # the sweep: XOR, clz, bins
           + K * S * (12 + 3 * _log2(S)))  # republish: 3 stable sorts
    return ins + state + 8 * 4, ops


def _expanded_fn(s, e, nv, q, *, lut):
    from .ops.sorted_table import expanded_topk
    return expanded_topk(s, e, nv, q, k=_CANON["K"], select="fast3",
                         lut=lut)


def _spec_expanded_topk(dev):
    """The window lookup alone, fast3 select (plain torch, as the JAX
    spec's fast3 is plain XLA)."""
    s, e, nv, lut = _canonical_table(_CANON["N"], dev)
    q = _queries(_CANON["Q"], dev)
    return (_expanded_fn, (s, e, nv, q), {"lut": lut},
            {"N": _CANON["N"], "Q": _CANON["Q"], "k": _CANON["K"],
             "select": "fast3"})


def _gather_fn(table, rows):
    from .ops.sorted_table import fused_gather_planar
    return fused_gather_planar(table, rows, 5)


def _spec_fused_gather(dev):
    """The round-fused [M, R] reply gather — the iterative round's only
    table access (the port's table is row-major [N, 5], not the JAX
    package's transposed [5, N])."""
    s, _e, _nv, _lut = _canonical_table(_CANON["N"], dev)
    rows = torch.from_numpy(
        (_rand_u32((_CANON["GATHER_M"], _CANON["R"]), 13)
         % np.uint32(_CANON["N"])).astype(np.int32)).to(dev)
    return (_gather_fn, (s, rows), {},
            {"N": _CANON["N"], "M": _CANON["GATHER_M"], "R": _CANON["R"],
             "limbs": 5})


def _cost_gather(shape, _out):
    n, m, r, l = shape["N"], shape["M"], shape["R"], shape["limbs"]
    return n * _ID + m * r * 4 + l * m * r * 4, m * r * (l + 2)


def _merge_fn(m_dist, m_idx, d_dist, d_idx):
    from .ops.sorted_table import packed_churn_merge
    return packed_churn_merge(m_dist, m_idx, d_dist, d_idx, _CANON["N"],
                              k=_CANON["K"], nl=2, pack=16)


def _spec_packed_merge(dev):
    """The lane-packed churn merge at pack width P=16 (pinned at 16 on
    every platform, as the JAX spec)."""
    Q, K = _CANON["Q"], _CANON["K"]

    def plane(seed):
        return torch.from_numpy(_rand_u32((Q, K), seed).view(np.int32)
                                ^ np.int32(-(1 << 31))).to(dev)
    m_dist = (plane(141), plane(142))
    d_dist = (plane(143), plane(144))
    m_idx = (torch.arange(Q * K, dtype=torch.int32, device=dev)
             .reshape(Q, K) % _CANON["N"])
    d_idx = (torch.arange(Q * K, dtype=torch.int32, device=dev)
             .reshape(Q, K) % _CANON["D"])
    return (_merge_fn, (m_dist, m_idx, d_dist, d_idx), {},
            {"Q": Q, "k": K, "nl": 2, "pack": 16})


def _cost_merge(shape, _out):
    q, k, nl, p = shape["Q"], shape["k"], shape["nl"], shape["pack"]
    w = min(k + 1, 2 * k)
    ins = 2 * q * k * 4 * (nl + 1)
    return ins + q * w * 4 * (nl + 1), q * 2 * k * (nl + 2) * _log2(
        2 * k * p)


def _churn_fn(s, e, nv, tomb, ds, de, dnv, q, lut, dlut):
    from .ops.sorted_table import churn_lookup_topk
    return churn_lookup_topk(s, e, nv, tomb, ds, de, dnv, q, lut, dlut,
                             k=_CANON["K"], select="fast3", merge_pack=16)


def _spec_churn_lookup(dev):
    """The full churn lookup (base ∪ delta, tombstones, packed merge) —
    the program behind ``ChurnView.lookup``."""
    s, e, nv, lut = _canonical_table(_CANON["N"], dev)
    ds, de, dnv, dlut = _canonical_table(_CANON["D"], dev, seed=15)
    tomb = torch.zeros((-(-_CANON["N"] // 32),), dtype=torch.int32,
                       device=dev)
    q = _queries(_CANON["Q"], dev)
    return (_churn_fn, (s, e, nv, tomb, ds, de, dnv, q, lut, dlut), {},
            {"N": _CANON["N"], "D": _CANON["D"], "Q": _CANON["Q"],
             "k": _CANON["K"], "select": "fast3", "merge_pack": 16})


def _cost_churn(shape, _out):
    n, d, q, k = shape["N"], shape["D"], shape["Q"], shape["k"]
    ins = (n * _ID + _exp_bytes(n) + 4 + -(-n // 32) * 4 + d * _ID
           + _exp_bytes(d) + 4 + q * _ID + 2 * _lut_bytes(16))
    ops = (_select_ops(q, k, n) + _select_ops(q, k, d)
           + q * 2 * k * 7 * _log2(2 * k * shape["merge_pack"]))
    return ins + _topk_out(q, k), ops


def _sweep_fn(self_id, ids, valid, last, now, age, seed):
    from .ops.radix import maintenance_sweep
    gen = torch.Generator(device=ids.device).manual_seed(seed)
    return maintenance_sweep(self_id, ids, valid, last, now, age, gen,
                             device=ids.device)


def _sweep_inputs(dev, seeds):
    from .ops.ids import to_keys
    N = _CANON["N"]
    return (to_keys(_rand_u32((5,), seeds[0]), dev),
            to_keys(_rand_u32((N, 5), seeds[1]), dev),
            torch.ones((N,), dtype=torch.bool, device=dev),
            torch.full((N,), 100.0, dtype=torch.float32, device=dev),
            700.0, 600.0, seeds[2])


def _spec_maintenance_sweep(dev):
    """The bucket-maintenance pass over N ids (ops/radix.py); its refresh
    targets come from a ``torch.Generator`` seeded with the last
    argument."""
    return (_sweep_fn, _sweep_inputs(dev, (17, 16, 18)), {},
            {"N": _CANON["N"], "buckets": 160})


def _cost_sweep(shape, _out):
    n = shape["N"]
    ins = _ID + n * (_ID + 1 + 4)
    out = 160 * (4 + 4 + 1 + _ID)
    return ins + out, n * 24 + 160 * 20


def _engine_fn(s, nv, t, *, lut):
    from .core.search import _simulate_lookups
    return _simulate_lookups(s, nv, t, alpha=3, k=_CANON["K"], lut=lut,
                             state_limbs=2)


def _spec_simulate_lookups(dev):
    """The iterative search engine at the config-3 parameterization
    (alpha=3, k=8, state_limbs=2), without the telemetry envelope."""
    s, _e, nv, lut = _canonical_table(_CANON["N"], dev)
    t = _queries(_CANON["W"], dev, seed=19)
    return (_engine_fn, (s, nv, t), {"lut": lut},
            {"N": _CANON["N"], "W": _CANON["W"], "alpha": 3,
             "k": _CANON["K"], "state_limbs": 2})


def _engine_ops(w, k, alpha, limbs, n, rounds) -> int:
    """Bootstrap positioning, then per round and query: alpha·k reply
    rows gathered (``limbs`` planes) and XORed, and the k + alpha·k
    candidates merged by a 5-key sort."""
    c = k + alpha * k
    return w * (10 * _log2(n) + rounds * (alpha * k * (limbs + 5)
                                          + c * 5 * _log2(c)))


def _cost_engine(shape, out):
    n, w, k = shape["N"], shape["W"], shape["k"]
    rounds = int(out["hops"].max()) if out["hops"].numel() else 0
    ins = n * _ID + 4 + w * _ID + _lut_bytes(16)
    outs = w * (k * 4 + k * _ID + 4 + 1)
    return ins + outs, _engine_ops(w, k, shape["alpha"],
                                   shape["state_limbs"], n, rounds)


def _mesh_1x1(dev):
    from .parallel.sharded import Mesh
    return Mesh(np.array([[dev]], dtype=object))


def _spec_tp_simulate_lookups(dev):
    """The table-sharded engine (parallel/sharded.py build_tp_lookup) on
    a 1x1 mesh, over the row-sharded table state (sorted rows,
    per-shard positioning LUT, replicated global block LUT)."""
    from .parallel.partition import (TABLE_AXIS_RULES, TableState,
                                     shard_put, shard_table_state)
    from .parallel.sharded import build_tp_lookup
    s, _e, nv, _lut = _canonical_table(_CANON["N"], dev)
    t = _queries(_CANON["W"], dev, seed=20)
    mesh = _mesh_1x1(dev)
    state = shard_table_state(mesh, s, int(nv))
    run = build_tp_lookup(mesh, state.shard_n, _CANON["W"], _CANON["K"], 3,
                          14, 48, state_limbs=2)

    def fn(sorted_ids, local_lut, block_lut, n_valid, targets, seed):
        placed = shard_put(mesh, {"sorted_ids": sorted_ids,
                                  "local_lut": local_lut,
                                  "block_lut": block_lut,
                                  "targets": targets}, TABLE_AXIS_RULES)
        st = TableState(
            arrays={"sorted_ids": placed["sorted_ids"],
                    "local_lut": placed["local_lut"],
                    "block_lut": placed["block_lut"],
                    "n_valid": int(n_valid)},
            shard_n=int(sorted_ids.shape[0]), lut_bits=state.lut_bits,
            block_bits=state.block_bits)
        return run(st, placed["targets"], int(seed))
    a = state.arrays
    return (fn, (a["sorted_ids"].gather(), a["local_lut"].gather(),
                 a["block_lut"].gather(), nv, t, 0), {},
            {"N": _CANON["N"], "W": _CANON["W"], "mesh": "1x1",
             "k": _CANON["K"], "state_limbs": 2,
             "layout": "row-sharded-state"})


def _cost_tp(shape, out):
    n, w, k = shape["N"], shape["W"], shape["k"]
    rounds = int(out["hops"].max()) if out["hops"].numel() else 0
    ins = n * _ID + 2 * _lut_bytes(16) + 4 + w * _ID
    outs = w * (k * 4 + k * _ID + 4 + 1)
    return ins + outs, _engine_ops(w, k, 3, shape["state_limbs"], n, rounds)


def _spec_sharded_window_lookup(dev):
    """The per-shard window top-k + one cross-shard merge
    (parallel/sharded.py sharded_window_lookup, the window route: the
    ``lex_topk_select`` kernel on the card) on a 1x1 mesh."""
    from .parallel.sharded import sharded_window_lookup
    s, _e, nv, _lut = _canonical_table(_CANON["N"], dev)
    q = _queries(_CANON["Q"], dev, seed=25)
    mesh = _mesh_1x1(dev)
    perm = torch.arange(_CANON["N"], dtype=torch.int32, device=dev)

    def fn(q, sorted_ids, perm, n_valid):
        return sharded_window_lookup(mesh, q, sorted_ids, perm, n_valid,
                                     k=_CANON["K"], window=128)
    return (fn, (q, s, perm, nv.reshape(1)), {},
            {"N": _CANON["N"], "Q": _CANON["Q"], "k": _CANON["K"],
             "mesh": "1x1", "window": 128})


def _cost_sharded_window(shape, _out):
    n, q, k, w = shape["N"], shape["Q"], shape["k"], shape["window"]
    ins = q * _ID + n * (_ID + 4) + 4
    return (ins + q * k * (_ID + 4),
            _select_ops(q, k, n, w) + q * k * 7 * _log2(k))


def _spec_reshard_state_build(dev):
    """The reshard hot-swap's device cost: the weighted per-shard LUT
    rebuild (per-shard prefix LUT + the summed global block LUT) on a
    1x1 mesh, over the slab of equal-capacity rows a swap builds."""
    from .ops.ids import FLIP
    from .ops.sorted_table import default_lut_bits
    from .parallel import partition
    s, _e, nv, _lut = _canonical_table(_CANON["N"], dev)
    mesh = _mesh_1x1(dev)
    n = int(nv)
    cap = int(-(-_CANON["N"] // partition.RESHARD_ALIGN)
              * partition.RESHARD_ALIGN)
    ids_re = torch.full((cap, 5), FLIP, dtype=torch.int32, device=dev)
    ids_re[:_CANON["N"]] = s
    shard_rows = np.asarray([[0, n]], np.int32)
    lb, bb = default_lut_bits(cap), default_lut_bits(_CANON["N"])

    def fn(sorted_ids, shard_rows):
        placed = partition.shard_put(mesh, {"sorted_ids": sorted_ids},
                                     partition.TABLE_AXIS_RULES)
        widths = [int(w) for w in np.asarray(shard_rows)[:, 1]]
        local, block = partition._build_state_luts(
            mesh, placed["sorted_ids"], widths, lb, bb)
        return local.gather(), block.gather()
    return (fn, (ids_re, shard_rows), {},
            {"N": _CANON["N"], "cap": cap, "mesh": "1x1",
             "layout": "weighted"})


def _cost_reshard(shape, _out):
    cap = shape["cap"]
    lut = _lut_bytes(16)
    # a LUT is a search of every prefix bucket edge over the rows
    return cap * _ID + 8 + 2 * lut, (1 << 16) * 10 * _log2(cap) + cap * 2


def _spec_sharded_maintenance(dev):
    """The tp maintenance-sweep twin on a 1x1 mesh (one [160] sum + one
    [160] maximum)."""
    from .parallel.sharded import sharded_maintenance_sweep
    mesh = _mesh_1x1(dev)

    def fn(self_id, ids, valid, last, now, age, seed):
        gen = torch.Generator(device=ids.device).manual_seed(seed)
        return sharded_maintenance_sweep(mesh, self_id, ids, valid, last,
                                         now, age, gen)
    return (fn, _sweep_inputs(dev, (22, 21, 23)), {},
            {"N": _CANON["N"], "mesh": "1x1", "buckets": 160})


#: name -> (builder, paired live telemetry series or None, cost model).
#: The series is the histogram that times the SHIPPING launches of the
#: same program, so exports can put the live p50 next to the canonical
#: cost.
KERNEL_SPECS = {
    "find_closest_nodes_batched": (_spec_find_closest, None, _cost_lookup),
    "wave_builder_lookup": (_spec_wave_builder, "dht_ingest_wave_seconds",
                            _cost_lookup),
    "sketch_update": (_spec_sketch_update, None, _cost_sketch),
    "cache_probe": (_spec_cache_probe, None, _cost_cache_probe),
    "listener_match": (_spec_listener_match, "dht_listener_match_seconds",
                       _cost_listener_match),
    "swarm_step": (_spec_swarm_step, None, _cost_swarm),
    "expanded_topk": (_spec_expanded_topk, None, _cost_lookup),
    "fused_gather_planar": (_spec_fused_gather, None, _cost_gather),
    "packed_churn_merge": (_spec_packed_merge, None, _cost_merge),
    "churn_lookup_topk": (_spec_churn_lookup, "dht_churn_lookup_seconds",
                          _cost_churn),
    "maintenance_sweep": (_spec_maintenance_sweep,
                          "dht_maintenance_sweep_seconds", _cost_sweep),
    "simulate_lookups": (_spec_simulate_lookups,
                         'dht_search_wave_seconds{mode="single"}',
                         _cost_engine),
    "tp_simulate_lookups": (_spec_tp_simulate_lookups,
                            'dht_search_wave_seconds{mode="tp"}', _cost_tp),
    "sharded_window_lookup": (_spec_sharded_window_lookup, None,
                              _cost_sharded_window),
    "reshard_state_build": (_spec_reshard_state_build,
                            "dht_reshard_swap_seconds", _cost_reshard),
    "sharded_maintenance_sweep": (
        _spec_sharded_maintenance,
        'dht_maintenance_sweep_seconds{mode="tp"}', _cost_sweep),
}

#: the fields a CPU and a card ledger must agree on (the gate's exact
#: fields; ``launches`` is gated only against a ledger of the budgets'
#: platform, since the card dispatches its kernels outside aten)
DETERMINISTIC_FIELDS = ("shape", "argument_bytes", "output_bytes",
                        "bytes_bound", "flops_model")


# --------------------------------------------------------------------------
# Counting
# --------------------------------------------------------------------------
def _nbytes(x) -> int:
    """Bytes of every tensor / array leaf of a nested call tree."""
    from .parallel.partition import ShardedTensor
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return int(x.nbytes)
    if isinstance(x, ShardedTensor):
        return x.nbytes
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


_PKG = os.path.dirname(os.path.abspath(__file__))


def _caller() -> str:
    """``module.py:function`` of the innermost frame of this package
    (this module aside) on the stack."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG) and path != __file__:
            return "%s:%s" % (os.path.relpath(path, _PKG), f.f_code.co_name)
        f = f.f_back
    return "?"


class _OpCounter(TorchDispatchMode):
    """Counts the aten ops a call dispatches, by name; views apart; with
    ``by_caller``, also by the port function that issued each op."""

    def __init__(self, by_caller: bool = False):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()
        self.callers: collections.Counter = collections.Counter()
        self.by_caller = by_caller
        self.views = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if not name.startswith("profiler::"):
            if _is_view(func):
                self.views += 1
            else:
                self.ops[name] += 1
                if self.by_caller:
                    self.callers[_caller()] += 1
        return func(*args, **(kwargs or {}))


def _kernel_wrappers():
    from .ops.lex_select import lex_topk_select
    from .ops.window_select import window_select
    return {"window_select": window_select,
            "lex_topk_select": lex_topk_select}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def count_call(fn, args, kwargs, dev, *, by_caller: bool = False) -> dict:
    """One call of ``fn`` under the op counter: ``launches``,
    ``launches_by_op`` and ``views``, the hand kernels' launches joining
    the split as ``cuda::<name>``; with ``by_caller`` also
    ``launches_by_caller`` (``module.py:function`` of the port code that
    issued each op, kernels aside); and the outputs."""
    wrappers = _kernel_wrappers()
    before = {n: getattr(w, "launches", 0) for n, w in wrappers.items()}
    counter = _OpCounter(by_caller)
    with counter:
        out = fn(*args, **kwargs)
    _sync(dev)
    split = dict(counter.ops)
    for n, w in wrappers.items():
        d = getattr(w, "launches", 0) - before[n]
        if d:
            split["cuda::" + n] = d
    res = {"launches": sum(split.values()),
           "launches_by_op": dict(sorted(split.items())),
           "views": counter.views, "_out": out}
    if by_caller:
        res["launches_by_caller"] = dict(counter.callers.most_common())
    return res


def device_totals(prof, per: int = 1) -> dict:
    """The device-side events of a torch.profiler window (kernels,
    copies and fills): their summed time and counts, each divided by
    ``per``, and the ten that took the most time.  The device spans of
    ``record_function`` stage labels (``churn.*``, ``search.*``) cover
    kernels already counted: they are listed apart as ``stages``."""
    ev, stages = [], []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            label = (getattr(e, "is_user_annotation", False)
                     or e.key.startswith(("churn.", "search.")))
            (stages if label else ev).append(e)
    copies = sum(e.count for e in ev if e.key.startswith(("Memcpy", "Memset")))
    top = sorted(ev, key=lambda e: e.self_device_time_total, reverse=True)
    return {"device_ms": sum(e.self_device_time_total for e in ev) / 1e3 / per,
            "kernels": (sum(e.count for e in ev) - copies) / per,
            "copies": copies / per,
            "top": [{"name": e.key[:80], "calls": e.count / per,
                     "device_ms": e.self_device_time_total / 1e3 / per}
                    for e in top[:10]],
            "stages": {e.key: e.device_time_total / 1e3 / per
                       for e in stages}}


#: dispatched ops a profiled window of a card ledger holds at least: a
#: small spec repeats its call (3 to 200 times) until it gets there
_WINDOW_OPS = 600


def _profile_calls(fn, args, kwargs, dev, launches: int):
    """:func:`device_totals` per call of a window of calls under
    ``torch.profiler``, after a warm-up step of the same calls (the
    profiler's ``schedule``: the tracer is collecting before the counted
    step begins, so the window's first kernels are not lost).  None when
    the window holds no device event although the calls dispatched ops:
    not captured, never a count of 0."""
    from torch.profiler import ProfilerActivity, profile, schedule
    calls = max(3, min(200, -(-_WINDOW_OPS // max(1, launches))))
    got = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: got.append(
                     device_totals(p, calls))) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn(*args, **kwargs)
            _sync(dev)
            prof.step()
    tot = got[0] if got else None
    if tot is None or (launches and not tot["kernels"] + tot["copies"]):
        return None
    return tot


# --------------------------------------------------------------------------
# The ledger
# --------------------------------------------------------------------------
class KernelLedger:
    """Per-process cost ledger over :data:`KERNEL_SPECS`.

    ``compute()`` runs each canonical spec once and caches the entry;
    ``measure()`` (the card only) times it and fills the roofline.
    Thread-safe; all torch work happens inside those calls, never at
    import."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, dict] = {}
        self._exported = False
        #: master switch consulted by :meth:`computed` (and hence by the
        #: record_wave hook): False restores the exact not-computed
        #: hot-path behavior without dropping the cached entries
        self.enabled = True

    # ------------------------------------------------------------- compute
    def compute(self, kernels: Optional[List[str]] = None,
                force: bool = False, *, device=None) -> Dict[str, dict]:
        """Run the named specs (default: all) on ``device`` (None = the
        card) and return ``{name: entry}``.  Entries hold numbers only —
        no callable, no tensor — so a process that computed the ledger
        keeps no canonical table resident and the result is
        ``json.dumps``-able.  A spec that fails records an ``error``
        entry instead of raising: the ledger is introspection."""
        from ._device import resolve_device
        dev = resolve_device(device)
        names = list(KERNEL_SPECS) if kernels is None else list(kernels)
        for name in names:
            if name not in KERNEL_SPECS:
                raise KeyError(f"unknown ledger kernel {name!r} — "
                               f"registered: {sorted(KERNEL_SPECS)}")
            with self._lock:
                if name in self._entries and not force:
                    continue
            builder, series, cost = KERNEL_SPECS[name]
            try:
                entry = self._compute_one(name, builder, series, cost, dev)
            except Exception as e:                  # pragma: no cover
                entry = {"kernel": name, "error": str(e)[:300],
                         "series": series}
            with self._lock:
                self._entries[name] = entry
        with self._lock:
            return {n: self._public(self._entries[n]) for n in names
                    if n in self._entries}

    @staticmethod
    def _compute_one(name, builder, series, cost, dev) -> dict:
        fn, args, kwargs, shape = builder(dev)
        fn(*args, **kwargs)                       # warm-up: caches, builds
        _sync(dev)
        counted = count_call(fn, args, kwargs, dev)
        out = counted.pop("_out")
        bytes_bound, flops = cost(shape, out)
        entry = {
            "kernel": name, "shape": shape,
            "argument_bytes": _nbytes((args, kwargs)),
            "output_bytes": _nbytes(out),
            **counted,
            "bytes_bound": int(bytes_bound), "flops_model": int(flops),
            "platform": dev.type, "series": series,
        }
        if dev.type == "cuda":
            # per call; None where the profiler captured no device event
            tot = (_profile_calls(fn, args, kwargs, dev, counted["launches"])
                   or dict.fromkeys(("kernels", "copies", "device_ms", "top")))
            entry["device_name"] = torch.cuda.get_device_name(dev)
            entry["device_kernels"] = tot["kernels"]
            entry["device_copies"] = tot["copies"]
            entry["kernel_ms"] = tot["device_ms"]
            entry["device_top"] = tot["top"]
        return entry

    def measure(self, kernels: Optional[List[str]] = None, reps: int = 7,
                *, device=None) -> Dict[str, dict]:
        """The card's numbers per spec: ``device_ms`` (median of ``reps``
        CUDA-event spans of one canonical call, after a warm-up),
        ``peak_temp_bytes`` and the roofline against the card's peaks
        row.  Raises on a CPU device (no CPU time is written as a device
        metric), and where a spec cannot be timed."""
        from ._device import resolve_device
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise RuntimeError("KernelLedger.measure times the card; a CPU "
                               "ledger has no device time")
        self.compute(kernels, device=dev)
        names = list(KERNEL_SPECS) if kernels is None else list(kernels)
        peaks = platform_peaks(dev)
        for name in names:
            with self._lock:
                entry = self._entries.get(name)
                bad = not entry or "error" in entry
            if bad:
                continue
            fields = self._measure_one(name, reps, dev, peaks)
            with self._lock:
                if name in self._entries:
                    self._entries[name].update(fields)
        with self._lock:
            return {n: self._public(self._entries[n]) for n in names
                    if n in self._entries}

    def _measure_one(self, name, reps, dev, peaks) -> dict:
        fn, args, kwargs, _shape = KERNEL_SPECS[name][0](dev)
        fn(*args, **kwargs)
        _sync(dev)
        times = []
        for _ in range(max(1, reps)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args, **kwargs)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        _sync(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn(*args, **kwargs)
        _sync(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        del out
        ms = statistics.median(times)
        return {"device_ms": ms, "device_ms_all": times,
                "peak_temp_bytes": int(peak),
                "roofline": self.roofline(name, ms / 1e3, peaks)}

    def roofline(self, name: str, elapsed_s: float,
                 peaks: Optional[dict] = None) -> dict:
        """Roofline attribution of one timed call: the analytic bytes and
        operations over ``elapsed_s`` as a share of the peaks row, the
        least time the card could take (``bound_ms``, the larger of
        bytes over the memory rate and operations over the 32-bit rate)
        and which of the two bounds it.  The row's key, note and power
        limit ride along."""
        entry = self._entries.get(name)
        if not entry or "error" in entry or elapsed_s <= 0:
            return {}
        if peaks is None:
            peaks = platform_peaks(entry.get("platform", "cpu"))
        t_bytes = entry["bytes_bound"] / peaks["hbm_bytes_per_s"]
        t_ops = entry["flops_model"] / peaks["ops32_per_s"]
        return {
            "hbm_pct_of_peak": 100.0 * t_bytes / elapsed_s,
            "flops_pct_of_peak": 100.0 * t_ops / elapsed_s,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound": "memory" if t_bytes >= t_ops else "compute",
            "peak_key": peaks.get("peak_key", "?"),
            "peak_note": peaks.get("note", ""),
            "power_limit": peaks.get("power_limit", "not measured"),
        }

    # -------------------------------------------------------------- export
    @staticmethod
    def _public(entry: dict) -> dict:
        return {k: v for k, v in entry.items() if not k.startswith("_")}

    def computed(self) -> bool:
        if not self.enabled:
            return False
        with self._lock:
            return bool(self._entries)

    def clear(self) -> None:
        """Drop every cached entry."""
        with self._lock:
            self._entries.clear()
            self._exported = False

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able {kernel: entry} of everything computed so far, with
        the paired live-series p50 folded in when the registry has
        observed that histogram (canonical cost next to shipping
        latency)."""
        from . import telemetry
        with self._lock:
            out = {n: self._public(e) for n, e in self._entries.items()}
        hists = telemetry.get_registry().snapshot()["histograms"]
        for e in out.values():
            s = e.get("series")
            if s and s in hists:
                e["live_p50_s"] = hists[s]["p50"]
                e["live_count"] = hists[s]["count"]
        return out

    def export_to_registry(self, reg=None) -> int:
        """Publish the computed entries as ``dht_kernel_*{kernel=}``
        gauges — the JAX ledger's names, filled from the port's fields:
        ``flops`` = the operations model, ``bytes_accessed`` = the byte
        bound, ``hbm_bytes`` = arguments + outputs (+ the measured
        temporaries), ``temp_bytes`` = the measured temporaries (-1 =
        not measured: only the card measures them), plus ``launches``;
        when measured, device seconds and the roofline shares.  Returns
        the number of kernels exported."""
        from . import telemetry
        if reg is None:
            reg = telemetry.get_registry()
        with self._lock:
            entries = [self._public(e) for e in self._entries.values()
                       if "error" not in e]
        for e in entries:
            k = e["kernel"]
            temp = e.get("peak_temp_bytes")
            reg.gauge("dht_kernel_flops", kernel=k).set(e["flops_model"])
            reg.gauge("dht_kernel_bytes_accessed", kernel=k).set(
                e["bytes_bound"])
            reg.gauge("dht_kernel_hbm_bytes", kernel=k).set(
                e["argument_bytes"] + e["output_bytes"] + (temp or 0))
            reg.gauge("dht_kernel_temp_bytes", kernel=k).set(
                -1.0 if temp is None else temp)
            reg.gauge("dht_kernel_launches", kernel=k).set(e["launches"])
            if "device_ms" in e:
                reg.gauge("dht_kernel_device_seconds", kernel=k).set(
                    e["device_ms"] / 1e3)
                rl = e.get("roofline") or {}
                if rl:
                    reg.gauge("dht_kernel_roofline_hbm_pct", kernel=k).set(
                        rl["hbm_pct_of_peak"])
                    reg.gauge("dht_kernel_roofline_flops_pct",
                              kernel=k).set(rl["flops_pct_of_peak"])
        with self._lock:
            self._exported = True
        return len(entries)

    # ----------------------------------------------------- trace-span hook
    def wave_cost(self, wave_width: int, rounds: int,
                  mode: str = "single", mesh_t: int = 1) -> dict:
        """Cost estimate for one LIVE search wave, scaled from the
        matching canonical engine entry (``simulate_lookups``, or
        ``tp_simulate_lookups`` for ``mode="tp"``): est = canonical x
        (width / W_c) x rounds, per-device table traffic divided by
        ``mesh_t``.  An approximation by construction, as the JAX
        ledger's, and the attrs name the entry it came from.  Pure dict
        math — safe on the record_wave path."""
        src = ("tp_simulate_lookups" if mode == "tp"
               else "simulate_lookups")
        entry = self._entries.get(src)
        if not entry or "error" in entry or rounds <= 0:
            return {}
        w_c = entry["shape"]["W"]
        scale = (wave_width / float(w_c)) * rounds
        t = max(1, int(mesh_t))
        attrs = {
            "est_device_bytes": int(entry["bytes_bound"] * scale / t),
            "est_device_flops": int(entry["flops_model"] * scale / t),
            "cost_model": "%s bytes_bound x width/%d x rounds" % (src, w_c),
        }
        if t > 1:
            attrs["cost_model"] += " / t=%d (row-sharded)" % t
            attrs["table_shard_t"] = t
        return attrs

    def ingest_wave_cost(self, occupancy: int, mesh_t: int = 1) -> dict:
        """Cost estimate for one LIVE ingest wave, scaled from the
        canonical coalesced-launch entry (``wave_builder_lookup``) by
        occupancy, per-device table traffic divided by ``mesh_t``.  Pure
        dict math, safe on the wave-scatter path."""
        entry = self._entries.get("wave_builder_lookup")
        if not entry or "error" in entry:
            return {}
        t = max(1, int(mesh_t))
        scale = occupancy / float(entry["shape"]["Q"]) / t
        return {
            "est_device_bytes": int(entry["bytes_bound"] * scale),
            "cost_model": "wave_builder_lookup x occupancy/%d%s"
                          % (entry["shape"]["Q"],
                             " / t=%d (row-sharded)" % t if t > 1 else ""),
        }


_ledger = KernelLedger()


def get_ledger() -> KernelLedger:
    """The process-global ledger every export surface reads."""
    return _ledger


def ledger_computed() -> bool:
    return _ledger.computed()


def maybe_export(reg=None, *, device=None) -> int:
    """Export hook for ``DhtRunner.get_metrics()``: publishes the ledger
    IF it has been computed, and computes it first (on ``device``, the
    node's) when ``OPENDHT_TPU_LEDGER=1`` arms eager mode.  Never
    raises; returns kernels exported (0 = ledger off)."""
    try:
        if not _ledger.computed():
            if os.environ.get("OPENDHT_TPU_LEDGER", "") not in (
                    "1", "true", "on"):
                return 0
            _ledger.compute(device=device)
        return _ledger.export_to_registry(reg)
    except Exception:
        return 0


def ingest_wave_attrs(occupancy: int, mesh_t: int = 1) -> dict:
    """Device-cost attributes for an ingest ``dht.search.wave`` span
    (runtime/wave_builder.py): empty dict (a cached-flag check) until
    the ledger is computed."""
    if not _ledger.computed():
        return {}
    return _ledger.ingest_wave_cost(occupancy, mesh_t)


def wave_attrs(wave_width: int, rounds: int, elapsed_s: float,
               mode: str = "single", mesh_t: int = 1) -> dict:
    """Device-cost attributes for a ``dht.search.wave`` trace span
    (core/search.py record_wave): the scaled estimate plus the HBM share
    it implies over the wave's host-measured elapsed, against the peaks
    row of the device the engine entry was computed on.  Empty dict
    until someone computes the ledger."""
    if not _ledger.computed():
        return {}
    attrs = _ledger.wave_cost(wave_width, rounds, mode, mesh_t)
    if attrs and elapsed_s > 0:
        src = ("tp_simulate_lookups" if mode == "tp"
               else "simulate_lookups")
        peaks = platform_peaks(_ledger._entries[src].get("platform", "cpu"))
        attrs["est_hbm_pct_of_peak"] = (
            100.0 * (attrs["est_device_bytes"] / elapsed_s)
            / peaks["hbm_bytes_per_s"])
        attrs["peak_key"] = peaks.get("peak_key", "?")
    return attrs
