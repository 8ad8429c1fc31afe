#!/usr/bin/env python3
"""Drive the torch port (opendht_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                 # the full run on the card
    python3 chip_smoke.py --cpu --n 20000 --q 512 \
        --search-n 20000 --search-q 256 --search-waves 2   # rehearsal

Phases, one JSON line each:

1. device  — torch's device name and nvidia-smi's name and power limit;
             fails without a card.
2. build   — both CUDA kernels (opendht_tpu_torch/csrc/*.cu) built with
             nvcc for sm_90a; build seconds and ptxas register counts.
3. parity  — (printed after main, whose inputs it reuses) each kernel
             against its plain torch version on the card, bit
             for bit: window_select at k ∈ {1,8,14,16,21} on edge-case rows
             (bounds 0, 1, 191, 192, full ties, all-ones distances), with
             a row_index (many queries on one row, the first and last
             rows) at k ∈ {1,8,16,21}, and on the main path's own
             (expanded, j); lex_topk_select at W ∈ {32,128,256,1024},
             k ∈ {8,16} with invalid rows and exhaustion, and on the main
             path's own windows.
4. main    — NodeTable(device="cuda").bulk_load(1,000,000 seeded ids), then
             find_closest on 131,072 seeded targets at k=16 and k=8, then
             lookup_topk(expanded=None, window=128, k=16) on the same
             snapshot, with both kernels' launch counts zeroed just before
             and read just after; results checked against the port's exact
             xor_topk on 256 rows and a numpy oracle on 32 rows.
5. timing  — CUDA-event medians (≥ 5 reps after warm-up) of each kernel,
             its plain version and the plain fast3 select at the main
             path's shape, window_select on pre-gathered rows and the
             expanded[j] row gather alone (what reading in place removes),
             and host-clock medians of the whole calls.
6. profile — torch.profiler over one find_closest k=16 call: device time
             by kernel and copy, and the device's busy share of the call.
7. memory  — the peak device memory one find_closest k=16 call allocates
             beyond what was allocated before it (the snapshot's expansion
             already built); fails unless it is below the Q·970·4 bytes that
             gathered [Q, 970] rows alone would take.
8. search  — BASELINE config 3: 10,000,000 seeded ids sorted on the card
             with the LUT at default_lut_bits (24), then 16 waves of
             65,536 seeded targets through simulate_lookups at α=3, k=8,
             state_limbs=2 (1,048,576 lookups).  Checks: wave 0 equals
             the same engine on the CPU for its first 512 rows (same
             global query ids and batch size); state_limbs=5 gives the
             same wave; the three tests/goldens/search_engine.json hashes
             on the card; recall ≥ 0.95 against xor_topk on 256 rows;
             every lookup converged.  Reports hops, the wave time (CUDA
             events, waves in turn), lookups/s, rounds and ms per round,
             the host-clock time of all waves, the sort+LUT time, the
             engine's host syncs per wave, and a torch.profiler pass over
             one wave by round stage (search.select / reply / gather /
             merge / done / sync) and by op.
9. maintenance — BASELINE config 4: maintenance_sweep over 10,000,000
             seeded ids with seeded reply times (a quarter never replied)
             equal to a numpy oracle (np.bincount, np.maximum.at in
             float32), every refresh target in its bucket; CUDA-event
             median of the sweep.  (--search-n sizes both phases.)
10. churn  — BASELINE config 6: 10,000,000 seeded ids sorted on the card
             with the LUT (24 bits) and the 2-plane stride-64 expansion;
             512 evictions + 512 inserts per round into a 65,536-row
             delta, advanced 64 rounds (half the compaction cycle); one
             round = tombstone-word scatter, delta slab update, delta
             sort / 2-plane stride-16 and stride-64 expansions / LUT, and
             churn_lookup_topk (fast2, planes=2, lut_steps=0, d_cap=4096)
             over 131,072 seeded targets at k=8, repair included.  CUDA
             events: the round, the static fast2 lookup on the same table,
             expanded_topk(select="kernel") on the 5-plane expansion, one
             compaction (sort, 2-plane expansion, LUT of live base ∪
             delta); host-clock mutation prep per round; derived sustained
             lookups/s = Q / (round + prep + compaction / 128), mutations/s
             and churny/static; a profile of one round by stage
             (churn.absorb / delta_build / base / delta / merge /
             fallback).  Checks: on 256 seeded queries the fast3 churn
             lookup equals xor_topk over live base ∪ delta (distances and
             encodings) and fast2's encodings equal fast3's; 64 queries in
             a fully tombstoned stretch all fall back and come out exact;
             merge pack 16 equals pack 1; and at table level 1,000,000
             ids through 8 batches of bulk_load / insert / on_expired /
             remove that cross the delta and tombstone limits, with
             find_closest through the churn view equal to a table rebuilt
             from the same host state after every batch and at least one
             background compaction swapped.  (--churn-* flags size it.)

Then the kernels line ({"kernels": [...]}) and, last, the ok line.  Any
failure raises (nonzero exit, no ok line).  Without a card it exits
nonzero before any result; ``--cpu`` rehearses every phase on the host
with the plain versions and also ends without the ok line, as does a
partial run (``--phases churn``: phases 1-7, then only the churn phase).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
OPS_PER_S = 67e12              # H100 SXM 32-bit rate outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_abs_err(a, b) -> int:
    import torch
    require(a.shape == b.shape, f"shapes {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def median_ms(fn, *, reps: int = 7, inner: int = 1, warmup: int = 2,
              cuda: bool = True) -> float:
    """Median per-call time of ``fn``: CUDA events around ``inner`` calls
    (host clock with a synchronize on the CPU rehearsal)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(inner):
                fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / inner)
        else:
            s = time.perf_counter()
            for _ in range(inner):
                fn()
            times.append((time.perf_counter() - s) * 1e3 / inner)
    return statistics.median(times)


def host_median_ms(fn, *, reps: int = 5, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s = time.perf_counter()
        fn()
        times.append((time.perf_counter() - s) * 1e3)
    return statistics.median(times)


def edge_window_inputs(rng, Q):
    """Random expanded rows with bounds 0, 1, 191, 192 and random, full
    160-bit ties, valid lanes at all-ones distance, ties on limb 0 alone
    across all lanes, and ties on limbs 0..3 between the two candidates
    of one thread (lanes L and L+32) (uint32 numpy; Q >= 224)."""
    rows = rng.integers(0, 2**32, size=(Q, 5 * 194), dtype=np.uint32)
    q8 = rng.integers(0, 2**32, size=(Q, 8), dtype=np.uint32)
    b = rng.integers(0, 193, size=Q).astype(np.int32)
    b[:4] = (0, 1, 191, 192)
    planes = rows.reshape(Q, 5, 194)
    planes[4:64] = planes[4:64, :, :1]              # one id in every lane
    planes[64:128, :, 1:40] = planes[64:128, :, 1:2]
    b[4:128] = 192
    planes[128:160, :, 1:4] = ~q8[128:160, :5, None]
    planes[160:192, 0, 1:] = planes[160:192, 0, 1:2]
    planes[192:224, :4, 33:65] = planes[192:224, :4, 1:33]
    b[160:224] = 192
    return rows, q8, np.repeat(b[:, None], 8, axis=1)


def row_index_inputs(rng, q8_rows, b_rows, Q):
    """Queries on rows of the edge table: a quarter on one full-tie row,
    64 each on the first and last rows, the rest random.  Half take their
    row's own query limbs and bounds (so all-ones rows stay all-ones);
    four take bounds 0, 1, 191, 192 (uint32 / int32 numpy)."""
    NB = q8_rows.shape[0]
    ri = rng.integers(0, NB, size=Q).astype(np.int32)
    ri[:Q // 4] = 5
    ri[Q // 4:Q // 4 + 64] = 0
    ri[Q // 4 + 64:Q // 4 + 128] = NB - 1
    q8 = rng.integers(0, 2**32, size=(Q, 8), dtype=np.uint32)
    b = np.repeat(rng.integers(0, 193, size=Q).astype(np.int32)[:, None], 8,
                  axis=1)
    own = rng.random(Q) < 0.5
    q8[own], b[own] = q8_rows[ri[own]], b_rows[ri[own]]
    b[Q // 2:Q // 2 + 4] = np.array([0, 1, 191, 192], np.int32)[:, None]
    return ri, q8, b


def edge_lex_inputs(rng, Q, W):
    """Distances with duplicate ids, exhaustion, rows with nothing valid,
    random invalid masks, ties on limb 0 alone, and ties on limbs 0..3
    between positions p and p+32 (one thread's two candidates, W >= 64);
    Q >= 384."""
    q = rng.integers(0, 2**32, size=(Q, 5), dtype=np.uint32)
    t = rng.integers(0, 2**32, size=(Q, W, 5), dtype=np.uint32)
    t[:64] = t[:64, :1]                             # duplicate ids
    t[256:320, :, 0] = t[256:320, :1, 0]
    if W >= 64:
        t[320:384, 32:64, :4] = t[320:384, :32, :4]
    inv = np.zeros((Q, W), np.int32)
    inv[64:128, 5:] = 1                             # exhaustion after 5
    inv[128:160] = 1                                # nothing valid
    inv[160:256] = rng.integers(0, 2, size=(96, W))
    return q[:, None, :] ^ t, inv


CONFIG3 = dict(alpha=3, k=8, state_limbs=2)     # BASELINE.json config 3
OUT_KEYS = ("nodes", "hops", "converged", "dist")
GOLDENS = Path(__file__).resolve().parent / "tests" / "goldens" \
    / "search_engine.json"


def outputs_np(out) -> dict:
    """simulate_lookups' tensors as the JAX package's numpy arrays."""
    from opendht_tpu_torch.ops.ids import from_keys
    return {key: (from_keys(out[key]) if key == "dist"
                  else out[key].cpu().numpy()) for key in OUT_KEYS}


def same_outputs(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[key], b[key]) for key in OUT_KEYS)


def golden_hashes(dev) -> dict:
    """sha256 of the engine's outputs in the three modes of
    tests/goldens/search_engine.json, run on ``dev``."""
    from opendht_tpu_torch.core.search import simulate_lookups
    from opendht_tpu_torch.ops.ids import to_keys
    from opendht_tpu_torch.ops.sorted_table import sort_table
    rng = np.random.default_rng(1234)
    ids = rng.integers(0, 2**32, size=(4096, 5), dtype=np.uint32)
    targets = to_keys(rng.integers(0, 2**32, size=(96, 5), dtype=np.uint32),
                      dev)
    s, _, n = sort_table(to_keys(ids, dev))
    hashes = {}
    for tag, kw in (("lut_l5", {}), ("lut_l2", {"state_limbs": 2}),
                    ("exact_l5", {"block_mode": "exact"})):
        out = outputs_np(simulate_lookups(s, n, targets, seed=99,
                                          device=dev, **kw))
        h = hashlib.sha256()
        for key in OUT_KEYS:
            h.update(np.ascontiguousarray(out[key]).tobytes())
        hashes[tag] = h.hexdigest()
    return hashes


def search_phase(args, dev, card, sync) -> None:
    """BASELINE config 3: ``--search-waves`` waves of ``--search-q``
    lookups at α=3, k=8, state_limbs=2 against ``--search-n`` seeded ids
    sorted on the device, with the LUT at default_lut_bits(N); checks,
    timing and a per-round profile (see the module docstring)."""
    import torch
    from opendht_tpu_torch.core import search as SE
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.ops import sorted_table as ST
    from opendht_tpu_torch.ops.xor_topk import xor_topk
    cuda = dev.type == "cuda"
    N, Q, W = args.search_n, args.search_q, args.search_waves
    rng = np.random.default_rng(args.seed + 3)
    ids = IK.to_keys(rng.integers(0, 2**32, size=(N, 5), dtype=np.uint32),
                     dev)
    targets = IK.to_keys(rng.integers(0, 2**32, size=(W, Q, 5),
                                      dtype=np.uint32), dev)
    sync()
    t0 = time.perf_counter()
    sorted_ids, _perm, n_valid = ST.sort_table(ids)
    bits = ST.default_lut_bits(N)
    lut = ST.build_prefix_lut(sorted_ids, n_valid, bits=bits)
    sync()
    sort_lut_s = time.perf_counter() - t0
    del ids, _perm
    n = int(n_valid)
    kw = dict(CONFIG3, lut=lut, seed=args.seed)

    def wave(w, **extra):
        return SE.simulate_lookups(sorted_ids, n, targets[w], device=dev,
                                   **{**kw, **extra})

    t0 = time.perf_counter()
    outs = [wave(w) for w in range(W)]
    sync()
    all_waves_s = time.perf_counter() - t0
    outs = [outputs_np(o) for o in outs]
    hops = np.concatenate([o["hops"] for o in outs])
    converged = np.concatenate([o["converged"] for o in outs])

    # (a) the card's wave 0 == the same engine on the CPU, first rows:
    # same table and LUT, same global query ids and batch size
    rows = min(512, Q)
    gp, lower, bb = SE.table_primitives(sorted_ids.cpu(), n, lut.cpu())
    ref = outputs_np(SE._lookup_engine(
        gp, lower, n, targets[0, :rows].cpu(),
        torch.arange(rows, dtype=torch.int32), Q, args.seed & 0xFFFFFFFF,
        k=CONFIG3["k"], alpha=CONFIG3["alpha"],
        search_nodes=SE.SEARCH_NODES, max_hops=48,
        state_limbs=CONFIG3["state_limbs"], block_bounds=bb))
    require(same_outputs({k: v[:rows] for k, v in outs[0].items()}, ref),
            f"wave 0 on the device == the CPU engine on its first {rows} "
            "rows")
    # (b) state_limbs=2 == state_limbs=5
    require(same_outputs(outs[0], outputs_np(wave(0, state_limbs=5))),
            "state_limbs=2 == state_limbs=5 on wave 0")
    # (c) the committed reply-stream goldens, run on the device
    with open(GOLDENS) as f:
        gold = json.load(f)
    hashes = golden_hashes(dev)
    require(all(hashes[t] == gold[t]["sha256"] for t in hashes),
            "the three search_engine.json goldens on the device")
    # (d) recall against the exact xor_topk
    nr = min(256, Q)
    _, ei = xor_topk(targets[0, :nr], sorted_ids, k=8,
                     tile=ST.scan_tile(N, nr),
                     valid=torch.arange(N, device=dev) < n)
    ei = ei.cpu().numpy()
    recall = float(np.mean([len(set(outs[0]["nodes"][i]) & set(ei[i])) / 8
                            for i in range(nr)]))
    require(recall >= 0.95, f"recall {recall} >= 0.95 against xor_topk")
    # (e) every lookup converged
    require(bool(converged.all()), "every lookup converged")

    # timing: the whole call, the waves in turn (CUDA events)
    turn = iter(range(10**9))
    wave_ms = median_ms(lambda: wave(next(turn) % W), reps=5, warmup=1,
                        cuda=cuda)
    syncs = "not measured"
    if cuda:
        # the engine's own device→host syncs in one wave
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                SE._simulate_lookups(sorted_ids, n, targets[0], **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)

    # one wave under the profiler: time by round stage and by op
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        s = time.perf_counter()
        wave(min(1, W - 1))
        sync()
        wall_ms = (time.perf_counter() - s) * 1e3
    ka = prof.key_averages()

    def ms(e, self_only=False):
        if cuda:
            return (e.self_device_time_total if self_only
                    else e.device_time_total) / 1e3
        return (e.self_cpu_time_total if self_only
                else e.cpu_time_total) / 1e3

    stages = {e.key: {"calls": e.count, "ms": ms(e)} for e in ka
              if e.key.startswith("search.")
              and e.device_type != torch.autograd.DeviceType.CUDA}
    rounds = stages.get("search.select", {}).get("calls", 0)
    kern = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(("search.", "dht_"))]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    ops = sorted((e for e in ka if e.key.startswith("aten::")),
                 key=lambda e: ms(e, True), reverse=True)[:12]
    emit({"phase": "search", **card, "config": "BASELINE.json config 3",
          "n": N, "q": Q, "waves": W, "lookups": W * Q, **CONFIG3,
          "lut_bits": bits, "sort_and_lut_s": sort_lut_s,
          "all_waves_host_s": all_waves_s, "wave_ms": wave_ms,
          "lookups_per_s": Q / wave_ms * 1e3,
          "hops_p50": float(np.percentile(hops, 50)),
          "hops_p95": float(np.percentile(hops, 95)),
          "hops_max": int(hops.max()), "rounds_per_wave": rounds,
          "ms_per_round": wave_ms / rounds if rounds else None,
          "host_syncs_per_wave": syncs,
          "checks": {"cpu_rows_identical": rows, "state_limbs_2_eq_5": True,
                     "goldens": list(hashes), "recall": recall,
                     "recall_rows": nr,
                     "converged": int(converged.sum())},
          "profile": {"wall_ms": wall_ms,
                      "device_ms": dev_ms if cuda else "not measured",
                      "device_busy_share": (dev_ms / wall_ms if cuda
                                            else "not measured"),
                      "time": "device" if cuda else "host (rehearsal)",
                      "note": "wall_ms includes the profiler's overhead",
                      "stages": stages,
                      "top_ops": [{"name": e.key, "calls": e.count,
                                   "self_ms": ms(e, True)} for e in ops]}})


def clz32_np(x: np.ndarray) -> np.ndarray:
    n = np.zeros(x.shape, np.int32)
    for s in (16, 8, 4, 2, 1):
        top = x < np.uint32(1 << (32 - s))
        n += np.where(top, s, 0).astype(np.int32)
        x = np.where(top, x << np.uint32(s), x)
    return np.where(x == 0, 32, n)


def common_bits_np(me: np.ndarray, ids: np.ndarray) -> np.ndarray:
    x = ids ^ me
    out = np.full(x.shape[:-1], 160, np.int32)
    prev_zero = np.ones(x.shape[:-1], bool)
    for i in range(5):
        first = prev_zero & (x[..., i] != 0)
        out = np.where(first, 32 * i + clz32_np(x[..., i]), out)
        prev_zero &= x[..., i] == 0
    return out


def maintenance_phase(args, dev, card) -> None:
    """BASELINE config 4: the bucket-maintenance sweep over
    ``--search-n`` seeded ids (2 % invalid, a quarter never replied)
    against a numpy oracle."""
    import torch
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.ops import radix
    N = args.search_n
    rng = np.random.default_rng(args.seed + 4)
    me = rng.integers(0, 2**32, size=5, dtype=np.uint32)
    ids_np = rng.integers(0, 2**32, size=(N, 5), dtype=np.uint32)
    valid_np = rng.random(N) > 0.02
    now, age = 1.7e9, 600.0
    last_np = now - rng.uniform(0, 1200, size=N)
    last_np[rng.random(N) < 0.25] = 0.0                  # never replied
    me_k, ids_k = IK.to_keys(me, dev), IK.to_keys(ids_np, dev)
    valid_t = torch.from_numpy(valid_np).to(dev)
    last_t = torch.from_numpy(last_np).to(dev)          # float64, as held
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def sweep():
        return radix.maintenance_sweep(me_k, ids_k, valid_t, last_t, now,
                                       age, gen, device=dev)

    counts, last, stale, targets = sweep()
    b = np.minimum(common_bits_np(me, ids_np), 159)
    want_counts = np.bincount(b[valid_np], minlength=160)
    lr = last_np.astype(np.float32)
    m = valid_np & (lr > 0)
    want_last = np.full(160, -np.inf, np.float32)
    np.maximum.at(want_last, b[m], lr[m])
    want_stale = (want_counts > 0) & (want_last < np.float32(now)
                                      - np.float32(age))
    require(np.array_equal(counts.cpu().numpy(), want_counts),
            "sweep counts == np.bincount")
    require(np.array_equal(last.cpu().numpy(), want_last),
            "sweep last == np.maximum.at in float32")
    require(np.array_equal(stale.cpu().numpy(), want_stale),
            "sweep stale == the numpy oracle")
    require(np.array_equal(common_bits_np(me, IK.from_keys(targets)),
                           np.arange(160)), "every target in its bucket")
    sweep_ms = median_ms(sweep, reps=5, cuda=dev.type == "cuda")
    nbytes = N * (5 * 4 + 1 + 8)         # ids, valid, float64 reply times
    emit({"phase": "maintenance", **card, "config": "BASELINE.json config 4",
          "n": N, "sweep_ms": sweep_ms, "bytes": nbytes,
          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
          "occupied": int((want_counts > 0).sum()),
          "stale": int(want_stale.sum()),
          "checks": ["counts", "last", "stale", "targets in bucket"]})


CONFIG6 = dict(k=8, select="fast2", lut_steps=0, planes=2, d_cap=4096)


class ChurnState:
    """The host side of BASELINE config 6's churn rounds
    (benchmarks/baseline_configs.py:539-579 with a numpy generator): a
    tombstone mask over the base's sorted positions and an append-only
    delta slab.  Each round evicts ``e`` distinct live positions and
    appends ``e`` fresh ids."""

    def __init__(self, nv: int, n: int, dcap: int, e: int, seed: int):
        self.rng = np.random.default_rng(seed)
        self.nv, self.e = nv, e
        self.tomb = np.zeros((n + 31) // 32, np.uint32)
        self.live = np.zeros(n, bool)
        self.live[:nv] = True
        self.delta = np.zeros((dcap, 5), np.uint32)
        self.n_delta = 0

    def round(self):
        """One round's mutations on the host; returns (word indices [E]
        padded by repetition, their post-round values, new ids [E,5],
        first delta slot)."""
        picks: list = []
        seen: set = set()
        while len(picks) < self.e:
            for c in self.rng.integers(0, self.nv, size=2 * self.e):
                c = int(c)
                if self.live[c] and c not in seen:
                    seen.add(c)
                    picks.append(c)
                    if len(picks) == self.e:
                        break
        pos = np.array(picks, np.int64)
        self.live[pos] = False
        np.bitwise_or.at(self.tomb, pos >> 5,
                         np.uint32(1) << (pos & 31).astype(np.uint32))
        w = np.unique(pos >> 5)
        widx = np.full(self.e, w[-1], np.int64)
        widx[:len(w)] = w
        new_ids = self.rng.integers(0, 2**32, size=(self.e, 5),
                                    dtype=np.uint32)
        nd0 = self.n_delta
        self.delta[nd0:nd0 + self.e] = new_ids
        self.n_delta = nd0 + self.e
        return widx, self.tomb[widx], new_ids, nd0


def churn_table_check(args, dev, sync) -> dict:
    """NodeTable level: ``--churn-table-n`` ids bulk-loaded on the
    device, then 8 batches of mutations through bulk_load / insert /
    on_expired / remove that together cross the delta limit and the
    tombstone limit; after each batch find_closest through the churn view
    equals find_closest on a table rebuilt from the same host state."""
    from opendht_tpu_torch import InfoHash, NodeTable, convert, tracing
    from opendht_tpu_torch.core import table as CT
    from opendht_tpu_torch.ops import ids as IK
    rng = np.random.default_rng(args.seed + 60)
    n0 = args.churn_table_n
    tomb_limit = max(CT.TOMB_MIN, n0 // CT.TOMB_FRAC)
    per_batch = tomb_limit // 3 + 1          # crosses within 3-4 batches
    bulk_per = 100                           # bulk loads that fit the delta
    ins_per = CT.DELTA_CAP * 2 // 5 + 1      # inserts overflow it at batch 3
    self_id = InfoHash(rng.integers(0, 256, size=20, dtype=np.uint8)
                       .tobytes())
    table = NodeTable(self_id, k=1 << 30, capacity=n0,
                      device=None if dev.type == "cuda" else "cpu")
    table.bulk_load(rng.integers(0, 2**32, size=(n0, 5), dtype=np.uint32),
                    now=1.0)
    table.snapshot(now=1.0)
    targets = rng.integers(0, 2**32, size=(args.churn_q, 5), dtype=np.uint32)
    swaps0 = len(tracing.get_tracer().events(name="table_churn_swap"))
    batches = []
    for b in range(8):
        fresh = rng.integers(0, 2**32, size=(bulk_per + ins_per, 5),
                             dtype=np.uint32)
        table.bulk_load(fresh[:bulk_per], now=2.0 + b)
        for row in IK.ids_to_bytes(fresh[bulk_per:]):
            table.insert(InfoHash(row.tobytes()), None, 2.0 + b, confirm=2)
        live = np.nonzero(table._valid & ~table._expired)[0]
        pick = rng.choice(live, size=per_batch, replace=False)
        raw = IK.ids_to_bytes(table._ids[pick])
        for i, r in enumerate(raw):
            h = InfoHash(r.tobytes())
            if i % 4:
                table.on_expired(h)
            else:
                table.remove(h)
        pending = table._pending_base is not None
        sync()
        t0 = time.perf_counter()
        got = table.find_closest(targets, now=20.0)
        churn_s = time.perf_counter() - t0
        state = {name: getattr(table, "_" + name)
                 for name in convert.SLAB_COLUMNS + ("bucket_count",)}
        ref = convert.node_table_from_numpy(
            bytes(self_id), state, device=None if dev.type == "cuda"
            else "cpu", k=table.k)
        sync()
        t0 = time.perf_counter()
        ref.snapshot(now=20.0)
        want = ref.find_closest(targets, now=20.0)
        rebuilt_s = time.perf_counter() - t0
        require(np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1]),
                f"churn view find_closest == rebuilt table, batch {b}")
        batches.append({"batch": b, "churn_pending": table.churn_pending,
                        "compaction_pending_after_mutations": pending,
                        "compactions": table.compactions,
                        "find_closest_churn_s": churn_s,
                        "rebuild_and_find_closest_s": rebuilt_s})
        del ref
    swaps = len(tracing.get_tracer().events(name="table_churn_swap")) - swaps0
    require(swaps >= 1 and any(b["compaction_pending_after_mutations"]
                               for b in batches),
            "a background compaction was dispatched and swapped")
    return {"table_n": n0, "q": args.churn_q, "tomb_limit": tomb_limit,
            "evictions_per_batch": per_batch, "bulk_loaded_per_batch":
            bulk_per, "inserts_per_batch": ins_per, "swaps": swaps,
            "compactions": table.compactions, "batches": batches}


def churn_phase(args, dev, card, sync) -> None:
    """BASELINE config 6 (benchmarks/baseline_configs.py:472-710):
    ``--churn-n`` seeded ids sorted on the device with their LUT and
    2-plane stride-64 expansion; ``--churn-e`` evictions and inserts per
    round into a delta of ``--churn-dcap`` rows, advanced half a
    compaction cycle; one round served with fast2 / planes=2 /
    lut_steps=0 and a stride-16 delta with a stride-64 rescue.  Timing,
    derived throughput, a per-stage profile and the checks of the module
    docstring."""
    import torch
    from torch.profiler import record_function
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.ops import sorted_table as ST
    from opendht_tpu_torch.ops.xor_topk import xor_topk
    cuda = dev.type == "cuda"
    N, Q, DCAP, E = args.churn_n, args.churn_q, args.churn_dcap, args.churn_e
    require(2 * E <= DCAP, "2·E <= delta capacity")
    k = CONFIG6["k"]
    rng = np.random.default_rng(args.seed + 6)
    ids = IK.to_keys(rng.integers(0, 2**32, size=(N, 5), dtype=np.uint32),
                     dev)
    queries = IK.to_keys(rng.integers(0, 2**32, size=(Q, 5),
                                      dtype=np.uint32), dev)
    sorted_ids, _perm, n_valid = ST.sort_table(ids)
    del ids, _perm
    expanded = ST.expand_table(sorted_ids, limbs=2)
    lut_bits = ST.default_lut_bits(N)
    lut = ST.build_prefix_lut(sorted_ids, n_valid, bits=lut_bits)
    nv = int(n_valid)
    d_bits = ST.default_lut_bits(DCAP)

    host = ChurnState(nv, N, DCAP, E, args.seed + 7)
    warm = max(2, min(max(4, (DCAP // E) // 2), DCAP // E))
    t0 = time.perf_counter()
    for _ in range(warm - 1):
        host.round()
    host_prep_ms = (time.perf_counter() - t0) * 1e3 / (warm - 1)
    widx, wval, new_ids, nd0 = host.round()
    widx = torch.from_numpy(widx).to(dev)
    wval = ST.tomb_tensor(wval, dev)
    new_ids = IK.to_keys(new_ids, dev)
    tomb_base = ST.tomb_tensor(host.tomb, dev)
    dslab = IK.to_keys(host.delta, dev)
    nd_after = host.n_delta

    def delta_tables(slab, strides=((16, 2), (64, 2))):
        dvalid = torch.arange(DCAP, device=dev) < nd_after
        ds, _dp, dnv = ST.sort_table(slab, dvalid)
        exps = [ST.expand_table(ds, stride=s, limbs=l) for s, l in strides]
        return ds, exps, ST.build_prefix_lut(ds, dnv, bits=d_bits)

    def round_body():
        """One round: the tombstone-word scatter and the delta slab update
        (values precomputed, so rounds repeat identically), the delta's
        sort / expansion / LUT and the churn lookup, repair included."""
        with record_function("churn.absorb"):
            tomb = tomb_base.clone()
            tomb[widx] = wval
            slab = dslab.clone()
            slab[nd0:nd0 + E] = new_ids
        with record_function("churn.delta_build"):
            ds, (de, dew), dlut = delta_tables(slab)
        return ST.churn_lookup_topk(sorted_ids, expanded, nv, tomb, ds, de,
                                    nd_after, queries, lut=lut, d_lut=dlut,
                                    d_exp_wide=dew, **CONFIG6)

    _, enc_round, cert = round_body()
    require(tuple(enc_round.shape) == (Q, k) and bool(cert.all()),
            "a churn round returns [Q, k] certified encodings")
    round_ms = median_ms(round_body, reps=7, cuda=cuda)
    static_ms = median_ms(lambda: ST.expanded_topk(
        sorted_ids, expanded, nv, queries, k=k, select="fast2", lut=lut,
        lut_steps=0, planes=2), reps=7, cuda=cuda)
    exp5 = ST.expand_table(sorted_ids)
    kernel_ms = median_ms(lambda: ST.expanded_topk(
        sorted_ids, exp5, nv, queries, k=k, select="kernel", lut=lut,
        lut_steps=0), reps=7, cuda=cuda)
    # flags of the round before its repair (outside the timed calls)
    ds, (de, dew), dlut = delta_tables(dslab)
    launch = ST.churn_lookup_launch(sorted_ids, expanded, nv, tomb_base, ds,
                                    de, nd_after, queries, lut=lut,
                                    d_lut=dlut, d_exp_wide=dew, **CONFIG6)
    flags = launch.flags.cpu()
    repaired = {"base_uncertified": int(((flags & 1) != 0).sum()),
                "delta_uncertified": int(((flags & 2) != 0).sum()),
                "merge_ties": int(((flags & 4) != 0).sum())}

    def compact():
        live = (torch.arange(N, device=dev) < nv) \
            & ~ST.unpack_tomb_bits(tomb_base, N)
        cat = torch.cat([sorted_ids, dslab])
        cval = torch.cat([live, torch.arange(DCAP, device=dev) < nd_after])
        s2, _p2, nv2 = ST.sort_table(cat, cval)
        return (s2, ST.expand_table(s2, limbs=2),
                ST.build_prefix_lut(s2, nv2, bits=lut_bits))

    compact_ms = median_ms(compact, reps=3, warmup=1, cuda=cuda)
    rounds_per_compaction = max(1, DCAP // E)
    syncs = "not measured"
    if cuda:
        # device→host syncs of one round (by design: the flag read)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                round_body()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sites = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]
        syncs = {"count": len(sites), "sites": sites}

    # profile of one round by stage
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        s = time.perf_counter()
        round_body()
        sync()
        wall_ms = (time.perf_counter() - s) * 1e3
    ka = prof.key_averages()
    dtime = (lambda e: e.device_time_total / 1e3) if cuda \
        else (lambda e: e.cpu_time_total / 1e3)
    stages = {e.key: {"calls": e.count, "ms": dtime(e)} for e in ka
              if e.key.startswith("churn.")
              and e.device_type != torch.autograd.DeviceType.CUDA}
    kern = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("churn.")]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    ops = sorted((e for e in ka if e.key.startswith("aten::")),
                 key=lambda e: (e.self_device_time_total if cuda
                                else e.self_cpu_time_total), reverse=True)[:10]

    # checks at the advanced state (tombstones and delta as served)
    nq = min(256, Q)
    qs = IK.to_keys(rng.integers(0, 2**32, size=(nq, 5), dtype=np.uint32),
                    dev)
    ds5, (de5,), dlut5 = delta_tables(dslab, ((32, 5),))
    dist3, enc3, _ = ST.churn_lookup_topk(sorted_ids, exp5, nv, tomb_base,
                                          ds5, de5, nd_after, qs, lut=lut,
                                          d_lut=dlut5, k=k, select="fast3")
    _, enc2, _ = ST.churn_lookup_topk(sorted_ids, expanded, nv, tomb_base, ds,
                                      de, nd_after, qs, lut=lut, d_lut=dlut,
                                      d_exp_wide=dew, **CONFIG6)
    live_np = torch.from_numpy(host.live).to(dev)
    cat = torch.cat([sorted_ids, ds])
    cval = torch.cat([live_np, torch.arange(DCAP, device=dev) < nd_after])
    d_ref, i_ref = xor_topk(qs, cat, k=k, tile=ST.scan_tile(N + DCAP, nq),
                            valid=cval)
    require(torch.equal(dist3, d_ref) and torch.equal(enc3, i_ref),
            "fast3 churn lookup == xor_topk over live base ∪ delta")
    require(torch.equal(enc2, enc3), "fast2 encodings == fast3's")
    # tomb-heavy: every row of a stretch of windows dead
    lo = nv // 3
    heavy_np = host.tomb.copy()
    heavy_live = host.live.copy()
    heavy_live[lo:lo + 4096] = False
    pos = np.arange(lo, lo + 4096)
    np.bitwise_or.at(heavy_np, pos >> 5,
                     np.uint32(1) << (pos & 31).astype(np.uint32))
    heavy = ST.tomb_tensor(heavy_np, dev)
    qh = sorted_ids[lo + 512:lo + 3584:48][:64].clone()  # windows all dead
    qh[:, 4] ^= 1
    hl = ST.churn_lookup_launch(sorted_ids, expanded, nv, heavy, ds, de,
                                nd_after, qh, lut=lut, d_lut=dlut,
                                d_exp_wide=dew, **CONFIG6)
    heavy_rows = int(((hl.flags.cpu() & 1) != 0).sum())
    _, enc_h, _ = ST.churn_lookup_finish(hl)
    cval_h = torch.cat([torch.from_numpy(heavy_live).to(dev),
                        torch.arange(DCAP, device=dev) < nd_after])
    _, ih_ref = xor_topk(qh, cat, k=k, tile=ST.scan_tile(N + DCAP, 64),
                         valid=cval_h)
    require(heavy_rows == qh.shape[0] and torch.equal(enc_h, ih_ref),
            "tomb-heavy windows fall back and come out exact")
    # pack 16 == pack 1
    _, enc_p16, _ = ST.churn_lookup_topk(
        sorted_ids, expanded, nv, tomb_base, ds, de, nd_after, queries,
        lut=lut, d_lut=dlut, d_exp_wide=dew, merge_pack=16, **CONFIG6)
    d3_16, e3_16, _ = ST.churn_lookup_topk(sorted_ids, exp5, nv, tomb_base,
                                           ds5, de5, nd_after, qs, lut=lut,
                                           d_lut=dlut5, k=k, select="fast3",
                                           merge_pack=16)
    require(torch.equal(enc_p16, enc_round) and torch.equal(e3_16, enc3)
            and torch.equal(d3_16, dist3), "merge pack 16 == pack 1")
    del exp5, de5
    table = churn_table_check(args, dev, sync)

    denom_ms = round_ms + host_prep_ms + compact_ms / rounds_per_compaction
    sustained = Q / denom_ms * 1e3
    static = Q / static_ms * 1e3
    emit({"phase": "churn", **card, "config": "BASELINE.json config 6",
          "n": N, "q": Q, "delta_cap": DCAP, "e": E, "warm_rounds": warm,
          "n_delta": nd_after, "tombstones": int(nv - host.live.sum()),
          "lut_bits": lut_bits, **CONFIG6,
          "round_ms": round_ms, "static_fast2_ms": static_ms,
          "kernel_select_5plane_ms": kernel_ms, "compact_ms": compact_ms,
          "host_prep_ms": host_prep_ms,
          "rounds_per_compaction": rounds_per_compaction,
          "host_syncs_per_round": syncs,
          "sustained_lookups_per_s": sustained,
          "mutations_per_s": 2 * E / denom_ms * 1e3,
          "static_lookups_per_s": static,
          "churny_over_static": sustained / static,
          "rows_repaired_in_round": repaired,
          "checks": {"fast3_eq_xor_topk_rows": nq, "fast2_eq_fast3": True,
                     "tomb_heavy_rows": heavy_rows,
                     "pack16_eq_pack1_rows": Q + nq},
          "table": table,
          "profile": {"wall_ms": wall_ms,
                      "device_ms": dev_ms if cuda else "not measured",
                      "device_busy_share": (dev_ms / wall_ms if cuda
                                            else "not measured"),
                      "time": "device" if cuda else "host (rehearsal)",
                      "note": "wall_ms includes the profiler's overhead",
                      "stages": stages,
                      "top_ops": [{"name": e.key, "calls": e.count,
                                   "self_ms": (e.self_device_time_total
                                               if cuda else
                                               e.self_cpu_time_total) / 1e3}
                                  for e in ops]}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="table ids")
    ap.add_argument("--q", type=int, default=131_072, help="targets")
    ap.add_argument("--search-n", type=int, default=10_000_000,
                    help="ids of the search and maintenance phases")
    ap.add_argument("--search-q", type=int, default=65_536,
                    help="lookups per search wave")
    ap.add_argument("--search-waves", type=int, default=16)
    ap.add_argument("--churn-n", type=int, default=10_000_000,
                    help="base ids of the churn phase")
    ap.add_argument("--churn-q", type=int, default=131_072,
                    help="lookups per churn round")
    ap.add_argument("--churn-dcap", type=int, default=65_536,
                    help="delta slab capacity of the churn rounds")
    ap.add_argument("--churn-e", type=int, default=512,
                    help="evictions and inserts per churn round")
    ap.add_argument("--churn-table-n", type=int, default=1_000_000,
                    help="ids of the churn phase's NodeTable check")
    ap.add_argument("--phases", default="all",
                    help="'all', or 'churn' to run the device, build, "
                         "parity and main phases and then only churn")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the host with the plain versions "
                         "(never prints the ok line)")
    args = ap.parse_args(argv)

    import torch
    # -- 1. device ---------------------------------------------------------
    if not args.cpu and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.cpu:
        dev, kind, smi = torch.device("cpu"), "cpu (rehearsal)", "not measured"
    else:
        dev, kind, smi = (torch.device("cuda"), torch.cuda.get_device_name(0),
                          nvidia_smi_line())
    print(smi, flush=True)
    card = {"card": kind, "nvidia_smi": smi}
    emit({"phase": "device", **card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "count": torch.cuda.device_count() if not args.cpu else 0})

    from opendht_tpu_torch import NodeTable, InfoHash
    from opendht_tpu_torch.ops import _build
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.ops import sorted_table as ST
    from opendht_tpu_torch.ops.lex_select import (lex_topk_select,
                                                   lex_topk_select_plain)
    from opendht_tpu_torch.ops.window_select import (window_select,
                                                      window_select_plain)
    from opendht_tpu_torch.ops.xor_topk import xor_topk

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # -- 2. build ----------------------------------------------------------
    if not args.cpu:
        t0 = time.perf_counter()
        libs = _build.build_all()
        build_s = time.perf_counter() - t0
        ptxas = [line.strip() for p in libs
                 for line in p.with_suffix(".log").read_text().splitlines()
                 if "registers" in line or "Compiling entry" in line]
        emit({"phase": "build", "seconds": build_s,
              "libraries": [p.name for p in libs], "ptxas": ptxas})

    # -- 3. parity ---------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    err = {"window_select": 0, "lex_topk_select": 0}
    checked = {"window_select": [], "lex_topk_select": []}
    rows_np, q8_np, b_np = edge_window_inputs(rng, 4096)
    wr, wq, wb = (IK.to_keys(rows_np, dev), IK.to_keys(q8_np, dev),
                  torch.from_numpy(b_np).to(dev))
    for k in (1, 8, 14, 16, 21):
        got = window_select(wr, wq, wb, k=k)
        sync()
        want = window_select_plain(wr, wq, wb, k=k)
        e = max_abs_err(got, want)
        err["window_select"] = max(err["window_select"], e)
        checked["window_select"].append({"Q": 4096, "k": k, "err": e})
    ri_np, rq_np, rb_np = row_index_inputs(rng, q8_np, b_np, 8192)
    ri, rq, rb = (torch.from_numpy(ri_np).to(dev), IK.to_keys(rq_np, dev),
                  torch.from_numpy(rb_np).to(dev))
    for k in (1, 8, 16, 21):
        got = window_select(wr, rq, rb, k=k, row_index=ri)
        sync()
        want = window_select_plain(wr, rq, rb, k=k, row_index=ri)
        e = max_abs_err(got, want)
        err["window_select"] = max(err["window_select"], e)
        checked["window_select"].append({"Q": 8192, "NB": 4096, "k": k,
                                         "row_index": True, "err": e})
    for W in (32, 128, 256, 1024):
        dist_np, inv_np = edge_lex_inputs(rng, 1024, W)
        d, i = IK.to_keys(dist_np, dev), torch.from_numpy(inv_np).to(dev)
        for k in (8, 16):
            got = lex_topk_select(d, i, k=k)
            sync()
            e = max_abs_err(got, lex_topk_select_plain(d, i, k=k))
            err["lex_topk_select"] = max(err["lex_topk_select"], e)
            checked["lex_topk_select"].append({"Q": 1024, "W": W, "k": k,
                                               "err": e})

    # -- 4. main path ------------------------------------------------------
    ids = rng.integers(0, 2**32, size=(args.n, 5), dtype=np.uint32)
    targets = rng.integers(0, 2**32, size=(args.q, 5), dtype=np.uint32)
    self_id = InfoHash(rng.integers(0, 256, size=20, dtype=np.uint8).tobytes())
    t0 = time.perf_counter()
    table = NodeTable(self_id, device=None if not args.cpu else "cpu")
    table.bulk_load(ids, now=0.0)
    snap = table.snapshot(now=0.0)
    sync()
    load_s = time.perf_counter() - t0
    require(args.n > 4096 and args.q > 64, "the card path needs > 4096 rows "
            "and > 64 targets")

    window_select.launches = 0
    lex_topk_select.launches = 0
    t0 = time.perf_counter()
    r16, d16 = table.find_closest(targets, k=16, now=0.0)
    t_fc16 = time.perf_counter() - t0
    ws_after_fc = window_select.launches
    r8, d8 = table.find_closest(targets, k=8, now=0.0)
    qk = IK.to_keys(targets, dev)
    t0 = time.perf_counter()
    wd, wi, wc = ST.lookup_topk(snap.sorted_ids, snap.n_valid, qk, k=16,
                                window=128, expanded=None)
    sync()
    t_lk = time.perf_counter() - t0
    launches = {"window_select": window_select.launches,
                "lex_topk_select": lex_topk_select.launches}
    if not args.cpu:
        require(ws_after_fc >= 1, "find_closest launched window_select")
        require(launches["lex_topk_select"] >= 1,
                "lookup_topk(expanded=None) launched lex_topk_select")

    # exactness: the port's xor_topk on 256 rows, numpy on 32 rows
    valid_rows = torch.arange(snap.sorted_ids.shape[0], device=dev) \
        < snap.n_valid
    perm_np = snap.perm.cpu().numpy()
    for k, rows, dist in ((16, r16, d16), (8, r8, d8)):
        require(rows.shape == (args.q, k) and dist.shape == (args.q, k, 5),
                "find_closest shapes")
        require(((rows >= 0) & (rows < table.capacity)).all()
                and table._valid[rows].all(), "rows are live slab rows")
        ed, ei = xor_topk(qk[:256], snap.sorted_ids, k=k,
                          tile=ST.scan_tile(args.n, 256), valid=valid_rows)
        ei = ei.cpu().numpy()
        require(np.array_equal(perm_np[ei], rows[:256]),
                f"find_closest k={k} rows == xor_topk")
        require(np.array_equal(IK.from_keys(ed), dist[:256]),
                f"find_closest k={k} dist == xor_topk")
        for qi in range(32):
            dd = ids ^ targets[qi]
            cut = np.partition(dd[:, 0], k - 1)[k - 1]
            cand = np.nonzero(dd[:, 0] <= cut)[0]
            c = dd[cand]
            order = cand[np.lexsort((c[:, 4], c[:, 3], c[:, 2], c[:, 1],
                                     c[:, 0]))[:k]]
            require(np.array_equal(table._ids[rows[qi]], ids[order]),
                    f"find_closest k={k} query {qi} == numpy oracle")
    ed, ei = xor_topk(qk[:256], snap.sorted_ids, k=16,
                      tile=ST.scan_tile(args.n, 256), valid=valid_rows)
    require(torch.equal(ei, wi[:256]) and torch.equal(ed, wd[:256]),
            "lookup_topk(expanded=None) == xor_topk")
    require(bool(wc.all()), "lookup_topk certified every row after fallback")
    # uncertified rows before the fallback (outside the counted run)
    uncert = {}
    for name, k in (("expanded_k16", 16), ("expanded_k8", 8)):
        _, _, c = ST.expanded_topk(snap.sorted_ids, snap._expanded,
                                   snap.n_valid, qk, k=k, select="kernel")
        uncert[name] = int((~c).sum())
    _, _, c = ST.window_topk(snap.sorted_ids, snap.n_valid, qk, k=16,
                             window=128, select="kernel")
    uncert["window128_k16"] = int((~c).sum())
    emit({"phase": "main", **card, "n": args.n, "q": args.q,
          "load_and_snapshot_s": load_s, "find_closest_k16_first_s": t_fc16,
          "lookup_topk_window_first_s": t_lk, "launches": launches,
          "uncertified": uncert, "exact_rows_checked": {"xor_topk": 256,
                                                        "numpy": 32}})

    # main-path parity: the kernels on the main path's own inputs
    expanded = snap._expanded
    j, start = ST.expanded_window(snap.sorted_ids, expanded, snap.n_valid,
                                  qk)
    q8 = torch.nn.functional.pad(qk, (0, 3))
    bounds = torch.clamp(snap.n_valid - start, 0, 192)[:, None] \
        .expand(-1, 8).contiguous()
    for k in (16, 8):
        got = window_select(expanded, q8, bounds, k=k, row_index=j)
        sync()
        e = max_abs_err(got, window_select_plain(expanded, q8, bounds, k=k,
                                                 row_index=j))
        err["window_select"] = max(err["window_select"], e)
        checked["window_select"].append({"Q": args.q, "k": k, "err": e,
                                         "row_index": True,
                                         "main_path": True})
    rows_t = expanded[j]      # gathered rows: timing comparison only
    dist_w, inv_w, _, _ = ST.window_candidates(snap.sorted_ids, snap.n_valid,
                                               qk, window=128)
    for k in (16, 8):
        got = lex_topk_select(dist_w, inv_w, k=k)
        sync()
        e = max_abs_err(got, lex_topk_select_plain(dist_w, inv_w, k=k))
        err["lex_topk_select"] = max(err["lex_topk_select"], e)
        checked["lex_topk_select"].append({"Q": args.q, "W": 128, "k": k,
                                           "err": e, "main_path": True})
    emit({"phase": "parity", **card, "max_abs_err": err, "cases": checked,
          "tolerance": "bit-identical (integer outputs)"})
    require(err["window_select"] == 0 and err["lex_topk_select"] == 0,
            "kernels bit-identical to their plain versions")

    # -- 5. timing ---------------------------------------------------------
    cuda = dev.type == "cuda"
    Q = args.q
    timing = {}
    NB = expanded.shape[0]
    for k in (16, 8):
        timing[f"window_select_k{k}"] = {
            "ms": median_ms(lambda: window_select(expanded, q8, bounds, k=k,
                                                  row_index=j),
                            inner=5, cuda=cuda),
            "plain_ms": median_ms(
                lambda: window_select_plain(expanded, q8, bounds, k=k,
                                            row_index=j),
                reps=5, cuda=cuda),
            # the same kernel on rows gathered first (row_index=None)
            "gathered_rows_ms": median_ms(
                lambda: window_select(rows_t, q8, bounds, k=k),
                inner=5, cuda=cuda),
            "fast3_select_ms": median_ms(
                lambda: ST.expanded_select(expanded, j, qk, start,
                                           snap.n_valid, k=k,
                                           select="fast3"),
                reps=5, cuda=cuda),
            "kernel_select_ms": median_ms(
                lambda: ST.expanded_select(expanded, j, qk, start,
                                           snap.n_valid, k=k,
                                           select="kernel"),
                inner=5, cuda=cuda),
            # the table once, plus row_index, queries8, bounds and out
            "bytes": NB * 970 * 4 + Q * (1 + 8 + 8 + 128) * 4,
            # context, not the bound: every query's row read on its own
            "row_read_bytes": Q * 970 * 4,
            # XORs, the local-best scans (~10 ops per 5-limb compare) and
            # per round the winner's rescan plus ~2 warp-wide operations
            "ops": Q * (5 * 192 + 10 * 192 + k * (10 * 6 + 64))}
        timing[f"lex_topk_select_k{k}"] = {
            "ms": median_ms(lambda: lex_topk_select(dist_w, inv_w, k=k),
                            inner=5, cuda=cuda),
            "plain_ms": median_ms(
                lambda: lex_topk_select_plain(dist_w, inv_w, k=k),
                reps=5, cuda=cuda),
            "bytes": Q * 128 * (5 * 4 + 4) + Q * k * 4,
            "ops": Q * (10 * 128 + k * (10 * 4 + 64))}
        timing[f"find_closest_k{k}_ms"] = host_median_ms(
            lambda: table.find_closest(targets, k=k, now=0.0))
    # what reading rows in place removes from the main path
    timing["row_gather_ms"] = median_ms(lambda: expanded[j], inner=5,
                                        cuda=cuda)
    for name in ("window_select", "lex_topk_select"):
        timing[f"{name}_k16_over_k8"] = (timing[f"{name}_k16"]["ms"]
                                         / timing[f"{name}_k8"]["ms"])
    timing["lookup_topk_window128_k16_ms"] = host_median_ms(
        lambda: (ST.lookup_topk(snap.sorted_ids, snap.n_valid, qk, k=16,
                                window=128, expanded=None), sync()))
    for v in timing.values():
        if isinstance(v, dict):
            v["bound_ms"] = max(v["bytes"] / HBM_BYTES_PER_S,
                                v["ops"] / OPS_PER_S) * 1e3
            v["bound_by"] = ("bytes" if v["bytes"] / HBM_BYTES_PER_S
                             >= v["ops"] / OPS_PER_S else "operations")
    emit({"phase": "timing", **card, "q": Q, "n": args.n, "timing": timing})

    # where one find_closest call spends its time (device kernels by name)
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        s = time.perf_counter()
        table.find_closest(targets, k=16, now=0.0)
        wall_ms = (time.perf_counter() - s) * 1e3
    # device-side events only (kernels and copies): the aten ops that
    # launched them carry the same time again
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in ev)
    top = sorted(ev, key=lambda e: e.self_device_time_total, reverse=True)
    emit({"phase": "profile", **card, "call": "find_closest k=16",
          "wall_ms": wall_ms, "device_ms": dev_us / 1e3,
          "device_busy_share": dev_us / 1e3 / wall_ms,
          "note": "wall_ms includes the profiler's own overhead",
          "top_device": [{"name": e.key[:80], "calls": e.count,
                          "device_ms": e.self_device_time_total / 1e3}
                         for e in top[:12]]})

    # -- 7. memory ---------------------------------------------------------
    del rows_t
    gathered_bytes = Q * 970 * 4
    peak_extra = "not measured"
    if cuda:
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        table.find_closest(targets, k=16, now=0.0)
        sync()
        peak_extra = torch.cuda.max_memory_allocated() - base
    emit({"phase": "memory", **card, "call": "find_closest k=16", "q": Q,
          "peak_extra_bytes": peak_extra,
          "gathered_rows_bytes": gathered_bytes})
    if cuda:
        require(peak_extra < gathered_bytes,
                f"find_closest k=16 allocated {peak_extra} B at peak, not "
                f"below the {gathered_bytes} B of gathered rows")

    if args.phases == "all":
        search_phase(args, dev, card, sync)
        maintenance_phase(args, dev, card)
    churn_phase(args, dev, card, sync)

    kernels = []
    for name, src_line in (("window_select",
                            "opendht_tpu/ops/pallas_window_topk.py:99"),
                           ("lex_topk_select",
                            "opendht_tpu/ops/pallas_select.py:79")):
        t = timing[f"{name}_k16"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "opendht_tpu_torch/csrc/select_kernels.cu",
            "replaces": src_line, "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    if args.cpu or args.phases != "all":
        print("chip_smoke: CPU rehearsal or partial run finished; not a "
              "full chip run", file=sys.stderr)
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
