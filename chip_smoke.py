#!/usr/bin/env python3
"""Drive the torch port (opendht_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                 # the full run on the card
    python3 chip_smoke.py --cpu --n 20000 --q 512   # rehearsal, no card

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

Then the kernels line ({"kernels": [...]}) and, last, the ok line.  Any
failure raises (nonzero exit, no ok line).  Without a card it exits
nonzero before any result; ``--cpu`` rehearses every phase on the host
with the plain versions and also ends without the ok line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="table ids")
    ap.add_argument("--q", type=int, default=131_072, help="targets")
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
    if args.cpu:
        print("chip_smoke: CPU rehearsal finished; not a chip run",
              file=sys.stderr)
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
