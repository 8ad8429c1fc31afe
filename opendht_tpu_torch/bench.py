"""Headline benchmark of the port — batched findClosestNodes on one card.

The twin of the JAX package's ``bench.py``.  BASELINE.json config 2: Q
InfoHash queries x N node ids -> exact top-16 XOR-closest, through the
two-stage certified lookup over 2-plane expansions
(``ops/sorted_table.py`` ``cascade_topk``: fast2 over the stride-32
expansion, up to 256 uncertified rows repaired against the stride-64
one), at N = 1,000,000 and Q = 131,072 on the card.  The baseline is the
reference's scalar algorithm — walk the sorted table outward from
lower_bound, XOR-closer side first (``NodeCache::getCachedNodes``,
src/node_cache.cpp:41-74) — timed on the host over the same table.

Timing: the slope of two device-serialized chains, as the JAX bench.  A
chain enqueues R calls on the card's stream, each on the queries XORed
with its rep index (so no rep repeats another), and accumulates each
call's result into one device scalar read at the end; CUDA events
around the chain give its time, and the per-call time is
(t[R2] - t[R1]) / (R2 - R1), which cancels the constant costs (the
first launch, the final read).  Host gaps inside a call (a call that
syncs) stay in the slope: it is the stream's time per call.

    python -m opendht_tpu_torch.bench               # the headline line
    python -m opendht_tpu_torch.bench --profile     # per-stage breakdown

Both print JSON lines; the headline is one line, as the original's.  The
device is the card unless ``--device cpu`` (a rehearsal at 100,000 ids
and 8,192 queries whose times are host times, labelled ``cpu``).  With
``$OPENDHT_TPU_SMOKE_RECORD_DIR`` set, the headline is also written
there as ``bench.json`` (the gate's ``timing_soft`` record).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import time

import numpy as np
import torch

K = 16
# the JAX bench's headline geometry: its per-stage sweeps picked
# stride 32 with a 256-row repair against the stride-64 expansion
HEADLINE_STRIDE = 32
HEADLINE_CAP = 256


def scalar_closest(sorted_ints, q, k):
    """Reference algorithm: outward walk from the insertion point,
    XOR-closer side first (node_cache.cpp:41-74)."""
    n = len(sorted_ints)
    i = bisect.bisect_left(sorted_ints, q)
    lo, hi = i - 1, i
    out = []
    while len(out) < k and (lo >= 0 or hi < n):
        if lo < 0:
            out.append(sorted_ints[hi])
            hi += 1
        elif hi >= n:
            out.append(sorted_ints[lo])
            lo -= 1
        elif (sorted_ints[lo] ^ q) < (sorted_ints[hi] ^ q):
            out.append(sorted_ints[lo])
            lo -= 1
        else:
            out.append(sorted_ints[hi])
            hi += 1
    return out


def _chain_ms(body, queries, reps: int, dev) -> float:
    """ms of one chain of ``reps`` calls of ``body(q) -> scalar tensor``,
    each on the queries XORed with the rep index, results summed on the
    device and read once.  CUDA events on the card, the host clock on
    the CPU."""
    cuda = dev.type == "cuda"
    acc = torch.zeros((), dtype=torch.float64, device=dev)
    if cuda:
        torch.cuda.synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    for i in range(reps):
        acc = acc + body(queries ^ i)
    if cuda:
        b.record()
    float(acc)
    if cuda:
        return a.elapsed_time(b)
    return (time.perf_counter() - t0) * 1e3


def chain_slope(body, queries, dev, *, r1: int = 2, r2: int = 8,
                samples: int = 1):
    """Per-call ms of ``body`` by the chain slope; with ``samples`` > 1,
    (median, lo, hi) over that many slope samples."""
    _chain_ms(body, queries, 2, dev)                         # warm-up
    vals = []
    for _ in range(max(1, samples)):
        s = (_chain_ms(body, queries, r2, dev)
             - _chain_ms(body, queries, r1, dev)) / (r2 - r1)
        if s > 0:
            vals.append(s)
    if not vals:
        raise RuntimeError(f"chain_slope: no positive slope at reps "
                           f"{r1}/{r2}; raise them")
    vals.sort()
    return statistics.median(vals), vals[0], vals[-1]


def _tables(dev, N, Q, seed: int = 0):
    from .ops.ids import to_keys
    from .ops.sorted_table import (build_prefix_lut, default_lut_bits,
                                   expand_table, sort_table)
    rng = np.random.default_rng(seed)
    table = to_keys(rng.integers(0, 2 ** 32, size=(N, 5), dtype=np.uint32),
                    dev)
    queries = to_keys(rng.integers(0, 2 ** 32, size=(Q, 5),
                                   dtype=np.uint32), dev)
    sorted_ids, _perm, n_valid = sort_table(table)
    lut = build_prefix_lut(sorted_ids, n_valid, bits=default_lut_bits(N))
    return sorted_ids, n_valid, lut, queries


def _card(dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "card": "cpu (rehearsal)",
                "power_limit": "not measured"}
    from .profiling import _power_limit
    return {"platform": "gpu", "card": torch.cuda.get_device_name(dev),
            "power_limit": _power_limit()}


def measure(device=None, *, N: int = 0, Q: int = 0,
            samples: int = 5) -> dict:
    """The headline: lookups/s of the certified cascade at config 2's
    shape, its exactness against the full scan, and the scalar
    baseline's rate on the host."""
    from ._device import resolve_device
    from .ops.ids import from_keys
    from .ops.sorted_table import cascade_topk, expand_table, expanded_topk
    from .ops.xor_topk import xor_topk
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    N = N or (1_000_000 if cuda else 100_000)
    Q = Q or (131_072 if cuda else 8_192)
    sorted_ids, n_valid, lut, queries = _tables(dev, N, Q)
    # 2-plane expansions: fast2 reads limb planes 0-1 only
    exp_fast = expand_table(sorted_ids, stride=HEADLINE_STRIDE, limbs=2)
    exp_wide = expand_table(sorted_ids, limbs=2)

    def lookup(q):
        _d, idx, c = cascade_topk(sorted_ids, exp_fast, exp_wide, n_valid,
                                  q, lut, k=K, select="fast2",
                                  cap=HEADLINE_CAP, planes=2)
        return c.sum(dtype=torch.float64) + idx[:, 0].sum(
            dtype=torch.float64) * 1e-9

    if not cuda:
        samples = min(samples, 2)
    r1, r2 = (8, 64) if cuda else (2, 8)
    per_ms, lo_ms, hi_ms = chain_slope(lookup, queries, dev, r1=r1, r2=r2,
                                       samples=samples)
    rate = Q / (per_ms / 1e3)

    # certificate fraction: stage 1 alone, and after the cascade (the
    # timed path); a residual uncertified row would go to the exact
    # fallback — counted
    _, _, cert1 = expanded_topk(sorted_ids, exp_fast, n_valid, queries,
                                k=K, select="fast2", lut=lut, lut_steps=0,
                                planes=2)
    _, i2, cert = cascade_topk(sorted_ids, exp_fast, exp_wide, n_valid,
                               queries, lut, k=K, select="fast2",
                               cap=HEADLINE_CAP, planes=2)
    cert_np = cert.cpu().numpy()
    cert1_np = cert1.cpu().numpy()
    stage2_rows = int((~cert1_np).sum())

    # exactness against the full scan: the cascade's node order on every
    # certified row of 256, the fast3 path's distances too, and every
    # repaired row
    valid = torch.arange(N, device=dev) < n_valid
    exp_fast5 = expand_table(sorted_ids, stride=HEADLINE_STRIDE)
    d3, i3, _ = expanded_topk(sorted_ids, exp_fast5, n_valid, queries[:256],
                              k=K, lut=lut, lut_steps=0, select="fast3")
    del exp_fast5
    d_ref, i_ref = xor_topk(queries[:256], sorted_ids, k=K, valid=valid)
    c256 = cert_np[:256]
    i2_np = i2.cpu().numpy()
    exact = bool(np.array_equal(i2_np[:256][c256], i_ref.cpu().numpy()[c256])
                 and torch.equal(i3, i_ref) and torch.equal(d3, d_ref))
    if stage2_rows:
        bad = np.nonzero(~cert1_np)[0]
        _, i_bad = xor_topk(queries[torch.from_numpy(bad).to(dev)],
                            sorted_ids, k=K, valid=valid)
        exact = exact and bool(np.array_equal(
            i2_np[bad][cert_np[bad]], i_bad.cpu().numpy()[cert_np[bad]]))

    # the scalar baseline on the same sorted table, on the host
    def pack160(rows):
        return [(int(r[0]) << 128) | (int(r[1]) << 96) | (int(r[2]) << 64)
                | (int(r[3]) << 32) | int(r[4]) for r in rows]

    sorted_ints = pack160(from_keys(sorted_ids))
    q_ints = pack160(from_keys(queries[:64]))
    t0 = time.perf_counter()
    for q in q_ints:
        scalar_closest(sorted_ints, q, K)
    scalar_rate = len(q_ints) / (time.perf_counter() - t0)

    card = _card(dev)
    out = {
        "metric": f"batched findClosestNodes top-{K}, {Q} queries x {N} ids "
                  f"({card['card']}, {card['power_limit']}); two-stage "
                  f"cascade, chain slope (median of {samples}), "
                  f"{per_ms:.3f} ms/batch incl. the repair of "
                  f"{stage2_rows} rows, certified "
                  f"{float(cert_np.mean()):.5f}, exact={exact}",
        "value": rate,
        "unit": "lookups/s/card" if cuda else "lookups/s (cpu rehearsal)",
        "vs_baseline": rate / scalar_rate,
        "ms_per_call": per_ms,
        "ms_range": [lo_ms, hi_ms],
        "certified": float(cert_np.mean()),
        "stage2_rows": stage2_rows,
        "residual_uncertified": int((~cert_np).sum()),
        "exact": exact,
        "scalar_lookups_per_s": scalar_rate,
        "N": N, "Q": Q, "k": K, "stride": HEADLINE_STRIDE, "planes": 2,
        **card,
    }
    rec_dir = os.environ.get("OPENDHT_TPU_SMOKE_RECORD_DIR")
    if rec_dir:
        os.makedirs(rec_dir, exist_ok=True)
        with open(os.path.join(rec_dir, "bench.json"), "w") as f:
            json.dump(out, f, indent=1)
    return out


def profile(device=None, *, N: int = 0, Q: int = 0) -> list:
    """Per-stage chain-slope breakdown of the headline lookup: the
    positioning depth, the row gather, the full select variants and the
    cascade, one JSON line each."""
    from ._device import resolve_device
    from .ops.sorted_table import (_lower_bound, cascade_topk,
                                   default_lut_bits, expand_table,
                                   expanded_topk)
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    N = N or (1_000_000 if cuda else 100_000)
    Q = Q or (131_072 if cuda else 8_192)
    sorted_ids, n_valid, lut, queries = _tables(dev, N, Q)
    exp64 = expand_table(sorted_ids, limbs=2)
    exp32 = expand_table(sorted_ids, stride=32, limbs=2)
    exp32_5 = expand_table(sorted_ids, stride=32)
    card = _card(dev)
    out = []

    def stage(name, body, r1=2, r2=8):
        ms, _lo, _hi = chain_slope(body, queries, dev, r1=r1, r2=r2)
        rec = {"stage": name, "ms_per_batch": ms,
               "lookups_per_s": Q / (ms / 1e3), **card}
        print(json.dumps(rec), flush=True)
        out.append(rec)

    def pos(steps):
        return lambda q: _lower_bound(sorted_ids, q, n_valid, lut=lut,
                                      lut_steps=steps).sum(
            dtype=torch.float64)

    bits = default_lut_bits(N)
    stage("pos lut%d steps=6" % bits, pos(6))
    stage("pos lut%d steps=0" % bits, pos(0))

    def gather(stride, expanded):
        def body(q):
            p = _lower_bound(sorted_ids, q, n_valid, lut=lut, lut_steps=0)
            j = torch.clamp((p - stride) // stride, 0,
                            expanded.shape[0] - 1)
            return expanded[j.long()].sum(dtype=torch.float64)
        return body

    stage("pos0 + row gather s=64", gather(64, exp64))
    stage("pos0 + row gather s=32", gather(32, exp32))

    def full(expd, select, steps, planes):
        def body(q):
            _d, idx, c = expanded_topk(sorted_ids, expd, n_valid, q, k=K,
                                       select=select, lut=lut,
                                       lut_steps=steps, planes=planes)
            return c.sum(dtype=torch.float64) + idx[:, 0].sum(
                dtype=torch.float64) * 1e-9
        return body

    for name, expd, steps, select, planes in [
        ("full fast2 s=64 steps=0 planes=2", exp64, 0, "fast2", 2),
        ("full fast2 s=32 steps=6 planes=2", exp32, 6, "fast2", 2),
        ("full fast2 s=32 steps=0 planes=2", exp32, 0, "fast2", 2),
        ("full fast2 s=32 steps=0 planes=5", exp32_5, 0, "fast2", 5),
        ("full fast3 s=32 steps=0", exp32_5, 0, "fast3", 5),
    ]:
        stage(name, full(expd, select, steps, planes))
        _, _, c = expanded_topk(sorted_ids, expd, n_valid, queries, k=K,
                                select=select, lut=lut, lut_steps=steps,
                                planes=planes)
        rec = {"stage": "certified fraction", "value":
               float(c.float().mean())}
        print(json.dumps(rec), flush=True)
        out.append(rec)

    def casc(q):
        _d, idx, c = cascade_topk(sorted_ids, exp32, exp64, n_valid, q, lut,
                                  k=K, select="fast2", cap=HEADLINE_CAP,
                                  planes=2)
        return c.sum(dtype=torch.float64) + idx[:, 0].sum(
            dtype=torch.float64) * 1e-9

    r1, r2 = (8, 64) if cuda else (2, 8)
    stage("cascade s=32 cap=%d (headline)" % HEADLINE_CAP, casc, r1, r2)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", action="store_true",
                   help="per-stage breakdown instead of the headline")
    p.add_argument("-N", type=int, default=0)
    p.add_argument("-Q", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    if args.profile:
        profile(args.device, N=args.N, Q=args.Q)
    else:
        print(json.dumps(measure(args.device, N=args.N, Q=args.Q)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
