"""window_select_roofline: the ``window_select`` kernel's share of its
roofline on the H100's published peaks (``_roofline.py``), at the cell's
shapes, over the kernel's own time in the profiler's trace (the mean of
its launches).

The byte and operation counts are frozen from ``chip_smoke.py``'s timing
of the kernel: each expanded-table row the queries read (970 int32
words) once, and per query its row index, its 8-word key, its 8-word
bound and its 128-word answer; per query 5 x 192 XORs, 10 x 192 compares
and k rounds of (10 x 6 + 64) operations.  The queries of a batch land
on uniform rows of the ceil((n - 192) / 64) + 1 window rows, so the rows
read are the expected number of distinct rows among ``batch`` uniform
draws."""

import math

from dhtbench.metrics._roofline import share_pct

KERNEL = "window_select_kernel"
EROW_WORDS = 970
WIN = 192


def counts(n: int, q: int, k: int):
    """(bytes, operations) of one launch over ``n`` live rows for ``q``
    queries at ``k``."""
    rows = math.ceil((n - WIN) / 64) + 1
    read = rows * -math.expm1(q * math.log1p(-1.0 / rows))
    nbytes = read * EROW_WORDS * 4 + q * (1 + 8 + 8 + 128) * 4
    ops = q * (5 * WIN + 10 * WIN + k * (10 * 6 + 64))
    return nbytes, ops


def read(run):
    t = run.trace
    if t is None:
        return None
    times = [b - a for name, a, b in t.kernels if KERNEL in name]
    if not times:
        return None
    p = run.params
    nbytes, ops = counts(p["nodes"], p["batch"], p["k"])
    return share_pct(nbytes, ops, sum(times) / len(times))
