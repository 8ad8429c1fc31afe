"""The traced stretch of a ``--trace 1`` run: a few more calls of the same
traffic under ``torch.profiler``, after the measured window, read back
from the profiler's Chrome trace.

The profiler's schedule runs a warm-up step of calls before the counted
step (without it the first kernels of a window are lost).  Device time is
the union of the kernels, copies and fills of the counted step; the
benchmark's own spans label each stretch the device was idle with the
host work that was open then.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile

import torch

WINDOW = "dhtbench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """Events of the counted step, times in seconds from its start."""

    def __init__(self, events: list, calls: int):
        self.calls = calls
        win = next(e for e in events if e.get("name") == WINDOW
                   and e.get("cat") == "user_annotation")
        t0, t1 = win["ts"], win["ts"] + win["dur"]
        self.window_s = win["dur"] / 1e6

        def clip(e):
            a, b = max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1)
            return (e["name"], (a - t0) / 1e6, (b - t0) / 1e6) if b > a \
                else None

        self.device, self.kernels, self.annotations = [], [], []
        for e in events:
            cat = e.get("cat")
            c = clip(e) if cat in DEVICE_CATS or (
                cat == "user_annotation" and e["name"] != WINDOW
                and not e["name"].startswith("ProfilerStep")) else None
            if c is None:
                continue
            if cat == "user_annotation":
                self.annotations.append(c)
            else:
                self.device.append(c)
                if cat == "kernel":
                    self.kernels.append(c)
        self.busy = _union([(a, b) for _, a, b in self.device])
        self.busy_s = sum(b - a for a, b in self.busy)

    def count(self, name: str) -> int:
        """Spans of the program or the benchmark named ``name``."""
        return sum(1 for n, _, _ in self.annotations if n == name)

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the idle
        stretches summed by the innermost host span open when each
        began."""
        ops = collections.Counter()
        for name, a, b in self.device:
            ops[name[:120]] += b - a
        idle = collections.Counter()
        edge = 0.0
        for a, b in self.busy + [(self.window_s, self.window_s)]:
            if a > edge:
                idle[self._open_at(edge)] += a - edge
            edge = max(edge, b)
        return {"device_ops": [[n, s] for n, s in ops.most_common(10)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(10)]}

    def _open_at(self, t: float) -> str:
        best = None
        for name, a, b in self.annotations:
            if a <= t < b and (best is None or a >= best[1]):
                best = (name, a)
        return best[0] if best else "(no span open)"


def _union(spans: list) -> list:
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def traced(driver, window_cls, *, warm: int, calls: int, device) -> Trace:
    """Run ``warm`` then ``calls`` calls of the driver under the profiler
    and read the counted step back."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    got: list = []

    def ready(prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                got.append(json.load(f)["traceEvents"])
        finally:
            os.remove(path)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with profile(activities=acts, on_trace_ready=ready,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        driver.run(window_cls(), calls=warm)
        sync()
        prof.step()
        with torch.profiler.record_function(WINDOW):
            driver.run(window_cls(), calls=calls)
            sync()
        prof.step()
    return Trace(got[0], calls)
