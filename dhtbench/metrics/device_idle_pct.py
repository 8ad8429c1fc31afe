"""device_idle_pct: the share of the traced calls' window in which no
kernel, copy or fill ran on the card (the union of the device intervals
in the profiler's trace)."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
