"""chain.kernels_per_call: device kernels per call, from the profiler's
trace of the traced calls."""


def read(run):
    t = run.trace
    return len(t.kernels) / t.calls if t is not None and t.kernels else None
