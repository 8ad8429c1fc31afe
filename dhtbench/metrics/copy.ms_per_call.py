"""copy.ms_per_call: device ms of host-to-device and device-to-host
copies per call, from the profiler's trace of the traced calls."""


def read(run):
    t = run.trace
    if t is None:
        return None
    ms = [b - a for name, a, b in t.device
          if "HtoD" in name or "DtoH" in name]
    return 1e3 * sum(ms) / t.calls if ms else None
