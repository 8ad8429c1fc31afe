"""The roofline arithmetic, frozen from ``opendht_tpu_torch/profiling.py``
(``PLATFORM_PEAKS["h100"]`` and ``KernelLedger.roofline``): the least
time the card could take for a call is the larger of its bytes over the
memory rate and its operations over the 32-bit rate (the port's kernels
do 32-bit integer work outside the tensor cores), and a kernel's share
of its roofline is that least time over the kernel's own time."""

# NVIDIA H100 SXM data sheet at 700 W
H100 = {"hbm_bytes_per_s": 3.35e12, "ops32_per_s": 67e12,
        "power_limit_w": 700.0}


def share_pct(nbytes: float, ops: float, seconds: float,
              peaks: dict = H100) -> float:
    """100 x (least time) / ``seconds``."""
    least = max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["ops32_per_s"])
    return 100.0 * least / seconds
