"""Device resolution for the port's entry points.

Every entry point takes ``device=None``; None means the CUDA card.  When
no card is present the call raises instead of quietly running on the
CPU — a CPU run of this package is always one the caller asked for
(``device="cpu"``, as the parity tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; anything else → ``torch.device(device)``.
    Raises RuntimeError when the resolved device is CUDA and no card is
    available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "opendht_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain torch path on the host")
    return dev
