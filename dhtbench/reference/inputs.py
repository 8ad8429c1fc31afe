"""Every input of a run, made from ``--seed``.

The program and the reference are handed the same arrays: the ids a
configuration holds, the targets of each call, the mutations of each
churn round.  Ids are uniform 160-bit values (OpenDHT ids are SHA-1
hashes) held as five big-endian uint32 limbs, the layout and the draw
of ``chip_smoke.py``'s inputs (``rng.integers(0, 2**32, (n, 5),
uint32)``), whose arithmetic this copies.

Each kind of input has a numpy stream of its own, keyed by the seed, a
tag and the call index where there is one, so that a call's inputs do
not depend on how many calls came before it or on other kinds of input.
"""

from __future__ import annotations

import numpy as np
import torch

M64 = (1 << 64) - 1

# stream tags, one per kind of input
TABLE, TARGETS, MUTATIONS, CAPTURE = 1, 2, 3, 4


def stream(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng([seed & M64, *tags])


def uniform_ids(rng: np.random.Generator, n: int) -> np.ndarray:
    """[n, 5] uniform ids as uint32 limbs."""
    return rng.integers(0, 2**32, size=(n, 5), dtype=np.uint32)


def network_draw(seed: int, n: int, device) -> torch.Tensor:
    """[n, 5] uniform ids drawn on ``device`` by one ``torch.Generator``
    call, as int32: the id limb is the draw plus 2^31 (so the draw is the
    port's key of the id, ``ops/ids.py``).  The same seed and device type
    give the same tensor."""
    g = torch.Generator(device=device)
    g.manual_seed(seed & M64)
    return torch.randint(-(1 << 31), 1 << 31, (n, 5), dtype=torch.int32,
                         generator=g, device=device)


def draw_to_u64(draw: torch.Tensor) -> torch.Tensor:
    """The unsigned limb values of :func:`network_draw`'s ids, as int64."""
    return draw.to(torch.int64) + (1 << 31)


def call_targets(seed: int, call: int, q: int):
    """The ``q`` lookup targets of call ``call`` (uint32 [q, 5]) and the
    reply-stream seed of that call (a uint32 value)."""
    rng = stream(seed, TARGETS, call)
    return uniform_ids(rng, q), int(rng.integers(0, 2**32))


def captured(seed: int, call: int, every: int) -> bool:
    """Whether the answers of call ``call`` are kept for the check: about
    one call in ``every``, drawn from the seed."""
    return bool(stream(seed, CAPTURE, call).integers(0, every) == 0)
