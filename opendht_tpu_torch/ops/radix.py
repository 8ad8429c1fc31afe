"""k-bucket partition: bucket of a peer = its clipped common prefix with
the own id (the reference's split-around-self routing table at steady
state, src/routing_table.cpp:176-262).

Only what ``NodeTable.insert`` / ``bulk_load`` need is here; the
maintenance sweeps of the JAX package's ``ops/radix.py`` are still to
port.
"""

from __future__ import annotations

import torch

from .ids import ID_BITS, common_bits

MAX_BUCKET = ID_BITS - 1  # deepest distinct bucket (bit 159)


def bucket_of(self_id: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Bucket index of each id relative to ``self_id``: min(commonBits, 159).

    self_id: key tensor [5]; ids: key tensor [..., 5] → int32 [...].
    The own id (cb=160) lands in bucket 159 with its closest peers.
    """
    cb = common_bits(self_id.expand_as(ids), ids)
    return torch.clamp(cb, max=MAX_BUCKET)
