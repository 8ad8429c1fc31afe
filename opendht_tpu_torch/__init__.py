"""opendht_tpu_torch — the PyTorch/CUDA port of opendht_tpu.

This slice carries the batched closest-node resolve
(``NodeTable.bulk_load`` → ``find_closest``) on an NVIDIA Hopper card:
the sorted-window lookup in plain torch around two hand-written CUDA
select kernels (``ops/window_select.py``, ``ops/lex_select.py``).

The package imports torch and numpy only — never JAX, never
``opendht_tpu`` (host-only modules it needs are copied here).  Entry
points take ``device=None``, which means the CUDA card and raises when
there is none.
"""

from ._device import resolve_device
from .infohash import InfoHash
from .core.table import NodeTable, Snapshot, PendingLookup

__all__ = ["resolve_device", "InfoHash", "NodeTable", "Snapshot",
           "PendingLookup"]
