"""Native (C++) runtime components, consumed via ctypes.

The reference is a C++ library end to end; this package provides the
node's native host-side pieces (the device compute path is the port's
torch and CUDA code):

- :func:`xor_cmp` / :func:`common_bits` / :func:`sorted_closest` /
  :func:`scan_closest` — the scalar XOR-metric kernels and the
  sorted-map outward walk (reference include/opendht/infohash.h:149-210,
  src/node_cache.cpp:41-74) for per-packet host ops and honest CPU
  baselines.
- :class:`UdpEngine` — native datagram ingress/egress with a C++
  receiver thread, ring buffer, martian filter, and global/per-IP rate
  limiting (reference src/dhtrunner.cpp:511-608,
  network_engine.h:424,519-523).

A copy of the JAX package's ``native`` package: the two C++ sources are
its own, unchanged; only the build (:mod:`.build`) differs in where and
how it writes the library.  The shared library is compiled on first use
with g++ into ``build/opendht_tpu_torch/``; :func:`available` reports
whether it loaded.  Callers must degrade gracefully when it didn't
(pure-Python paths exist everywhere this package is used).
"""

from .build import available, get_lib
from .wrappers import (UdpEngine, common_bits, scan_closest,
                       sorted_closest, sort_ids, xor_cmp)

__all__ = ["available", "get_lib", "xor_cmp", "common_bits", "sort_ids",
           "sorted_closest", "scan_closest", "UdpEngine"]
