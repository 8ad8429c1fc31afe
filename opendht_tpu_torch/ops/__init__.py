"""Tensor ops of the port: id math, the exact full-scan top-k, the
sorted-window lookup, and the two CUDA select kernels with their plain
torch versions."""
