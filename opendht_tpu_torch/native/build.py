"""Compile + load the native library (g++ → shared object → ctypes).

The build is lazy and cached: sources are hashed, and the .so lands in
``build/opendht_tpu_torch/`` beside the package (the directory the CUDA
kernels build into), so a rebuild only happens when the sources change.
No toolchain / failed build ⇒ ``get_lib()`` returns None and callers use
their Python fallbacks.

A copy of the JAX package's ``native/build.py`` except for where it
builds: every build writes to a temporary name unique to its process in
the output directory and then ``os.replace``s it onto the final name,
so any number of processes may build into one directory at once and
each loads a whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

from ..ops._build import BUILD_DIR

log = logging.getLogger("opendht_tpu_torch.native")

_SRC_DIR = Path(__file__).resolve().parent
_SOURCES = ("xor_engine.cpp", "udp_engine.cpp")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_tried = False


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of the current sources lives in ``build_dir``."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in _SOURCES:
        h.update((_SRC_DIR / name).read_bytes())
    return Path(build_dir) / f"libdht_native-{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Optional[Path]:
    """Build the library into ``build_dir`` unless it is there; returns
    its path, or None when g++ is missing or fails."""
    out = library_path(build_dir)
    if out.is_file():
        return out
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=out.parent)
        os.close(fd)
    except OSError as e:
        log.warning("native build failed: %s", e)
        return None
    cmd = ["g++", *GXX_FLAGS, "-o", tmp] + [str(_SRC_DIR / s)
                                            for s in _SOURCES]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (subprocess.SubprocessError, OSError) as e:
        detail = getattr(e, "stderr", b"")
        log.warning("native build failed: %s %s", e,
                    detail.decode(errors="replace") if detail else "")
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def _declare(lib: ctypes.CDLL) -> None:
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.dht_xor_cmp.restype = ctypes.c_int
    lib.dht_xor_cmp.argtypes = [u8p, u8p, u8p]
    lib.dht_common_bits.restype = ctypes.c_int
    lib.dht_common_bits.argtypes = [u8p, u8p]
    lib.dht_cmp.restype = ctypes.c_int
    lib.dht_cmp.argtypes = [u8p, u8p]
    lib.dht_sort_ids.restype = None
    lib.dht_sort_ids.argtypes = [u8p, i32p, ctypes.c_int64]
    lib.dht_lower_bound.restype = ctypes.c_int64
    lib.dht_lower_bound.argtypes = [u8p, ctypes.c_int64, u8p]
    lib.dht_sorted_closest.restype = None
    lib.dht_sorted_closest.argtypes = [u8p, ctypes.c_int64, u8p,
                                       ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_int32, i32p]
    lib.dht_scan_closest.restype = None
    lib.dht_scan_closest.argtypes = [u8p, ctypes.c_int64, u8p,
                                     ctypes.c_int64, ctypes.c_int32, i32p]
    lib.dht_udp_create.restype = ctypes.c_void_p
    lib.dht_udp_create.argtypes = [ctypes.c_uint16, ctypes.c_uint32,
                                   ctypes.c_uint32, ctypes.c_uint32,
                                   ctypes.c_int32, ctypes.c_int32]
    lib.dht_udp_port.restype = ctypes.c_uint16
    lib.dht_udp_port.argtypes = [ctypes.c_void_p]
    lib.dht_udp_has_v6.restype = ctypes.c_int32
    lib.dht_udp_has_v6.argtypes = [ctypes.c_void_p]
    lib.dht_udp_destroy.restype = None
    lib.dht_udp_destroy.argtypes = [ctypes.c_void_p]
    lib.dht_udp_send.restype = ctypes.c_int
    lib.dht_udp_send.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32,
                                 u8p, ctypes.c_int32, ctypes.c_uint16]
    lib.dht_udp_poll.restype = ctypes.c_int32
    lib.dht_udp_poll.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint64,
                                 ctypes.c_int32, u64p]
    lib.dht_udp_pending.restype = ctypes.c_int32
    lib.dht_udp_pending.argtypes = [ctypes.c_void_p]
    lib.dht_udp_wait.restype = ctypes.c_int32
    lib.dht_udp_wait.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.dht_udp_stats.restype = None
    lib.dht_udp_stats.argtypes = [ctypes.c_void_p, u64p]


def load(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    return lib


def get_lib() -> "ctypes.CDLL | None":
    """The loaded native library, building it on first call; None when
    unavailable (callers fall back to Python)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        try:
            _lib = load(path)
        except OSError as e:
            log.warning("native load failed: %s", e)
        return _lib


def available() -> bool:
    return get_lib() is not None
