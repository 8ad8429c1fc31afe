"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled at first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded
with ctypes — no PyTorch headers, so a build takes seconds.  Libraries
land in ``build/opendht_tpu_torch/`` beside the package, named by a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused.  The compiler's ``-Xptxas -v`` report (registers,
shared memory, spills) is kept next to each library as ``<name>.log``.

Nothing here runs at import: the CPU test tier imports every module and
has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "opendht_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "opendht_tpu_torch are built on the machine "
                           "with the card")
    return found


def library_path(stem: str) -> Path:
    src = CSRC / f"{stem}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def _start_build(stem: str):
    """Start ``nvcc`` for one source unless its library is built; returns
    (process, temp output, final path) or None."""
    out = library_path(stem)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{stem}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all() -> list[Path]:
    """Compile every ``csrc/*.cu`` that is not built yet, all ``nvcc``
    processes started together; returns the library paths.  Raises with
    the compiler's output if one fails."""
    stems = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = [(s, _start_build(s)) for s in stems]
    errors = []
    for stem, job in jobs:
        if job is None:
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc {stem}.cu failed ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(s) for s in stems]


@functools.lru_cache(maxsize=None)
def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed."""
    if not library_path(stem).is_file():
        build_all()
    return ctypes.CDLL(str(library_path(stem)))


@functools.lru_cache(maxsize=None)
def function(stem: str, symbol: str, n_pointers: int, n_ints: int):
    """C entry point ``symbol(ptr × n_pointers, int × n_ints, stream)``
    returning an int CUDA error code.  Pointers and the stream are
    declared ``c_void_p`` so ctypes passes them at full 64-bit width."""
    fn = getattr(library(stem), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch returned a nonzero CUDA error code."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
