"""Build the package's CUDA kernels with nvcc at first use; load with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>.so``, a shared library
with a plain C interface compiled for Hopper (``sm_90a``).  A library is
rebuilt when any source in ``csrc/`` is newer than it.  Nothing here runs at
import time: the CPU tests import every module of the package on machines
that have no ``nvcc``.

``torch.utils.cpp_extension.load`` is not used: a source that includes
PyTorch's headers takes minutes to compile, a plain C interface seconds.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


def library_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def log_path(name: str) -> Path:
    return BUILD / f"lib{name}.log"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return newest > lib.stat().st_mtime


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` if its library is missing or stale.

    Returns the seconds spent compiling (0.0 when the library was current).
    nvcc's output, with ptxas's register and shared-memory report, goes to
    ``_build/lib<name>.log``.  Raises RuntimeError if nvcc fails."""
    if not _stale(name):
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    src = CSRC / f"{name}.cu"
    # compile to a temporary name and rename: concurrent builds (test
    # workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log_path(name).write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name} "
                           f"(rc {proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, library_path(name))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
