"""Build the package's native libraries at first use; load with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>.so``, a shared library
with a plain C interface compiled by nvcc for Hopper (``sm_90a``); each
``csrc/<name>.cpp`` (host code: the GSD writer's core) one compiled by the
host's C++ compiler (``g++``, or ``$CXX``).  A library is rebuilt when its
source, or for a ``.cu`` any ``.cuh`` in ``csrc/``, is newer than it.
Nothing here runs at import time: the CPU tests import every module of the
package on machines that have no ``nvcc``.

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
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-D_FILE_OFFSET_BITS=64"]

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


def cxx() -> str:
    """Path of the host C++ compiler: ``$CXX``, else ``g++`` on PATH."""
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found:
        return found
    raise RuntimeError("no host C++ compiler: put g++ on PATH or set CXX")


def source_path(name: str) -> Path:
    """``csrc/<name>.cu`` (a CUDA library) or else ``csrc/<name>.cpp``."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def library_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def log_path(name: str) -> Path:
    return BUILD / f"lib{name}.log"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    src = source_path(name)
    deps = [src, *CSRC.glob("*.cuh")] if src.suffix == ".cu" else [src]
    newest = max(p.stat().st_mtime for p in deps)
    return newest > lib.stat().st_mtime


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cpp`` (the host
    compiler) if its library is missing or stale.

    Returns the seconds spent compiling (0.0 when the library was current).
    The compiler's output (nvcc's with ptxas's register and shared-memory
    report) goes to ``_build/lib<name>.log``.  Raises RuntimeError, naming
    that log, if the compiler fails."""
    if not _stale(name):
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    src = source_path(name)
    if src.suffix == ".cu":
        compiler, flags = nvcc(), NVCC_FLAGS
    else:
        compiler, flags = cxx(), CXX_FLAGS
    # compile to a temporary name and rename: concurrent builds (test
    # workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log_path(name).write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{Path(compiler).name} failed on {src.name} "
                           f"(rc {proc.returncode}; log {log_path(name)}):"
                           f"\n{proc.stderr[-4000:]}")
    os.replace(tmp, library_path(name))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, built first
    if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
