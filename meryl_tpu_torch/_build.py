"""Build and load the port's CUDA kernels and host code.

Each `csrc/*.cu` file is compiled by nvcc, each `csrc/*.cpp` file by
g++, into a shared library with a plain C interface, loaded with ctypes
(no PyTorch headers, so a build takes seconds).  Libraries go to
`meryl_tpu_torch/_build/`, named by a hash of the source and the flags,
so an edited source builds anew at its first use and an unchanged one
is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA "
                       "kernels of meryl_tpu_torch")


def _flags(src: str) -> list[str]:
    return NVCC_FLAGS if src.endswith(".cu") else CXX_FLAGS


def lib_path(src: str) -> str:
    """Path of the built library for the source file `src` at its
    current content."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(src)).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(src: str) -> str:
    """Compile the source file `src` (.cu by nvcc, .cpp by g++) unless
    its library is current; -> path.  Raises RuntimeError with the
    compiler's stderr when the build fails."""
    out = lib_path(src)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cc = _nvcc() if src.endswith(".cu") else "g++"
    r = subprocess.run([cc, *_flags(src), "-o", tmp, src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cc)} failed ({r.returncode}) "
                           f"building {src}:\n{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return out


def load(name: str, ext: str = ".cu") -> ctypes.CDLL:
    """The loaded library for csrc/<name><ext>, built at first use.  Two
    sources build at the same time; one source builds once."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(
                build(os.path.join(CSRC, name + ext)))
        return lib
