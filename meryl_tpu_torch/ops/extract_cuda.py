"""Hopper k-mer extraction kernel (counterpart of
meryl_tpu/ops/extract_pallas.py).

`extract_kmers_packed` takes the packed 2-bit wire that the counting
path ships (kmer.pack_codes_2bit).  On a CUDA tensor it launches the
kernel in csrc/extract.cu, or raises; on a CPU tensor it runs the plain
version in ops/extract.py.  The kernel replaces the Pallas `_kernel`
(extract_pallas.py:44-107, launched at :136) and fuses the wire unpack
of meryl_tpu/ops/extract.py:216-239; csrc/extract.cu says what bounds
it on the card.  A call is one kernel launch and allocates only its
outputs.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import _build
from . import extract as ext
from . import multiword as mw

# launches of the CUDA kernel since the last reset (set to 0 to reset);
# the members of a sharded count launch from threads of their own
LAUNCHES = 0
_launches_lock = threading.Lock()

_MODE_ID = {"canonical": 0, "forward": 1, "reverse": 2, "both": 3}


def entry_point(lib: ctypes.CDLL):
    """The library's mt_extract_packed, its argtypes set."""
    fn = lib.mt_extract_packed
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, i64, i64, i64, ctypes.c_int, ctypes.c_int,
                       p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _lib():
    lib = _build.load("extract")
    entry_point(lib)
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _lib()


def extract_kmers_packed(packed2: torch.Tensor, exc: torch.Tensor,
                         n_real: int, k: int, mode: str = "canonical"):
    """Packed wire -> (key, valid), or (fkey, rkey, valid) in mode
    "both", with the contract of ops/extract.extract_kmers_packed.

    packed2: (L/16,) int32 holding the uint32 code words; exc: (E,)
    int32 exception positions, sorted ascending and INT32_MAX padded as
    kmer.pack_codes_2bit makes them (the kernel searches the list);
    n_real: windows starting at or past n_real - k + 1 are invalid."""
    if packed2.device.type == "cpu":
        return ext.extract_kmers_packed(packed2, exc, n_real, k, mode)
    if packed2.device.type != "cuda":
        raise ValueError(f"no extraction for device {packed2.device}")
    return _launch(packed2, exc, int(n_real), k, mode)


def _launch(packed2, exc, n_real, k, mode):
    global LAUNCHES
    if mode not in _MODE_ID:
        raise ValueError(f"mode must be one of {tuple(_MODE_ID)}, "
                         f"got {mode!r}")
    if not 1 <= k <= 64:
        raise ValueError(f"k must be in [1, 64], got {k}")
    for name, t in (("packed2", packed2), ("exc", exc)):
        if t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-d int32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    dev = packed2.device
    if exc.device != dev:
        raise ValueError(f"exc is on {exc.device}, packed2 on {dev}")
    L = packed2.shape[0] * 16
    shape = (L,) if mw.num_words(k) == 1 else (L, 2)
    out0 = torch.empty(shape, dtype=torch.int64, device=dev)
    out1 = torch.empty(shape, dtype=torch.int64, device=dev) \
        if mode == "both" else None
    valid = torch.empty(L, dtype=torch.bool, device=dev)
    fn = _lib().mt_extract_packed
    with torch.cuda.device(dev):
        rc = fn(packed2.data_ptr(), exc.data_ptr(), exc.numel(), L, n_real,
                k, _MODE_ID[mode], out0.data_ptr(),
                out1.data_ptr() if out1 is not None else None,
                valid.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"extract kernel launch failed: cudaError {rc}")
    with _launches_lock:
        LAUNCHES += 1
    if mode == "both":
        return out0, out1, valid
    return out0, valid
