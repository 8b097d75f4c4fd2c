"""Row-batched sorts: the bitonic row-sort kernel and its depth floor
(counterpart of the two Pallas kernels of scripts/probe_r4_pallas_sort.py,
`bitonic_kernel` and `roll_pass_kernel`).

Three wrappers, each with a plain torch version beside it:

  * bitonic_rows(x): each (R, L) int32 row sorted ascending -- the
    probe's kernel at its own shape (rows of 2048, no payload);
  * sort_rows(key, values, ids, k): the set-op row sort.  Keys are the
    port's int64 words (ops/multiword.py); the order is exactly the
    STABLE order of the reference's lax.sort(..., is_stable=True), and
    both payloads follow their keys;
  * pass_floor(x): 66 stride-1 compare-exchange passes over int32 rows,
    so each (even, odd) pair ends sorted -- the network's depth floor.

The bitonic kernel (csrc/rowsort.cu, one CTA a row) runs the
all-ascending bitonic network: each thread holds 16 positions of the
row in registers, strides below 16 run inside the thread, strides up to
256 by warp shuffles, and a stage above 512 goes through shared memory
once (two barriers).  A row is not padded to a power of two: positions
past L act as +inf that never move, so they are neither loaded, stored
nor sorted.  For the set-op keys each entry carries its column, ties
compare on it (so the order is the stable one), and the kernel gathers
both payloads by it in the same launch.

The pass floor's kernel holds whole pairs in registers (no shared
memory, no barrier) and runs every pass it is given: for even L the
tensor is one flat array of pairs moved in 16-byte quads where the
alignment allows, for odd L a warp takes a row.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel from csrc/rowsort.cu or raises.  A row longer than
MAX_ROW never reaches the kernel: the set-op packer splits rows finer
(optree.BucketEvaluator._pack_rows).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import multiword as mw

MAX_ROW = 8192          # longest row one CTA sorts (= csrc/rowsort.cu)
FLOOR_PASSES = 66       # the probe's 66 = 11 * 12 / 2 passes at L = 2048

# launches of the CUDA kernels since the last reset (set to 0 to reset):
# LAUNCHES counts the bitonic kernel (both key types), PASS_FLOOR_LAUNCHES
# the depth-floor kernel
LAUNCHES = 0
PASS_FLOOR_LAUNCHES = 0


def _lib():
    lib = _build.load("rowsort")
    if lib.mt_bitonic_i32.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.mt_bitonic_i32.argtypes = [p, p, i64, i32, p]
        lib.mt_bitonic_keys.argtypes = [p, p, p, p, p, p, i64, i32, i32, p]
        lib.mt_pass_floor.argtypes = [p, p, i64, i32, i32, p]
        for fn in (lib.mt_bitonic_i32, lib.mt_bitonic_keys,
                   lib.mt_pass_floor):
            fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _lib()


# ------------------------------------------------------------- plain

def bitonic_rows_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=-1).values


def sort_rows_plain(key, values, ids, k: int):
    skey, (val, sid) = mw.sort(key, k, (values, ids), stable=True)
    return skey, val, sid


def pass_floor_plain(x: torch.Tensor) -> torch.Tensor:
    """Each (even, odd) pair of a row sorted; an odd row's last element
    stays where it is."""
    R, L = x.shape
    n2 = L - L % 2
    pairs = x[:, :n2].reshape(R, n2 // 2, 2)
    out = x.clone()
    out[:, :n2] = torch.stack([pairs.amin(-1), pairs.amax(-1)],
                              dim=-1).reshape(R, n2)
    return out


# ---------------------------------------------------------- wrappers

def _check(name, t, dtype, shape, dev):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no row sort for device {t.device}")
    return t.device.type


def _row_len(L: int) -> None:
    if L > MAX_ROW:
        raise ValueError(f"row length {L} exceeds MAX_ROW={MAX_ROW}")


def _launch(name: str, dev, *args) -> None:
    """Call the library's `name` with `args` and torch's current stream
    on `dev`; raise if the launch failed."""
    with torch.cuda.device(dev):
        rc = getattr(_lib(), name)(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def bitonic_rows(x: torch.Tensor) -> torch.Tensor:
    """(R, L) int32 -> each row sorted ascending (a new tensor)."""
    global LAUNCHES
    if _device_kind(x) == "cpu":
        return bitonic_rows_plain(x)
    if x.dim() != 2:
        raise ValueError(f"x must be (R, L), got {tuple(x.shape)}")
    R, L = x.shape
    _check("x", x, torch.int32, (R, L), x.device)
    _row_len(L)
    out = torch.empty_like(x)
    if x.numel():
        _launch("mt_bitonic_i32", x.device, x.data_ptr(), out.data_ptr(),
                R, L)
        LAUNCHES += 1
    return out


def sort_rows(key: torch.Tensor, values: torch.Tensor, ids: torch.Tensor,
              k: int):
    """Stable row sort with payloads: key (R, L) int64, or (R, L, 2) for
    k > 32; values (R, L) int64; ids (R, L) int32.  -> (sorted key,
    values, ids), each row sorted independently, ties in input order."""
    global LAUNCHES
    if _device_kind(key) == "cpu":
        return sort_rows_plain(key, values, ids, k)
    nw = mw.num_words(k)
    if values.dim() != 2:
        raise ValueError(f"values must be (R, L), got "
                         f"{tuple(values.shape)}")
    R, L = values.shape
    dev = key.device
    _check("key", key, torch.int64, (R, L) if nw == 1 else (R, L, 2), dev)
    _check("values", values, torch.int64, (R, L), dev)
    _check("ids", ids, torch.int32, (R, L), dev)
    _row_len(L)
    okey, oval, oids = (torch.empty_like(key), torch.empty_like(values),
                        torch.empty_like(ids))
    if values.numel():
        _launch("mt_bitonic_keys", dev, key.data_ptr(), values.data_ptr(),
                ids.data_ptr(), okey.data_ptr(), oval.data_ptr(),
                oids.data_ptr(), R, L, nw)
        LAUNCHES += 1
    return okey, oval, oids


def pass_floor(x: torch.Tensor) -> torch.Tensor:
    """(R, L) int32 -> FLOOR_PASSES stride-1 compare-exchange passes
    applied to each row (the result equals one pass: each (even, odd)
    pair sorted)."""
    global PASS_FLOOR_LAUNCHES
    if _device_kind(x) == "cpu":
        return pass_floor_plain(x)
    if x.dim() != 2:
        raise ValueError(f"x must be (R, L), got {tuple(x.shape)}")
    R, L = x.shape
    _check("x", x, torch.int32, (R, L), x.device)
    _row_len(L)
    out = torch.empty_like(x)
    if x.numel():
        _launch("mt_pass_floor", x.device, x.data_ptr(), out.data_ptr(),
                R, L, FLOOR_PASSES)
        PASS_FLOOR_LAUNCHES += 1
    return out
