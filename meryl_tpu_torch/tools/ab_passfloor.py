"""Time versions of the pass-floor kernel against each other on the card.

    python -m meryl_tpu_torch.tools.ab_passfloor [SOURCE.cu ...] [--pairs N]

Each SOURCE is a file with the C entry point of
meryl_tpu_torch/csrc/rowsort.cu's pass floor (mt_pass_floor); with none,
the package's rowsort.cu is set against the kernel's first version (one
CTA a row, the row in shared memory, a __syncthreads after each pass),
whose source this file keeps as FIRST_VERSION.  Each is built with the
package's nvcc flags and checked against the plain PyTorch version
(rowsort.pass_floor_plain) on the probe's 2^13 rows of 2048 int32 and on
odd, short and misaligned shapes, at 66 passes and at 0.  Then each is
timed alone at the probe's shape and 66 passes: raw launches of the C
entry point over two input and two output sets (more bytes than the L2
holds), the sources in turns, A B .. then .. B A, `--pairs` times; last,
the passes sweep of each (`--sweep`, by default 1, 16, 33 and 66
passes) and its least-squares slope.  Prints the card's name and power
limit, then one JSON line per timing.  Needs CUDA; chip_smoke.py times
the package's kernel the same way.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .. import _build
from ..ops import rowsort

SEED = 20261016
ROWS, LEN = 1 << 13, 2048
SWEEP = (1, 16, 33, 66)

FIRST_VERSION = r"""
// The pass floor's first version: a CTA a row, the row in shared memory,
// a __syncthreads after each pass.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr int MAX_ROW = 8192;
constexpr int FLOOR_THREADS = 1024;

__global__ void __launch_bounds__(FLOOR_THREADS)
pass_floor_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                  int L, int passes) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s = reinterpret_cast<int32_t*>(smem);
  const int64_t base = (int64_t)blockIdx.x * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) s[i] = x[base + i];
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    for (int t = threadIdx.x; t < L / 2; t += blockDim.x) {
      const int32_t a = s[2 * t], b = s[2 * t + 1];
      s[2 * t] = a < b ? a : b;
      s[2 * t + 1] = a < b ? b : a;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < L; i += blockDim.x) out[base + i] = s[i];
}

int threads_for(int pairs) {
  int t = 32;
  while (t < pairs && t < FLOOR_THREADS) t <<= 1;
  return t;
}
}  // namespace

extern "C" int mt_pass_floor(const void* x, void* out, int64_t R, int L,
                             int passes, void* stream) {
  if (R < 0 || L < 0 || L > MAX_ROW || R > INT_MAX || passes < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || L == 0) return 0;
  const size_t smem = (size_t)L * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pass_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pass_floor_kernel<<<(unsigned)R, threads_for(L / 2), smem,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), L, passes);
  return (int)cudaGetLastError();
}
"""


def entry_point(lib):
    fn = lib.mt_pass_floor
    p = ctypes.c_void_p
    fn.argtypes = [p, p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def build_source(path):
    """mt_pass_floor of the CUDA source at `path`, built with the
    package's flags (or FIRST_VERSION when `path` is "first")."""
    if path == "first":
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        path = os.path.join(_build.BUILD_DIR, "passfloor_first.cu")
        with open(path, "w") as f:
            f.write(FIRST_VERSION)
    return entry_point(ctypes.CDLL(_build.build(path)))


def probe_rows(n_sets=2, rows=ROWS, L=LEN, seed=SEED):
    """`n_sets` (rows, L) int32 tensors of random values on the card."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(rows, L),
                                          dtype=np.int64).astype(np.int32))
            .cuda() for _ in range(n_sets)]


def launch(fn, x, out, passes):
    rc = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], passes,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"mt_pass_floor failed: cudaError {rc}")


def time_alone(fn, xs, passes, reps=100):
    """ms a launch of `fn` (mt_pass_floor) at `passes`: raw launches from
    the inputs `xs` into as many preallocated outputs, rotating, after 4
    warm-up launches; CUDA events around the run."""
    outs = [torch.empty_like(x) for x in xs]
    for i in range(4):
        launch(fn, xs[i % len(xs)], outs[i % len(xs)], passes)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(reps):
        launch(fn, xs[i % len(xs)], outs[i % len(xs)], passes)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def sweep(fn, xs, passes=SWEEP):
    """-> ({passes: ms}, least-squares ms a pass, intercept ms)."""
    ms = {p: time_alone(fn, xs, p) for p in passes}
    slope, icpt = np.polyfit(np.array(passes, float),
                             np.array([ms[p] for p in passes]), 1)
    return ms, float(slope), float(icpt)


def check_shapes(fn):
    """The kernel against the plain version at 66 passes (and 0, which
    copies) on odd, short and misaligned shapes; raises on a
    difference."""
    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    for R, L, skip in [(3, 1, 0), (1, 2, 0), (1, 3, 0), (5, 7, 1), (7, 999, 1),
                       (64, 2048, 0), (64, 2048, 2), (9, 2046, 1),
                       (8, 5120, 3), (2, 8191, 1), (4, rowsort.MAX_ROW, 1)]:
        big = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31,
                                            size=R * L + skip,
                                            dtype=np.int64).astype(np.int32))
        x = big.to(dev)[skip:].view(R, L)
        for passes, want in ((66, rowsort.pass_floor_plain(x)), (0, x)):
            got = torch.empty_like(x)
            launch(fn, x, got, passes)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"differs from the plain version: R={R} "
                                     f"L={L} offset {4 * skip} B, {passes} "
                                     f"passes")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--sweep", default=",".join(map(str, SWEEP)),
                    help="pass counts of the sweep, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_passfloor: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    names = args.sources or [os.path.join(_build.CSRC, "rowsort.cu"),
                             "first"]
    fns = [build_source(s) for s in names]
    for fn in fns:
        check_shapes(fn)
    xs = probe_rows()
    order = list(range(len(fns)))
    for turn in range(2 * args.pairs):
        for i in (order if turn % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            ms = time_alone(fns[i], xs, rowsort.FLOOR_PASSES)
            print(json.dumps({"source": names[i], "shape": f"{ROWS}x{LEN}",
                              "passes": rowsort.FLOOR_PASSES, "turn": turn,
                              "ms": ms, "wall_s": time.perf_counter() - t0}))
    for name, fn in zip(names, fns):
        ms, slope, icpt = sweep(fn, xs, [int(p) for p in
                                         args.sweep.split(",")])
        print(json.dumps({"source": name, "sweep_ms": ms,
                          "slope_ms_per_pass": slope, "intercept_ms": icpt}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
