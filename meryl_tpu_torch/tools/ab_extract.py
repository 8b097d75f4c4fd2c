"""Time versions of the extraction kernel against each other on the card.

    python -m meryl_tpu_torch.tools.ab_extract [SOURCE.cu ...]

Each SOURCE is a version of meryl_tpu_torch/csrc/extract.cu with the
same C entry point (mt_extract_packed); with none, the package's own is
timed.  Each is built with the package's nvcc flags, checked against
the plain PyTorch version on chip_smoke.py's 2^22-code chunk, then
timed alone at k=21 and 33 canonical and k=64 "both": raw launches of
the C entry point into four preallocated output sets, more bytes than
the L2 holds.  The sources take turns, A B .. then .. B A, `--pairs`
times.  Then the package's own wrapper (ops/extract_cuda.py) is timed
as the count path calls it, the shapes in order and reversed: CUDA
events over 20 calls, and the host's time to issue them.  Prints the
card's name and power limit, then one JSON line per timing.  Needs
CUDA; chip_smoke.py times the kernel alone the same way.
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
from .. import kmer as km
from ..ops import extract as ext
from ..ops import extract_cuda

SEED = 20261016
CHUNK = 1 << 22
TIMED = [(21, "canonical"), (33, "canonical"), (64, "both")]
MODE_ID = extract_cuda._MODE_ID


def chunk_wire(L=CHUNK, seed=SEED):
    """chip_smoke.py's chunk: random codes, a separator every ~150
    codes, 200 N runs, a trailing separator run (n_real < L) ->
    kmer.pack_codes_2bit's (packed2, exc, n_real)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    codes[rng.integers(0, L, size=L // 150)] = 255
    for s in rng.integers(0, L - 50, size=200):
        codes[s:s + int(rng.integers(1, 40))] = 255
    codes[L - 1000:] = 255
    return km.pack_codes_2bit(codes)


def time_alone(fn, p, e, n_real, k, mode, reps=200):
    """ms a launch and host ms a launch of `fn` (mt_extract_packed),
    raw launches into four output sets rotating, after 8 warm-up
    launches; CUDA events around the run."""
    L = p.numel() * 16
    nw = 1 if k <= 32 else 2
    shape = (L,) if nw == 1 else (L, 2)
    sets = [[torch.empty(shape, dtype=torch.int64, device=p.device)
             for _ in range(2 if mode == "both" else 1)]
            + [torch.empty(L, dtype=torch.bool, device=p.device)]
            for _ in range(4)]
    stream = torch.cuda.current_stream().cuda_stream
    args = [(p.data_ptr(), e.data_ptr(), e.numel(), L, n_real, k,
             MODE_ID[mode], o[0].data_ptr(),
             o[1].data_ptr() if mode == "both" else None, o[-1].data_ptr(),
             stream) for o in sets]
    rcs = 0
    for i in range(8):
        rcs |= fn(*args[i % 4])
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for i in range(reps):
        rcs |= fn(*args[i % 4])
    host = time.perf_counter() - t0
    b.record()
    torch.cuda.synchronize()
    if rcs:
        raise RuntimeError(f"extract launch failed: k={k} {mode}")
    return a.elapsed_time(b) / reps, host * 1e3 / reps


def time_calls(fn, reps=20):
    """ms a call by CUDA events over `reps` calls of `fn` after three
    warm-up calls, and the host's ms a call to issue them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, host * 1e3 / reps


def _build_source(path):
    return extract_cuda.entry_point(ctypes.CDLL(_build.build(path)))


def _check(fn, p, e, n_real, k, mode):
    """The source's kernel against the plain version at valid
    positions."""
    L = p.numel() * 16
    shape = (L,) if k <= 32 else (L, 2)
    got = [torch.empty(shape, dtype=torch.int64, device=p.device)
           for _ in range(2 if mode == "both" else 1)]
    got.append(torch.empty(L, dtype=torch.bool, device=p.device))
    rc = fn(p.data_ptr(), e.data_ptr(), e.numel(), L, n_real, k,
            MODE_ID[mode], got[0].data_ptr(),
            got[1].data_ptr() if mode == "both" else None,
            got[-1].data_ptr(), torch.cuda.current_stream().cuda_stream)
    want = ext.extract_kmers_packed(p, e, n_real, k, mode)
    torch.cuda.synchronize()
    v = want[-1]
    if rc or not torch.equal(got[-1], v) or not all(
            torch.equal(g[v], w[v]) for g, w in zip(got[:-1], want[:-1])):
        raise AssertionError(f"differs from the plain version: k={k} {mode}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*",
                    default=[os.path.join(_build.CSRC, "extract.cu")])
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_extract: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    packed2, exc, n_real = chunk_wire()
    p = torch.from_numpy(packed2.view(np.int32)).cuda()
    e = torch.from_numpy(exc).cuda()
    fns = [_build_source(s) for s in args.sources]
    for fn in fns:
        for k, mode in TIMED:
            _check(fn, p, e, n_real, k, mode)
    order = list(range(len(fns)))
    for k, mode in TIMED:
        for turn in range(2 * args.pairs):
            for i in (order if turn % 2 == 0 else order[::-1]):
                ms, host = time_alone(fns[i], p, e, n_real, k, mode)
                print(json.dumps({"source": args.sources[i], "k": k,
                                  "mode": mode, "turn": turn, "ms": ms,
                                  "host_ms": host}))
    for turn, shapes in enumerate((TIMED, TIMED[::-1])):
        for k, mode in shapes:
            ms, host = time_calls(lambda: extract_cuda
                                  .extract_kmers_packed(p, e, n_real, k,
                                                        mode))
            print(json.dumps({"call": "extract_cuda.extract_kmers_packed",
                              "k": k, "mode": mode, "turn": turn,
                              "ms": ms, "host_ms": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
