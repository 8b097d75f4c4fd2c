"""Time the one-card count's finalize tail, numpy against native, on the
host.

    python -m meryl_tpu_torch.tools.ab_finalize
        [--sizes 10500000,16000000,26000000] [--windows 0,4124]
        [--threads 1,8] [--turns 3]

Each size is a synthetic dense download of distinct k=21 keys from a
fixed seed, as DeviceAccCounter._download_dense fetches it (int64 key
words, each unsigned key ^ 2^63, and uint32 counts), with a capture run
of that many windows, about half of them on keys the download holds
(a HiFi count merges about 4,124 a job).  Both arms turn it into the
sorted unique (hi, lo, counts-u32) that finalize returns:

  numpy   what MERYL_TPU_NO_NATIVE selects, timed step by step: decode
          (mw.to_hilo and the counts widened to u64), merge (merge_runs
          of the download and the capture run, its clamp and cast)
  native  counter.finalize_dense, csrc/finalize_host.cpp through
          ctypes, at each thread count of --threads

The arms run in turns, in one order and then the reverse, and must give
the same arrays.  A line of JSON an arm, size, window count and turn:
seconds, and the numpy arm's steps; then a line a case with each arm's
median.  Prints the host's cores first.  Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import time

import numpy as np

from .. import counter as ctr
from ..ops import multiword as mw

SEED = 23
K = 21


def synthetic_download(n, windows, seed=SEED):
    """-> (keys int64 words, counts u32, capture run (hi, lo, counts-u64))
    of n distinct sorted k=21 keys and `windows` captured windows, half
    on keys of the download and half on keys it lacks."""
    rng = np.random.default_rng(seed)
    fresh = windows - windows // 2
    span = 1 << (2 * K)
    gaps = rng.integers(1, 2 * (span // (n + fresh)), size=n + fresh,
                        dtype=np.uint64)
    lo = np.cumsum(gaps, dtype=np.uint64)
    out = np.zeros(len(lo), bool)
    out[rng.choice(len(lo), fresh, replace=False)] = True
    d_lo = lo[~out]
    counts = (rng.poisson(30, size=n) + 1).astype(np.uint32)
    keys = mw.from_hilo(np.zeros(n, np.uint64), d_lo, K)
    s_lo = np.sort(np.concatenate(
        [lo[out], d_lo[rng.choice(n, windows // 2, replace=False)]]))
    small = (np.zeros(len(s_lo), np.uint64), s_lo,
             np.ones(len(s_lo), np.uint64))
    return keys, counts, small


def numpy_tail(keys, counts, small):
    """finalize's numpy tail, timed a step at a time -> seconds a step,
    the result."""
    t = {}
    t0 = time.perf_counter()
    hi, lo = mw.to_hilo(keys, K)
    c = counts.astype(np.uint64)
    t["decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = ctr.merge_runs([r for r in ((hi, lo, c), small) if len(r[2])])
    t["merge"] = time.perf_counter() - t0
    return t, out


def native_tail(lib, keys, counts, small, threads):
    """The native arm -> seconds, the result."""
    t0 = time.perf_counter()
    out = ctr.finalize_dense(lib, keys, counts, ctr.merge_runs([small]),
                             threads)
    return time.perf_counter() - t0, out


def run(sizes, windows, threads, turns):
    lib = ctr._native_finalize()
    if lib is None:
        raise RuntimeError("the native finalize pass is not built (g++ "
                           "missing, or MERYL_TPU_NO_NATIVE set)")
    print(json.dumps({"machine": platform.machine(),
                      "cores": len(os.sched_getaffinity(0)),
                      "threads": threads}), flush=True)
    arms = ["numpy"] + [f"native{t}" for t in threads]
    summary = []
    for n in sizes:
        for w in windows:
            keys, counts, small = synthetic_download(n, w)
            secs = {arm: [] for arm in arms}
            for turn in range(turns):
                outs = {}
                for arm in (arms if turn % 2 == 0 else arms[::-1]):
                    rec = {"arm": arm, "entries": n, "windows": w,
                           "turn": turn}
                    if arm == "numpy":
                        steps, outs[arm] = numpy_tail(keys, counts, small)
                        s = sum(steps.values())
                        rec.update({k: round(v, 4) for k, v in steps.items()})
                    else:
                        s, outs[arm] = native_tail(
                            lib, keys, counts, small, int(arm[6:]))
                    rec["s"] = round(s, 4)
                    secs[arm].append(s)
                    print(json.dumps(rec), flush=True)
                want = outs.pop("numpy")
                for arm, got in outs.items():
                    if not all(a.dtype == b.dtype and np.array_equal(a, b)
                               for a, b in zip(got, want)):
                        raise AssertionError(f"{n} entries, {w} windows: "
                                             f"{arm} differs from numpy")
            rec = {"entries": n, "windows": w,
                   **{f"{arm}_s_median": round(statistics.median(s), 4)
                      for arm, s in secs.items()}}
            summary.append(rec)
            print(json.dumps(rec), flush=True)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="10500000,16000000,26000000")
    ap.add_argument("--windows", default="0,4124")
    ap.add_argument("--threads",
                    default=f"1,{len(os.sched_getaffinity(0))}")
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args(argv)
    run([int(x) for x in args.sizes.split(",")],
        [int(x) for x in args.windows.split(",")],
        sorted({int(x) for x in args.threads.split(",")}), args.turns)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
