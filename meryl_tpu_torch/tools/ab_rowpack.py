"""Time the set-op evaluator's row packing, numpy against native, on the
host.

    python -m meryl_tpu_torch.tools.ab_rowpack
        [--sizes 131072,1048576,4194304] [--inputs 1,2,3]
        [--threads 1,8] [--turns 3]

Each case is a bucket group of that many entries in all, split over m
sorted unique k=21 inputs drawn from one key pool from a fixed seed (so
their keys overlap, as a set operation's inputs do), with u32 counts, as
MerylDB.load_bucket gives them.  Both arms run
BucketEvaluator._pack_rows on it, as eval_buckets does for a group of
ROW_SPLIT_MIN entries or more:

  numpy   what MERYL_TPU_NO_NATIVE selects
  native  csrc/rowpack_host.cpp through ctypes, at each thread count
          of --threads

Each arm's time is split into `bounds` (the cuts and the row bounds,
every doubling of R included) and `fill` (the arrays).  The arms run in
turns, in one order and then the reverse, and must give the same
arrays.  A line of JSON an arm, case and turn; then a line a case with
each arm's median.  Prints the host's cores first.  Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import time

import numpy as np

from .. import optree

SEED = 25
K = 21


def synthetic_inputs(n, m, seed=SEED):
    """-> m sorted unique (hi, lo, counts-u32) k=21 inputs of about n
    entries in all, each holding about four fifths of one pool."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(0, 1 << (2 * K), size=int(n / m * 1.25),
                                  dtype=np.uint64))
    ins = []
    for _ in range(m):
        lo = pool[rng.random(len(pool)) < 0.8]
        counts = (rng.poisson(30, size=len(lo)) + 1).astype(np.uint32)
        ins.append((np.zeros(len(lo), np.uint64), lo, counts))
    return ins


def timed_pack(ev, ins, m, threads=None):
    """ev._pack_rows(ins, m), the native pass on `threads` threads ->
    seconds of its bounds and fill, the arrays."""
    spent = [0.0]
    real = ev._row_bounds
    default = optree.pack_threads

    def row_bounds(*a):
        t0 = time.perf_counter()
        out = real(*a)
        spent[0] += time.perf_counter() - t0
        return out

    ev._row_bounds = row_bounds
    if threads is not None:
        optree.pack_threads = lambda slots: threads
    try:
        t0 = time.perf_counter()
        out = ev._pack_rows(ins, m)
        total = time.perf_counter() - t0
    finally:
        del ev._row_bounds
        optree.pack_threads = default
    return {"bounds": spent[0], "fill": total - spent[0]}, out


def run(sizes, inputs, threads, turns):
    if optree._native_rowpack() is None:
        raise RuntimeError("the native row pack is not built (g++ "
                           "missing, or MERYL_TPU_NO_NATIVE set)")
    print(json.dumps({"machine": platform.machine(),
                      "cores": len(os.sched_getaffinity(0)),
                      "threads": threads}), flush=True)
    arms = ["numpy"] + [f"native{t}" for t in threads]
    ev = optree.BucketEvaluator(K, "cpu")
    summary = []
    for n in sizes:
        for m in inputs:
            ins = synthetic_inputs(n, m)
            entries = sum(len(c) for _, _, c in ins)
            secs = {arm: [] for arm in arms}
            for turn in range(turns):
                outs = {}
                for arm in (arms if turn % 2 == 0 else arms[::-1]):
                    if arm == "numpy":
                        os.environ["MERYL_TPU_NO_NATIVE"] = "1"
                        try:
                            steps, outs[arm] = timed_pack(ev, ins, m)
                        finally:
                            del os.environ["MERYL_TPU_NO_NATIVE"]
                    else:
                        steps, outs[arm] = timed_pack(ev, ins, m,
                                                      int(arm[6:]))
                    s = sum(steps.values())
                    secs[arm].append(s)
                    R, L = outs[arm][1].shape
                    print(json.dumps(
                        {"arm": arm, "entries": entries, "inputs": m,
                         "rows": R, "row_len": L, "turn": turn,
                         "s": round(s, 5),
                         **{k: round(v, 5) for k, v in steps.items()}}),
                        flush=True)
                want = outs.pop("numpy")
                for arm, got in outs.items():
                    if not all(a.dtype == b.dtype and a.shape == b.shape
                               and np.array_equal(a, b)
                               for a, b in zip(got, want)):
                        raise AssertionError(f"{entries} entries, {m} "
                                             f"inputs: {arm} differs from "
                                             f"numpy")
            rec = {"entries": entries, "inputs": m,
                   **{f"{arm}_s_median": round(statistics.median(s), 5)
                      for arm, s in secs.items()}}
            summary.append(rec)
            print(json.dumps(rec), flush=True)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="131072,1048576,4194304")
    ap.add_argument("--inputs", default="1,2,3")
    ap.add_argument("--threads",
                    default=f"1,{min(8, len(os.sched_getaffinity(0)))}")
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args(argv)
    run([int(x) for x in args.sizes.split(",")],
        [int(x) for x in args.inputs.split(",")],
        sorted({int(x) for x in args.threads.split(",")}), args.turns)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
