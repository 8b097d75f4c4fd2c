"""Time the count's DB write, numpy against native, on the host.

    python -m meryl_tpu_torch.tools.ab_dbwrite [--sizes 10500000,16000000]
        [--turns 3] [--sweep 4096,65536,262144,1048576] [--dir DIR]

Each size is a synthetic sorted k=21 DB from a fixed seed (distinct
canonical-range keys, counts like a 30x read set's: errors at 1, a peak
near 30, a long tail of repeats up to 10^6).  Both arms of db._write_files
write it as MerylDB.write does:

  numpy   the plain version (what MERYL_TPU_NO_NATIVE selects), timed
          step by step: cast, prefix (the per-entry 6-bit prefix and its
          searchsorted), files (64 buckets), histogram (np.unique), stats
  native  csrc/db_write.cpp through ctypes: bounds, files, histogram and
          statistics in one pass, from as many threads as the process
          may use (a DB under db.THREADED_MIN: the calling thread)

The arms run in turns, A B then B A, into DIR (default: a temporary
directory) and must write the same files and histogram.  A line of JSON
an arm, size and turn: seconds, and the numpy arm's steps.  --sweep
writes those sizes natively on one thread and on all of them, in turns,
to place db.THREADED_MIN.  Prints the host's cores and the threads used
first.  Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import statistics
import tempfile
import time

import numpy as np

from .. import db
from .. import kmer as km

SEED = 21
K = 21


def synthetic_db(n, seed=SEED):
    """-> (hi, lo, counts) of n sorted distinct k=21 keys."""
    rng = np.random.default_rng(seed)
    span = 1 << (2 * K)
    gaps = rng.integers(1, 2 * (span // n), size=n, dtype=np.uint64)
    lo = np.cumsum(gaps, dtype=np.uint64)
    u = rng.random(n)
    counts = rng.poisson(30, size=n).astype(np.uint32) + 1
    counts[u < 0.35] = 1                                  # read errors
    tail = u > 0.995                                      # repeats
    counts[tail] = np.minimum(
        (30 * (1 + rng.pareto(1.0, int(tail.sum())))), 1e6).astype(np.uint32)
    return np.zeros(n, np.uint64), lo, counts


def numpy_split(path, hi, lo, counts):
    """The numpy arm of MerylDB.write, timed a step at a time -> seconds a
    step, the histogram."""
    t = {}
    t0 = time.perf_counter()
    hi = np.ascontiguousarray(hi, dtype=np.uint64)
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    t["cast"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pref = km.prefix6_from_hilo(hi, lo, K)
    bounds = np.searchsorted(pref, np.arange(db.NUM_FILES + 1,
                                             dtype=np.uint32))
    t["prefix"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    os.makedirs(path, exist_ok=True)
    for ff in range(db.NUM_FILES):
        b, e = int(bounds[ff]), int(bounds[ff + 1])
        db.MerylDB._write_bucket(os.path.join(path, db.bucket_name(ff)), K,
                                 hi[b:e], lo[b:e], counts[b:e])
    t["files"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hist = db.sparse_histogram(counts)
    t["histogram"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    db.compute_stats(counts)
    t["stats"] = time.perf_counter() - t0
    return t, hist


def native_write(path, hi, lo, counts):
    """The native arm -> seconds, the histogram."""
    t0 = time.perf_counter()
    os.makedirs(path, exist_ok=True)
    hist, _ = db._write_files(path, None, K, hi, lo, counts, None, 64)
    return time.perf_counter() - t0, hist


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def _require_native():
    if db._native_writer() is None:
        raise RuntimeError("the native writer is not built (g++ missing, or "
                           "MERYL_TPU_NO_NATIVE set)")


def run(sizes, turns, workdir):
    _require_native()
    cores = len(os.sched_getaffinity(0))
    print(json.dumps({"machine": platform.machine(), "cores": cores,
                      "threads": min(cores, db.NUM_FILES),
                      "threaded_min": db.THREADED_MIN}), flush=True)
    records = []
    for n in sizes:
        hi, lo, counts = synthetic_db(n)
        a, b = os.path.join(workdir, "numpy"), os.path.join(workdir, "native")
        for turn in range(turns):
            order = ("numpy", "native") if turn % 2 == 0 else \
                ("native", "numpy")
            for arm in order:
                if arm == "numpy":
                    steps, hist_a = numpy_split(a, hi, lo, counts)
                    rec = {"arm": arm, "entries": n, "turn": turn,
                           "s": round(sum(steps.values()), 4),
                           **{k: round(v, 4) for k, v in steps.items()}}
                else:
                    s, hist_b = native_write(b, hi, lo, counts)
                    rec = {"arm": arm, "entries": n, "turn": turn,
                           "s": round(s, 4)}
                records.append(rec)
                print(json.dumps(rec), flush=True)
            if _files(a) != _files(b) or not all(
                    np.array_equal(x, y) for x, y in zip(hist_a, hist_b)):
                raise AssertionError(f"{n} entries: the native DB differs "
                                     "from numpy's")
            shutil.rmtree(a)
            shutil.rmtree(b)
    return records


def sweep(sizes, turns, workdir):
    """Native on one thread against all of them, in turns -> records."""
    _require_native()
    keep = db.THREADED_MIN
    records = []
    try:
        for n in sizes:
            hi, lo, counts = synthetic_db(n)
            out = {1: [], len(os.sched_getaffinity(0)): []}
            for turn in range(turns):
                for threads in (sorted(out) if turn % 2 == 0
                                else sorted(out, reverse=True)):
                    db.THREADED_MIN = n + 1 if threads == 1 else 0
                    path = os.path.join(workdir, f"sweep{threads}")
                    out[threads].append(native_write(path, hi, lo, counts)[0])
                    shutil.rmtree(path)
            for threads, s in out.items():
                rec = {"sweep": n, "threads": threads,
                       "ms_median": round(statistics.median(s) * 1e3, 3),
                       "ms_min": round(min(s) * 1e3, 3)}
                records.append(rec)
                print(json.dumps(rec), flush=True)
    finally:
        db.THREADED_MIN = keep
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="10500000,16000000")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--sweep", default="")
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    workdir = tempfile.mkdtemp(prefix="ab_dbwrite.", dir=args.dir)
    try:
        if args.sizes:
            run([int(x) for x in args.sizes.split(",")], args.turns, workdir)
        if args.sweep:
            sweep([int(x) for x in args.sweep.split(",")], args.turns,
                  workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
