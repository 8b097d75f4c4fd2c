"""The program's k-mer database format, frozen here so that the check
decodes what a job wrote without the program's own reader.

A database is a directory:
  merylIndex.json   {"magic": "merylTpuIndex.v01", "k", "numFiles": 64,
                     "numUnique", "numDistinct", "numTotal", ...}
  histogram.tsv     "value<TAB>occurrences" lines, ascending value
  0x00.kmb .. 0x3f.kmb, one a 6-bit prefix of the 2k-bit k-mer:
    8s magic b"MTPUKMB1", u32 k, u32 flags, u64 n,
    u64[n] lo (k-mer bits 0-63), u64[n] hi (bits 64-127), u32[n] count
    (little-endian; entries ascending).

`write` makes the same files from arrays; the benchmark's control uses
it to put the reference's outputs where a job's would be.
"""

from __future__ import annotations

import json
import os

import numpy as np

MAGIC_INDEX = "merylTpuIndex.v01"
MAGIC_BUCKET = b"MTPUKMB1"
NUM_FILES = 64


def _bucket(path: str, ff: int) -> str:
    return os.path.join(path, f"0x{ff:02x}.kmb")


def prefix6(keys: np.ndarray, k: int) -> np.ndarray:
    """Bucket of each key (k <= 31: keys fit one word)."""
    shift = 2 * k - 6
    keys = np.asarray(keys, np.uint64)
    if shift < 0:
        return (keys << np.uint64(-shift)) & np.uint64(63)
    return (keys >> np.uint64(shift)) & np.uint64(63)


class Decoded:
    """A database as read: keys (uint64; hi words checked to be 0),
    counts (uint32), the bucket each entry came from, the index and the
    histogram lines."""

    def __init__(self, keys, counts, bucket, index, histogram,
                 hi_nonzero):
        self.keys = keys
        self.counts = counts
        self.bucket = bucket
        self.index = index
        self.histogram = histogram
        self.hi_nonzero = hi_nonzero


def read(path: str, k: int) -> Decoded:
    """Decode a database; raises ValueError on a malformed one."""
    with open(os.path.join(path, "merylIndex.json")) as f:
        index = json.load(f)
    if index.get("magic") != MAGIC_INDEX:
        raise ValueError(f"{path}: not a database of this format")
    if int(index["k"]) != k:
        raise ValueError(f"{path}: k {index['k']} != {k}")
    keys, counts, bucket = [], [], []
    hi_nonzero = 0
    for ff in range(NUM_FILES):
        with open(_bucket(path, ff), "rb") as f:
            if f.read(8) != MAGIC_BUCKET:
                raise ValueError(f"{path}: bucket {ff}: bad magic")
            kk, flags = np.fromfile(f, np.uint32, 2)
            if int(kk) != k:
                raise ValueError(f"{path}: bucket {ff}: k {kk} != {k}")
            n = int(np.fromfile(f, np.uint64, 1)[0])
            lo = np.fromfile(f, np.uint64, n)
            hi = np.fromfile(f, np.uint64, n)
            c = np.fromfile(f, np.uint32, n)
            if lo.size != n or hi.size != n or c.size != n:
                raise ValueError(f"{path}: bucket {ff}: short file")
        hi_nonzero += int(np.count_nonzero(hi))
        keys.append(lo)
        counts.append(c)
        bucket.append(np.full(n, ff, np.uint64))
    with open(os.path.join(path, "histogram.tsv")) as f:
        hist = f.read().splitlines()
    return Decoded(np.concatenate(keys), np.concatenate(counts),
                   np.concatenate(bucket), index, hist, hi_nonzero)


def histogram_lines(counts: np.ndarray) -> list[str]:
    v, o = np.unique(np.asarray(counts, np.int64), return_counts=True)
    return [f"{a}\t{b}" for a, b in zip(v.tolist(), o.tolist())]


def stats(counts: np.ndarray) -> dict:
    c = np.asarray(counts, np.int64)
    return {"numUnique": int((c == 1).sum()), "numDistinct": int(c.size),
            "numTotal": int(c.sum())}


def write(path: str, k: int, keys: np.ndarray, counts: np.ndarray) -> None:
    """A database of sorted unique keys and their counts (> 0)."""
    keys = np.asarray(keys, np.uint64)
    counts = np.asarray(counts, np.uint32)
    os.makedirs(path, exist_ok=True)
    ff = prefix6(keys, k)
    bounds = np.searchsorted(ff, np.arange(NUM_FILES + 1, dtype=np.uint64))
    for b in range(NUM_FILES):
        s, e = int(bounds[b]), int(bounds[b + 1])
        with open(_bucket(path, b), "wb") as f:
            f.write(MAGIC_BUCKET)
            np.array([k, 0], np.uint32).tofile(f)
            np.array([e - s], np.uint64).tofile(f)
            keys[s:e].tofile(f)
            np.zeros(e - s, np.uint64).tofile(f)
            counts[s:e].tofile(f)
    with open(os.path.join(path, "histogram.tsv"), "w") as f:
        f.write("".join(line + "\n" for line in histogram_lines(counts)))
    with open(os.path.join(path, "merylIndex.json"), "w") as f:
        json.dump({"magic": MAGIC_INDEX, "k": int(k), "numFiles": NUM_FILES,
                   "ordering": "ACTG", "mode": "canonical", "hpc": False,
                   "multiset": False, **stats(counts)}, f, indent=1)
