"""Comparing what a job wrote with what the reference worked out.

Every comparison gives a count of mismatches, 0 when the output is
exactly right: for a database the entries missing, extra, with another
count, out of order, in the wrong bucket or with a nonzero high word,
and each field of its index or line of its histogram that differs; for
text, the lines that differ.  An output that is missing or cannot be
read counts as every entry (or line) wanted, plus one.
"""

from __future__ import annotations

import json

import numpy as np

from reference import dbfile


def compare_db(path: str, k: int, want_keys, want_counts):
    """-> (mismatches, what differs)."""
    want_keys = np.asarray(want_keys).astype(np.uint64)
    want_counts = np.asarray(want_counts).astype(np.uint64)
    try:
        got = dbfile.read(path, k)
    except (OSError, ValueError, KeyError, IndexError,
            json.JSONDecodeError) as e:
        return want_keys.size + 1, f"unreadable ({e})"
    keys, counts = got.keys, got.counts.astype(np.uint64)
    parts = {"hi_words": got.hi_nonzero,
             "misplaced": int(np.count_nonzero(
                 dbfile.prefix6(keys, k) != got.bucket)),
             "unordered": int(np.count_nonzero(np.diff(keys) <= 0))
             if keys.size > 1 else 0}
    if keys.size == want_keys.size and np.array_equal(keys, want_keys):
        parts["wrong_count"] = int(np.count_nonzero(counts != want_counts))
    else:
        u, first = np.unique(keys, return_index=True)
        common, iw, iu = np.intersect1d(want_keys, u, assume_unique=True,
                                        return_indices=True)
        parts["missing"] = int(want_keys.size - common.size)
        parts["extra"] = int(keys.size - common.size)
        parts["wrong_count"] = int(np.count_nonzero(
            counts[first[iu]] != want_counts[iw]))
    want_stats = dbfile.stats(want_counts)
    parts["index"] = sum(int(got.index.get(f, -1)) != v
                         for f, v in want_stats.items())
    parts["histogram"] = compare_lines(
        "\n".join(got.histogram) + "\n" if got.histogram else "",
        "".join(s + "\n" for s in dbfile.histogram_lines(want_counts)))
    n = sum(parts.values())
    return n, ", ".join(f"{a} {b}" for a, b in parts.items() if b)


def compare_lines(got, want: str) -> int:
    w = want.splitlines()
    if got is None:
        return len(w) + 1
    g = got.splitlines()
    return sum(a != b for a, b in zip(g, w)) + abs(len(g) - len(w))


def compare_file(path: str, want: str):
    try:
        with open(path) as f:
            got = f.read()
    except OSError as e:
        return compare_lines(None, want), f"unreadable ({e})"
    n = compare_lines(got, want)
    return n, (f"{n} lines differ" if n else "")
