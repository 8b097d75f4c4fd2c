"""meryl-analyze: GC-content and 2-mer microsatellite histograms.

Mirrors meryl src/meryl-analyze/meryl-analyze.C:155-480.
Output files contain 'score<TAB>multiplicity<TAB>count' lines where
score is the per-kmer base-composition / microsatellite score:
  -gc  ->  prefix.GC.hist, prefix.AT.hist
  -ga  ->  prefix.GA_TC.hist, prefix.GA.hist, prefix.TC.hist
  -gt  ->  prefix.GT_AC.hist, prefix.GT.hist, prefix.AC.hist

Microsatellite score (histGA semantics, meryl-analyze.C:235-300): scan
the kmer's bases; maximal runs drawn only from the two target letters
that contain BOTH letters contribute their length to the score.
"""

from __future__ import annotations

import sys
from collections import defaultdict

import numpy as np

from ..db import MerylDB

USAGE = """usage: meryl-analyze -mers <meryldb> -prefix <prefix> (-gc | -ga | -gt)
  -mers <meryldb>   : meryl database to analyze.
  -prefix <prefix>  : prefix for output file(s).
  -gc | -ga | -gt   : histogram type.
"""


def _base_codes(hi, lo, k):
    """(N, k) uint8 base codes, first base in column 0."""
    n = len(lo)
    out = np.empty((n, k), np.uint8)
    hi = hi.astype(np.uint64)
    lo = lo.astype(np.uint64)
    for i in range(k):
        shift = 2 * (k - 1 - i)
        if shift >= 64:
            c = (hi >> np.uint64(shift - 64)) & np.uint64(3)
        else:
            c = (lo >> np.uint64(shift)) & np.uint64(3)
        out[:, i] = c
    return out


def _run_score(codes: np.ndarray, x: int, y: int) -> np.ndarray:
    """Vectorized microsatellite score: sum of lengths of maximal runs
    over alphabet {x, y} that contain both letters."""
    n, k = codes.shape
    score = np.zeros(n, np.uint32)
    cx = np.zeros(n, np.uint32)
    cy = np.zeros(n, np.uint32)
    inxy = (codes == x) | (codes == y)
    for i in range(k):
        isx = codes[:, i] == x
        isy = codes[:, i] == y
        brk = ~inxy[:, i]
        add = np.where(brk & (cx > 0) & (cy > 0), cx + cy, 0)
        score += add
        cx = np.where(brk, 0, cx + isx)
        cy = np.where(brk, 0, cy + isy)
    score += np.where((cx > 0) & (cy > 0), cx + cy, 0)
    return score


def _hist_insert(hists, scores, values):
    for s, v in zip(scores.tolist(), values.tolist()):
        hists[int(s)][int(v)] += 1


def _print_hist(path, hists, k):
    with open(path, "w") as f:
        for ll in range(k + 1):
            h = hists.get(ll)
            if not h:
                continue
            for cc in sorted(h):
                f.write(f"{ll}\t{cc}\t{h[cc]}\n")


def analyze(db_path: str, prefix: str, mode: str):
    db = MerylDB.open(db_path)
    k = db.k
    # base-code letters: A=0 C=1 T=2 G=3
    A, C, T, G = 0, 1, 2, 3
    h1 = defaultdict(lambda: defaultdict(int))
    h2 = defaultdict(lambda: defaultdict(int))
    hc = defaultdict(lambda: defaultdict(int))
    for ff in range(64):
        hi, lo, counts = db.load_bucket(ff)
        if len(counts) == 0:
            continue
        codes = _base_codes(hi, lo, k)
        if mode == "gc":
            gc = ((codes == G) | (codes == C)).sum(axis=1)
            at = ((codes == A) | (codes == T)).sum(axis=1)
            _hist_insert(h1, gc, counts)
            _hist_insert(h2, at, counts)
        elif mode == "ga":
            f = _run_score(codes, G, A)
            r = _run_score(codes, T, C)
            _hist_insert(h1, f, counts)
            _hist_insert(h2, r, counts)
            _hist_insert(hc, np.maximum(f, r), counts)
        elif mode == "gt":
            f = _run_score(codes, G, T)
            r = _run_score(codes, A, C)
            _hist_insert(h1, f, counts)
            _hist_insert(h2, r, counts)
            _hist_insert(hc, np.maximum(f, r), counts)
    if mode == "gc":
        _print_hist(f"{prefix}.GC.hist", h1, k)
        _print_hist(f"{prefix}.AT.hist", h2, k)
    elif mode == "ga":
        _print_hist(f"{prefix}.GA_TC.hist", hc, k)
        _print_hist(f"{prefix}.GA.hist", h1, k)
        _print_hist(f"{prefix}.TC.hist", h2, k)
    else:
        _print_hist(f"{prefix}.GT_AC.hist", hc, k)
        _print_hist(f"{prefix}.GT.hist", h1, k)
        _print_hist(f"{prefix}.AC.hist", h2, k)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    db = prefix = mode = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-mers":
            i += 1
            db = argv[i]
        elif a == "-prefix":
            i += 1
            prefix = argv[i]
        elif a in ("-gc", "-ga", "-gt"):
            mode = a[1:]
        elif a == "-verbose":
            pass
        else:
            sys.stderr.write(f"unknown option '{a}'\n{USAGE}")
            return 1
        i += 1
    if not db or not prefix or not mode:
        sys.stderr.write(USAGE)
        return 1
    analyze(db, prefix, mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
