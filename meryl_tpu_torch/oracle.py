"""Trivial reference k-mer counter (the meryl-simple role).

A deliberately simple, obviously-correct counter used as a differential
oracle by the test suite, mirroring the reference's use of meryl-simple
(meryl src/meryl-simple/meryl-simple.C:27-218): extract every
kmer, canonicalize, sort, run-length count.

Non-ACGT characters break kmers (reference kmerIterator semantics, see
meryl src/meryl/merylOp-countThreads.C:196-226).
"""

from __future__ import annotations

import numpy as np

from . import kmer as km


def _seq_kmers(seq: str, k: int, mode: str):
    """Yield kmer integers from one sequence string."""
    codes = km.encode_bases(seq)
    n = len(codes)
    out = []
    v = 0
    run = 0  # length of current valid run
    mask = (1 << (2 * k)) - 1
    for i in range(n):
        c = int(codes[i])
        if c == 255:
            run = 0
            v = 0
            continue
        v = ((v << 2) | c) & mask
        run += 1
        if run >= k:
            f = v
            if mode == "forward":
                out.append(f)
            elif mode == "reverse":
                out.append(km.revcomp_kmer(f, k))
            else:
                out.append(km.canonical_kmer(f, k))
    return out


def homopoly_compress(seq: str) -> str:
    """Collapse homopolymer runs to a single base (reference
    homopolyCompress, used via merylInput::loadBases,
    meryl src/meryl/merylInput.C:258-263).  Case-insensitive
    on run detection is NOT done: bytes are compared exactly after
    uppercasing by our IO layer; here we compare raw characters."""
    if not seq:
        return seq
    out = [seq[0]]
    for ch in seq[1:]:
        if ch != out[-1]:
            out.append(ch)
    return "".join(out)


def count_kmers(seqs, k: int, mode: str = "canonical", hpc: bool = False):
    """Count kmers over sequences.  Returns (hi, lo, counts) sorted by
    kmer value ascending (meryl ACTG order)."""
    allk = []
    for s in seqs:
        if hpc:
            s = homopoly_compress(s)
        allk.extend(_seq_kmers(s, k, mode))
    if not allk:
        z = np.zeros(0, dtype=np.uint64)
        return z, z.copy(), np.zeros(0, dtype=np.uint32)
    allk.sort()
    uniq = []
    cnts = []
    prev = None
    c = 0
    for v in allk:
        if v == prev:
            c += 1
        else:
            if prev is not None:
                uniq.append(prev)
                cnts.append(c)
            prev = v
            c = 1
    uniq.append(prev)
    cnts.append(c)
    hi = np.array([(v >> 64) & 0xFFFFFFFFFFFFFFFF for v in uniq], dtype=np.uint64)
    lo = np.array([v & 0xFFFFFFFFFFFFFFFF for v in uniq], dtype=np.uint64)
    counts = np.minimum(np.array(cnts, dtype=np.uint64), km.VALUE_MAX).astype(np.uint32)
    return hi, lo, counts


def histogram(counts: np.ndarray):
    """value -> #distinct-kmers-with-that-value, as sorted (values, occ)."""
    if len(counts) == 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint64)
    vals, occ = np.unique(counts, return_counts=True)
    return vals.astype(np.uint64), occ.astype(np.uint64)
