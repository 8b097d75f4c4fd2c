"""meryl-simple: deliberately trivial reference counter (oracle role).

Mirrors meryl src/meryl-simple/meryl-simple.C:27-218: load all
canonical kmers, sort, run-length count, dump text + histogram.  Usage:
  meryl-simple -k K -S input.fasta [-M out.meryl] [-D out.dump]
               [-H out.histogram] [-m memMB]
"""

from __future__ import annotations

import sys

from .. import kmer as km
from .. import oracle
from ..db import MerylDB
from ..io.sequence import iter_sequences

USAGE = """usage: meryl-simple -k kmerSize -S input.fasta ...
  -k kmerSize
  -S input.fasta
  -M output.meryl
  -D output.dump
  -H output.histogram
  -m memLimit_in_MB (accepted, ignored)
"""


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    k = 0
    seqs_path = m_out = d_out = h_out = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-k":
            i += 1
            k = int(argv[i])
        elif a == "-S":
            i += 1
            seqs_path = argv[i]
        elif a == "-M":
            i += 1
            m_out = argv[i]
        elif a == "-D":
            i += 1
            d_out = argv[i]
        elif a == "-H":
            i += 1
            h_out = argv[i]
        elif a == "-m":
            i += 1
        else:
            sys.stderr.write(f"unknown option '{a}'\n{USAGE}")
            return 1
        i += 1
    if not k or not seqs_path:
        sys.stderr.write(USAGE)
        return 1

    seqs = [s.decode("ascii", "replace")
            for _, s, _ in iter_sequences(seqs_path)]
    hi, lo, counts = oracle.count_kmers(seqs, k)

    if m_out:
        MerylDB.write(m_out, k, hi, lo, counts)
    if d_out:
        from ..reports import format_kmer_lines
        with open(d_out, "wb") as f:
            f.write(format_kmer_lines(hi, lo, counts, k))
    if h_out:
        vals, occ = oracle.histogram(counts)
        with open(h_out, "w") as f:
            for v, o in zip(vals.tolist(), occ.tolist()):
                f.write(f"{v}\t{o}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
