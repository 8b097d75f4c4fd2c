"""meryl-import / meryl2-import: build a database from a text list.

Mirrors meryl src/meryl-import/meryl-import.C:29-257 and the
v2 variant (meryl src/meryl2-import/meryl-import.C:200-240):
  -kmers FILE  lines 'KMER [value [label]]'; '#V' sets the persistent
               default value; 'value=V' / 'label=L' lines set the
               persistent defaults for subsequent kmers (v2 syntax)
  -output DB   database to create
  -k K         kmer size (shorter inputs crash the reference; here we
               error; longer inputs keep the RIGHT-most K bases — the
               reference pushes every base through a rolling window,
               meryl-import.C:196-197)
  -multiset    keep duplicate kmers as separate entries
  -maxvalue V  accepted (memory hint in the reference; no-op here)
  -valuewidth VW  accepted (values are fixed 32-bit here)
  -labelwidth LW  store LW-bit labels with each kmer (0 = no labels)
  -forward / -reverse   store the given / reverse-complement kmer
                        instead of the canonical one
"""

from __future__ import annotations

import sys

import numpy as np

from .. import kmer as km
from ..db import MerylDB
from ..io.sequence import open_maybe_compressed

USAGE = """usage: meryl-import -k <kmer-size> -kmers <input-kmers> -output <db.meryl>
  [-multiset] [-maxvalue V] [-valuewidth VW] [-labelwidth LW]
  [-forward | -reverse] [-threads T]
"""


def _decode_int(s: str) -> int:
    s = s.strip()
    if s.startswith("0x"):
        return int(s, 16)
    if s.startswith("0b"):
        return int(s, 2)
    return int(s, 10)  # NOT base 0: "007" must parse as decimal 7


def import_kmers(kmers_path: str, k: int, *, multiset: bool = False,
                 orient: str = "canonical", with_labels: bool = False):
    """-> (hi, lo, counts[, labels]) sorted; duplicates summed unless
    multiset (labels of summed duplicates OR together, matching the
    v2 counting-with-labels convention)."""
    toks = []
    vals = []
    labs = []
    default_value = 1
    default_label = 0
    with open_maybe_compressed(kmers_path) as f:
        for raw in f:
            line = raw if isinstance(raw, bytes) else raw.encode()
            line = line.strip()
            if not line:
                continue
            if line.startswith(b"#"):
                default_value = _decode_int(line[1:].decode())
                continue
            if line.startswith(b"value="):
                default_value = _decode_int(line[6:].decode())
                continue
            if line.startswith(b"label="):
                default_label = _decode_int(line[6:].decode())
                continue
            parts = line.split()
            s = parts[0][-k:]  # rolling window keeps the LAST k bases
            if len(s) < k:
                raise ValueError(
                    f"kmer '{parts[0].decode()}' shorter than k={k}")
            toks.append(s)
            vals.append(_decode_int(parts[1].decode())
                        if len(parts) > 1 else default_value)
            labs.append(_decode_int(parts[2].decode())
                        if len(parts) > 2 else default_label)
    n = len(toks)
    # vectorized encode + canonicalization (the per-kmer python-int
    # path measured 0.07 M lines/s; reference dumps reach billions)
    chars = np.frombuffer(b"".join(toks), np.uint8).reshape(n, k) \
        if n else np.zeros((0, k), np.uint8)
    codes = km.CODE_LUT[chars]
    if (codes > 3).any():
        bad = int(np.flatnonzero((codes > 3).any(axis=1))[0])
        raise ValueError(f"invalid base in kmer '{toks[bad].decode()}'")
    if orient == "reverse":
        codes = (codes ^ 2)[:, ::-1]   # complement is code^2 (A<->T, C<->G)
    hi, lo = km.codes_to_hilo(codes)
    if orient == "canonical":
        rhi, rlo = km.codes_to_hilo((codes ^ 2)[:, ::-1])
        take = (rhi < hi) | ((rhi == hi) & (rlo < lo))
        hi = np.where(take, rhi, hi)
        lo = np.where(take, rlo, lo)
    # stable (hi, lo, input-order) sort, matching the python tuple sort
    order = np.lexsort((np.arange(n), lo, hi))
    hi = hi[order]
    lo = lo[order]
    vv = np.array(vals, np.uint64)[order] if n else np.zeros(0, np.uint64)
    ll = np.array(labs, np.uint64)[order] if n else np.zeros(0, np.uint64)
    if multiset or len(vv) == 0:
        out = (hi, lo, np.minimum(vv, km.VALUE_MAX).astype(np.uint32))
        return out + (ll,) if with_labels else out
    new = np.ones(len(vv), bool)
    new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    starts = np.flatnonzero(new)
    sums = np.add.reduceat(vv, starts)
    out = (hi[starts], lo[starts],
           np.minimum(sums, km.VALUE_MAX).astype(np.uint32))
    if with_labels:
        olab = np.bitwise_or.reduceat(ll, starts)
        out = out + (olab,)
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    kmers_path = out = None
    k = 0
    multiset = False
    orient = "canonical"
    label_bits = 0
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-kmers":
            i += 1
            kmers_path = argv[i]
        elif a == "-output":
            i += 1
            out = argv[i]
        elif a == "-k":
            i += 1
            k = int(argv[i])
        elif a in ("-maxvalue", "-valuewidth"):
            i += 1
        elif a == "-labelwidth":
            i += 1
            label_bits = int(argv[i])
            if not (0 <= label_bits <= 64):
                sys.stderr.write("-labelwidth must be in [0, 64]\n")
                return 1
        elif a == "-multiset":
            multiset = True
        elif a == "-forward":
            orient = "forward"
        elif a == "-reverse":
            orient = "reverse"
        elif a in ("-threads", "-memory"):
            i += 1
        else:
            sys.stderr.write(f"Unknown option '{a}'.\n{USAGE}")
            return 1
        i += 1
    if not kmers_path or not out or not k:
        sys.stderr.write(USAGE)
        return 1
    res = import_kmers(kmers_path, k, multiset=multiset, orient=orient,
                       with_labels=label_bits > 0)
    if label_bits > 0:
        hi, lo, counts, labels = res
        MerylDB.write(out, k, hi, lo, counts, multiset=multiset,
                      labels=labels, label_bits=label_bits)
    else:
        hi, lo, counts = res
        MerylDB.write(out, k, hi, lo, counts, multiset=multiset)
    return 0


if __name__ == "__main__":
    sys.exit(main())
