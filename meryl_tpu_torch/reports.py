"""Text reports: print / histogram / statistics / ploidy.

Output formats match the reference byte-for-byte where the format is
visible in meryl proper:
  print:       "KMER\\tvalue\\n" in ACTG sort order
               (meryl src/meryl/merylOp-nextMer.C:663-678)
  histogram:   "value\\toccurrences\\n"
               (meryl src/meryl/merylOp-histogram.C:39-42)
  statistics:  header + 5-column table
               (meryl src/meryl/merylOp-histogram.C:65-96)
  ploidy:      stderr report + machine line on stdout
               (meryl src/meryl/merylOp-histogram.C:140-156)
"""

from __future__ import annotations

import sys

import numpy as np

from . import kmer as km
from .histogram import MerylHistogram


def format_kmer_lines(hi, lo, counts, k: int,
                      acgt_order: bool = False, labels=None) -> bytes:
    """Vectorized 'KMER\\tvalue[\\tlabel]\\n' text: bases and decimal
    fields land in a fixed-width byte matrix, then one boolean
    compaction drops the leading digit padding — no per-line Python
    (the reference's C printer does ~10M lines/s; a str.join loop
    measured ~1M/s on 4M-kmer DBs)."""
    n = len(counts)
    chars = km.hilo_to_char_matrix(hi, lo, k)
    if acgt_order:
        chars = km.recanonicalize_chars(chars)
    cols = [np.asarray(counts)]
    if labels is not None:
        cols.append(np.asarray(labels))
    widths = [max(1, len(str(int(c.max())))) if n else 1 for c in cols]
    W = k + sum(w + 1 for w in widths) + 1    # bases (\t digits)* \n
    buf = np.empty((n, W), np.uint8)
    keep = np.empty((n, W), bool)
    buf[:, :k] = chars
    keep[:, :k] = True
    p = k
    trivial = True
    for c, D in zip(cols, widths):
        buf[:, p] = 0x09
        keep[:, p] = True
        c = c.astype(np.uint32 if (n == 0 or int(c.max()) < (1 << 32))
                     else np.uint64)
        _fill_digits(buf, p + 1, D, c)
        if D > 1:
            sig = np.maximum.accumulate(
                buf[:, p + 1:p + D + 1] != 0x30, axis=1)
            sig[:, -1] = True                 # value 0 still prints '0'
            keep[:, p + 1:p + D + 1] = sig
            trivial = False
        else:
            keep[:, p + 1] = True
        p += D + 1
    buf[:, p] = 0x0A
    keep[:, p] = True
    if trivial:
        return buf.tobytes()
    return buf.ravel()[keep.ravel()].tobytes()


_DIG4 = None


def _dig4():
    """(10000, 4) zero-padded ASCII digit table: one gather replaces
    four per-digit integer divisions (numpy uint division is the
    bottleneck of decimal formatting at ~30M/s)."""
    global _DIG4
    if _DIG4 is None:
        v = np.arange(10000, dtype=np.uint32)
        d = np.empty((10000, 4), np.uint8)
        for j in range(4):
            v, r = np.divmod(v, np.uint32(10))
            d[:, 3 - j] = 0x30 + r.astype(np.uint8)
        _DIG4 = d
    return _DIG4


def _fill_digits(buf, p: int, D: int, c: np.ndarray) -> None:
    """Write c (< 10**D) as D zero-padded ASCII digits into
    buf[:, p:p+D] using the 4-digit table — ceil(D/4)-1 divmods."""
    t = _dig4()
    end = p + D
    while D > 4:
        c, r = np.divmod(c, np.uint32(10000) if c.dtype == np.uint32
                         else np.uint64(10000))
        buf[:, end - 4:end] = t[r]
        end -= 4
        D -= 4
    buf[:, end - D:end] = t[c][:, 4 - D:]


def format_int_table(cols, prefix: bytes = b"",
                     suffix: bytes = b"") -> bytes:
    """Vectorized 'prefix<c0>\\t<c1>...<suffix>\\n' decimal table: the
    same fixed-width + keep-mask scheme as format_kmer_lines, for the
    per-position dump formats (BED/wig) whose line counts reach genome
    scale."""
    cols = [np.asarray(c) for c in cols]
    n = len(cols[0])
    if n == 0:
        return b""
    widths = [max(1, len(str(int(c.max())))) for c in cols]
    pw, sw = len(prefix), len(suffix)
    W = pw + sum(widths) + (len(cols) - 1) + sw + 1
    buf = np.empty((n, W), np.uint8)
    keep = np.empty((n, W), bool)
    if pw:
        buf[:, :pw] = np.frombuffer(prefix, np.uint8)
        keep[:, :pw] = True
    p = pw
    trivial = True
    for i, (c, D) in enumerate(zip(cols, widths)):
        if i:
            buf[:, p] = 0x09
            keep[:, p] = True
            p += 1
        c = c.astype(np.uint32 if int(c.max()) < (1 << 32)
                     else np.uint64)
        _fill_digits(buf, p, D, c)
        if D > 1:
            sig = np.maximum.accumulate(buf[:, p:p + D] != 0x30, axis=1)
            sig[:, -1] = True
            keep[:, p:p + D] = sig
            trivial = False
        else:
            keep[:, p] = True
        p += D
    if sw:
        buf[:, p:p + sw] = np.frombuffer(suffix, np.uint8)
        keep[:, p:p + sw] = True
        p += sw
    buf[:, p] = 0x0A
    keep[:, p] = True
    if trivial:
        return buf.tobytes()
    return buf.ravel()[keep.ravel()].tobytes()


def _write_text(out, data: bytes) -> None:
    b = getattr(out, "buffer", None)          # text wrapper over binary
    if b is not None:
        out.flush()
        b.write(data)
        return
    try:
        out.write(data)
    except TypeError:                         # text-mode gzip/bz2/xz
        out.write(data.decode("ascii"))


def print_kmers(hi, lo, counts, k: int, out=None, acgt_order: bool = False):
    """Dump kmers as 'KMER\\tvalue' lines.

    With acgt_order=True each kmer is re-canonicalized so the reported
    strand is minimal in standard ACGT lexicographic order (printACGT;
    output order is then NOT sorted, matching the reference note in
    documentation/source/reference.rst:538-566)."""
    out = out or sys.stdout
    n = len(counts)
    B = 1 << 20
    for b in range(0, n, B):
        _write_text(out, format_kmer_lines(
            hi[b:b + B], lo[b:b + B], counts[b:b + B], k,
            acgt_order=acgt_order))


def report_histogram(hist: MerylHistogram, out=None):
    out = out or sys.stdout
    for v, o in zip(hist.values.tolist(), hist.occurrences.tolist()):
        out.write(f"{v}\t{o}\n")


def report_statistics(hist: MerylHistogram, k: int, out=None):
    out = out or sys.stdout
    n_universe = (1 << (2 * k))  # buildLowBitMask(2k)+1
    nd = hist.num_distinct()
    nt = hist.num_total()
    out.write(f"Number of {k}-mers that are:\n")
    out.write(f"  unique   {hist.num_unique():>20}  (exactly one instance of the kmer is in the input)\n")
    out.write(f"  distinct {nd:>20}  (non-redundant kmer sequences in the input)\n")
    out.write(f"  present  {nt:>20}  (...)\n")
    out.write(f"  missing  {n_universe - nd:>20}  (non-redundant kmer sequences not in the input)\n")
    out.write("\n")
    out.write("             number of   cumulative   cumulative     presence\n")
    out.write("              distinct     fraction     fraction   in dataset\n")
    out.write("frequency        kmers     distinct        total       (1e-6)\n")
    out.write("--------- ------------ ------------ ------------ ------------\n")
    s_distinct = 0
    s_total = 0
    for v, o in zip(hist.values.tolist(), hist.occurrences.tolist()):
        s_distinct += o
        s_total += o * v
        out.write("%9d %12d %12.4f %12.4f %12.6f\n" % (
            v, o,
            s_distinct / nd if nd else 0.0,
            s_total / nt if nt else 0.0,
            v / nt * 1e6 if nt else 0.0))


def report_ploidy(hist: MerylHistogram, out=None, err=None):
    out = out or sys.stdout
    err = err or sys.stderr
    hist.compute_ploidy_peaks()
    no = hist.get_noise_trough()
    cs = [hist.get_coverage(n) for n in (1, 2, 3, 4)]
    ps = [hist.get_depth(n) for n in (1, 2, 3, 4)]
    err.write("\n")
    err.write("Noise/genomic trough: %6.3f\n" % no)
    for c, p in zip(cs, ps):
        err.write("%4.2fx coverage peak:   %6.3f\n" % (c, p))
    if not (hasattr(out, "isatty") and out.isatty()):
        out.write("noise-trough\t%.3f\tploidy-peaks\t%.3f\t%.3f\t%.3f\t%.3f\n"
                  % (no, ps[0], ps[1], ps[2], ps[3]))
