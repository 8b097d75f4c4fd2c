"""meryl-lookup: compare sequences against k-mer databases (counterpart
of meryl_tpu/lookup_cli.py; same modes, options and output bytes).

Modes and output formats match the reference meryl-lookup
(meryl src/meryl-lookup/meryl-lookup.C:160-230, dump.C, existence.C,
include-exclude.C):
  -bed        BED record per kmer found in a DB
  -bed-runs   overlapping found kmers merged into one record
  -wig-count  wiggle: kmer multiplicity at each starting position
  -wig-depth  wiggle: #found kmers covering each position (first DB)
  -existence  per sequence: ident, nTotal, then per DB nKmers/nFound
  -include    copy sequences with >= 1 kmer in the (single) DB
  -exclude    copy sequences with no kmer in the (single) DB

Each kmer is tested in both orientations (forward and reverse
complement) so non-canonical databases work (dump.C:93-127).

The k-mers of a sequence come from the extraction kernel
(ops/extract_cuda.py) on the packed 2-bit wire and stay on the device;
the lookup tables answer them there, and only their values (or found
bits) cross to the host.  `-device cpu` runs everything on the CPU
(the kernel's plain version); the default is cuda.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import kmer as km
from . import resolve_device
from . import trace
from .io.sequence import iter_sequences
from .lookup import ExactLookup
from .ops import bacjoin as bj
from .ops import extract_cuda
from .reports import _write_text as _wt
from .reports import format_int_table

CHUNK = 1 << 21  # max positions per extraction launch
CHUNK_MIN = 1 << 12  # smallest extraction batch

USAGE = """usage: meryl-lookup <report-type> \\
         -sequence <input1.fasta> [<input2.fasta>] \\
         -output   <output1>      [<output2>] \\
         -mers     <input1.meryl> [<input2.meryl>] [...] [-estimate] \\
         -labels   <input1name>   [<input2name>]   [...]

  Compare kmers in input sequences against kmers in input meryl databases.

  Report types: -bed | -bed-runs | -wig-count | -wig-depth | -existence |
                -include | -exclude
  Options: -min N | -max N | -memory GB | -threads T | -10x | -estimate
           -device cpu|cuda (default cuda)
"""


class LookupGlobal:
    def __init__(self):
        self.mode = None
        self.seq1 = None
        self.seq2 = None
        self.out1 = None
        self.out2 = None
        self.dbs: list[str] = []
        self.labels: list[str] = []
        self.min_v = 0
        self.max_v = km.VALUE_MAX
        self.memory_gb = None
        self.estimate = False
        self.is10x = False
        self.device = "cuda"
        self.lookups: list[ExactLookup] = []


def parse_args(argv) -> LookupGlobal:
    g = LookupGlobal()
    i = 0
    modes = {"-bed": "bed", "-bed-runs": "bed-runs",
             "-wig-count": "wig-count", "-wig-depth": "wig-depth",
             "-existence": "existence", "-include": "include",
             "-exclude": "exclude"}
    while i < len(argv):
        a = argv[i]
        if a in modes:
            g.mode = modes[a]
        elif a == "-sequence":
            i += 1
            g.seq1 = argv[i]
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                g.seq2 = argv[i]
        elif a == "-mers":
            while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                g.dbs.append(argv[i])
        elif a == "-labels":
            while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                g.labels.append(argv[i])
        elif a == "-output":
            i += 1
            g.out1 = argv[i]
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                g.out2 = argv[i]
        elif a == "-min":
            i += 1
            g.min_v = int(argv[i])
        elif a == "-max":
            i += 1
            g.max_v = int(argv[i])
        elif a in ("-memory",):
            i += 1
            g.memory_gb = float(argv[i])
        elif a in ("-threads", "-loadthreads"):
            i += 1  # accepted for compatibility
        elif a == "-10x":
            g.is10x = True
        elif a == "-estimate":
            g.estimate = True
        elif a == "-device":
            i += 1
            g.device = argv[i]
        elif a in ("-V",):
            pass
        elif a in ("-help", "-h", "--help"):
            raise SystemExit(USAGE)
        else:
            raise SystemExit(f"meryl-lookup: unknown option '{a}'\n{USAGE}")
        i += 1
    return g


def load_tables(g: LookupGlobal, err=None):
    err = err or sys.stderr
    from .db import MerylDB
    total = 0
    with trace.span("lookup.table_load"):  # DB read, build, upload
        for p in g.dbs:
            L = ExactLookup(MerylDB.open(p), g.min_v, g.max_v,
                            device=g.device)
            g.lookups.append(L)
            total += L.estimate_memory_bytes()
    if g.estimate:
        err.write(f"Estimated memory usage: {total / 1e9:.3f} GB for "
                  f"{len(g.lookups)} database(s)\n")
        raise SystemExit(0)
    if g.memory_gb is not None and total > g.memory_gb * 1e9:
        raise SystemExit(
            f"meryl-lookup: tables need {total / 1e9:.3f} GB > "
            f"-memory {g.memory_gb} GB")


BULK_MIN = 1 << 16  # values_bulk's regimes from this many positions


def _extract_positions(codes: np.ndarray, k: int, device,
                       canonical: bool = False):
    """Per-position forward / reverse key words and validity, on
    `device`: one extraction launch per chunk of the packed 2-bit wire
    (a pow2 size between CHUNK_MIN and CHUNK, k - 1 positions of halo).

    canonical=True extracts min(fmer, rmer) once and returns it as both
    orientations: against a canonical database value(fmer) ==
    value(rmer) == value(canonical), so one query per position replaces
    two.  -> (fkey, rkey, valid)."""
    L = len(codes)
    npos = max(0, L - k + 1)
    size = max(CHUNK_MIN, min(CHUNK, 1 << int(max(L, 1) - 1).bit_length()))
    step = size - (k - 1)
    fparts, rparts, vparts = [], [], []
    pos = 0
    while pos < npos:
        end = min(pos + size, L)
        chunk = np.full(size, 255, np.uint8)
        chunk[:end - pos] = codes[pos:end]
        packed2, exc, n_real = km.pack_codes_2bit(chunk)
        p = torch.from_numpy(packed2.view(np.int32)).to(device)
        e = torch.from_numpy(exc).to(device)
        if canonical:
            fk, valid = extract_cuda.extract_kmers_packed(p, e, n_real, k,
                                                          "canonical")
            rk = fk
        else:
            fk, rk, valid = extract_cuda.extract_kmers_packed(p, e, n_real, k,
                                                              "both")
        nvalid = min(step, npos - pos)
        fparts.append(fk[:nvalid])
        rparts.append(rk[:nvalid])
        vparts.append(valid[:nvalid])
        pos += nvalid
    fkey = torch.cat(fparts)
    rkey = fkey if canonical else torch.cat(rparts)
    return fkey, rkey, torch.cat(vparts)


def _per_position_values(lookups, codes: np.ndarray, k: int,
                         exists_only: bool = False,
                         allow_canonical: bool = True):
    """For each DB: (fvals, rvals) uint32 arrays over kmer start
    positions 0..len-k, plus the validity mask.

    Below BULK_MIN positions one binary search answers them; from there
    values_bulk picks its regime.  exists_only callers get 0/1.

    allow_canonical=False disables the single-orientation shortcut for
    callers that need the reference's raw value(f)/value(r) pair (wig-
    count sums them, dump.C:154-161: against a canonical DB the raw
    pair is C for non-palindromes, while the shortcut's fv == rv would
    double to 2C)."""
    L = len(codes)
    npos = max(0, L - k + 1)
    if npos == 0:
        z = [np.zeros(0, np.uint32) for _ in lookups]
        return z, list(z), np.zeros(0, bool)
    canonical = allow_canonical and all(
        Lk.db.mode == "canonical" for Lk in lookups)
    fkey, rkey, vmask = _extract_positions(codes, k, lookups[0].device,
                                           canonical)
    nf, nr = [], []
    for Lk in lookups:
        if npos >= BULK_MIN:
            fv = Lk.values_bulk(fkey, vmask, exists_only)
            rv = fv if canonical else Lk.values_bulk(rkey, vmask, exists_only)
        else:
            fv = bj.download_u32(Lk.values_batch(fkey, vmask))
            rv = fv if canonical else \
                bj.download_u32(Lk.values_batch(rkey, vmask))
            if exists_only:
                fv = (fv > 0).astype(np.uint32)
                rv = (rv > 0).astype(np.uint32)
        nf.append(fv)
        nr.append(rv)
    return nf, nr, vmask.cpu().numpy()


def _is_palindrome(codes: np.ndarray, k: int) -> np.ndarray:
    """Per-position: is the kmer its own reverse complement (k even
    only).  Vectorized over sliding windows in bounded blocks."""
    L = len(codes)
    npos = max(0, L - k + 1)
    out = np.zeros(npos, bool)
    if k % 2 == 1 or npos == 0:
        return out
    comp = np.array([2, 3, 0, 1, *([255] * 252)], np.uint8)
    ccodes = comp[codes]
    BLOCK = 1 << 20
    for b in range(0, npos, BLOCK):
        e = min(b + BLOCK, npos)
        win = np.lib.stride_tricks.sliding_window_view(
            codes[b:e + k - 1], k)
        # fmer == rmer  <=>  window equals complement of its reversal
        cwin = np.lib.stride_tricks.sliding_window_view(
            ccodes[b:e + k - 1], k)[:, ::-1]
        out[b:e] = (win <= 3).all(axis=1) & (win == cwin).all(axis=1)
    return out


def _interleave_lines(blocks, keys) -> bytes:
    """Lines of several text blocks merged in ascending key order (ties
    keep block order): blocks[i] holds len(keys[i]) newline-ended
    lines."""
    bufs = [np.frombuffer(b, np.uint8) for b in blocks]
    ends = [np.flatnonzero(b == 0x0A) for b in bufs]
    base = np.cumsum([0] + [len(b) for b in bufs])
    starts = np.concatenate([np.concatenate([[0], e[:-1] + 1]) + o
                             for e, o in zip(ends, base) if len(e)]
                            or [np.zeros(0, np.int64)])
    lens = np.concatenate([np.diff(np.concatenate([[-1], e]))
                           for e in ends if len(e)]
                          or [np.zeros(0, np.int64)])
    order = np.argsort(np.concatenate(keys), kind="stable")
    starts, lens = starts[order], lens[order]
    total = int(lens.sum())
    dst = np.repeat(np.cumsum(lens) - lens, lens)
    idx = np.arange(total) - dst + np.repeat(starts, lens)
    return np.concatenate(bufs)[idx].tobytes() if total else b""


def cmd_dump(g: LookupGlobal, out):
    """-bed / -bed-runs / -wig-count / -wig-depth."""
    k = g.lookups[0].k
    use_labels = len(g.labels) > 0
    for name, seq, _ in iter_sequences(g.seq1):
        codes = km.CODE_LUT[np.frombuffer(seq, np.uint8)]
        nf, nr, vmask = _per_position_values(
            g.lookups, codes, k, exists_only=(g.mode != "wig-count"),
            allow_canonical=(g.mode != "wig-count"))
        npos = len(vmask)

        if g.mode in ("bed", "bed-runs"):
            nd = len(g.lookups)
            exist = np.zeros((nd, npos), bool)
            for d in range(nd):
                found = ((nf[d] > 0) | (nr[d] > 0)) & vmask
                if use_labels:
                    exist[d] |= found
                else:
                    exist[0] |= found  # dedupe across DBs (dump.C:128-133)
            single = nd == 1 or not use_labels
            prefix = f"{name}\t".encode()

            def label(d):
                return (f"\t{g.labels[d]}" if d < len(g.labels)
                        else "").encode()
            if g.mode == "bed":
                if single:
                    ps = np.flatnonzero(exist[0])
                    lab = f"\t{g.labels[0]}" if use_labels else ""
                    _wt(out, format_int_table(
                        [ps, ps + k], prefix=prefix, suffix=lab.encode()))
                else:
                    # labelled DBs interleave by position then db, the
                    # reference's emit order
                    blocks, keys = [], []
                    for d in range(nd):
                        ps = np.flatnonzero(exist[d])
                        blocks.append(format_int_table(
                            [ps, ps + k], prefix=prefix, suffix=label(d)))
                        keys.append(ps * nd + d)
                    _wt(out, _interleave_lines(blocks, keys))
            else:
                # a run's end is written as its first unset position + k,
                # as the reference does (dump.C:346-355); labelled DBs
                # emit in the order of that position, then db
                blocks, keys = [], []
                for d in range(1 if single else nd):
                    pad = np.zeros(npos + 2, np.int8)
                    pad[1:-1] = exist[d]
                    d2 = np.diff(pad)
                    starts = np.flatnonzero(d2 == 1)
                    ends = np.flatnonzero(d2 == -1)
                    lab = f"\t{g.labels[0]}".encode() if single and \
                        use_labels else (b"" if single else label(d))
                    blocks.append(format_int_table(
                        [starts, ends + k], prefix=prefix, suffix=lab))
                    keys.append(ends * nd + d)
                _wt(out, blocks[0] if single else
                    _interleave_lines(blocks, keys))

        elif g.mode == "wig-count":
            pal = _is_palindrome(codes, k)
            count = np.zeros(npos, np.uint64)
            for d in range(len(g.lookups)):
                fv = nf[d].astype(np.uint64)
                rv = nr[d].astype(np.uint64)
                count += np.where(pal, fv, fv + rv) * vmask
            out.write(f"variableStep chrom={name}\n")
            ps = np.flatnonzero(count)
            _wt(out, format_int_table([ps + 1, count[ps]]))

        elif g.mode == "wig-depth":
            found = ((nf[0] > 0) | (nr[0] > 0)) & vmask
            w = np.flatnonzero(found)
            maxp = int(w[-1]) + k if len(w) else 0
            n = maxp + k + 1
            diff = np.bincount(w, minlength=n) - \
                np.bincount(w + k, minlength=n)
            depth = np.cumsum(diff)
            out.write(f"variableStep chrom={name}\n")
            ps = np.flatnonzero(depth[:maxp] > 0)
            _wt(out, format_int_table([ps + 1, depth[ps]]))


def cmd_existence(g: LookupGlobal, out):
    """One bulk lookup per ~2M bases of sequences."""
    k = g.lookups[0].k
    it = iter_sequences(g.seq1)
    done = False
    while not done:
        with trace.span("lookup.parse"):
            batch = []
            nb = 0
            while nb < FILTER_BATCH_BASES:
                r = next(it, None)
                if r is None:
                    done = True
                    break
                batch.append(r)
                nb += len(r[1])
            if not batch:
                break
            codes = [km.CODE_LUT[np.frombuffer(r[1], np.uint8)]
                     for r in batch]
            buf, offs, lens = km.concat_codes_with_breakers(codes)
        with trace.span("lookup.query"):
            nf, nr, vmask = _per_position_values(g.lookups, buf, k,
                                                 exists_only=True)
        # the prefix sums in a span of their own: host work after many
        # torch operations, which a trace's gap labels should still name
        with trace.span("lookup.query"):
            spans = np.maximum(0, lens - k + 1)
            cv = _prefix_counts(vmask, len(buf))
            ntotal = cv[offs + spans] - cv[offs]
            nfound = []
            for d in range(len(g.lookups)):
                f = ((nf[d] > 0) | (nr[d] > 0)) & vmask
                cf = _prefix_counts(f, len(buf))
                nfound.append(cf[offs + spans] - cf[offs])
        with trace.span("lookup.output"):
            for i, (name, _seq, _q) in enumerate(batch):
                line = [name, str(int(ntotal[i]))]
                for d, L in enumerate(g.lookups):
                    line += [str(L.n_kmers()), str(int(nfound[d][i]))]
                out.write("\t".join(line) + "\n")


def _prefix_counts(mask: np.ndarray, n: int) -> np.ndarray:
    """(n + 1,) prefix sums of a per-position mask over a buffer of n
    codes: the positions past the mask (the last k - 1, which start no
    window) add nothing, so a short read at the end of a batch counts 0
    (the reference indexes past its prefix sums there and raises)."""
    cs = np.zeros(n + 1, np.int64)
    np.cumsum(mask, out=cs[1:len(mask) + 1])
    cs[len(mask) + 1:] = cs[len(mask)]
    return cs


def _write_seq(f, name, seq: bytes, qual, nfound: int):
    ident = f"{name} nKmers={nfound}"
    # qual=None means FASTA input; an empty qual (zero-length read from
    # FASTQ) must still write a FASTQ record or the output mixes formats
    if qual is not None:
        f.write(f"@{ident}\n{seq.decode()}\n+\n{qual.decode()}\n")
    else:
        f.write(f">{ident}\n{seq.decode()}\n")


FILTER_BATCH_BASES = 1 << 21


def _batch_found(L, codes_list, k: int):
    """One bulk lookup over many reads: their codes concatenated with
    0xFF breakers (which invalidate cross-read windows), every position
    queried at once.  -> (found mask, per-read position starts, per-read
    position span lengths)."""
    buf, offs, lens = km.concat_codes_with_breakers(codes_list)
    nf, nr, vmask = _per_position_values([L], buf, k, exists_only=True)
    found = np.zeros(len(buf), bool)
    found[:len(vmask)] = ((nf[0] > 0) | (nr[0] > 0)) & vmask
    spans = np.maximum(0, lens - k + 1)
    return found, offs, spans


def cmd_filter(g: LookupGlobal, out1, out2, err=None):
    err = err or sys.stderr
    k = g.lookups[0].k
    L = g.lookups[0]
    it1 = iter_sequences(g.seq1, want_quals=True)
    it2 = iter_sequences(g.seq2, want_quals=True) if g.seq2 else None
    n_total = 0
    n_found = 0
    done = False
    while not done:
        # gather a batch of read (pairs)
        b1, b2 = [], []
        nb = 0
        while nb < FILTER_BATCH_BASES:
            r1 = next(it1, None)
            r2 = next(it2, None) if it2 else None
            if r1 is None and r2 is None:
                done = True
                break
            b1.append(r1)
            b2.append(r2)
            nb += (len(r1[1]) if r1 else 0) + (len(r2[1]) if r2 else 0)
        if not b1:
            break
        recs = []                     # (pair index, mate index)
        codes = []
        for i in range(len(b1)):
            for idx, r in enumerate((b1[i], b2[i])):
                if r is not None:
                    recs.append((i, idx))
                    codes.append(km.CODE_LUT[np.frombuffer(r[1],
                                                           np.uint8)])
        found, offs, spans = _batch_found(L, codes, k)
        if g.is10x:
            for j, (_, idx) in enumerate(recs):
                if idx == 0:          # skip 10x barcode kmers
                    found[offs[j]:offs[j] + min(23, int(spans[j]))] = \
                        False
        cs = _prefix_counts(found, len(found))
        per_read = cs[offs + spans] - cs[offs]
        pair_nf = np.zeros(len(b1), np.int64)
        for j, (i, _) in enumerate(recs):
            pair_nf[i] += per_read[j]
        for i in range(len(b1)):
            n_total += 1
            nfound = int(pair_nf[i])
            keep = (nfound > 0) if g.mode == "include" else (nfound == 0)
            if keep:
                n_found += 1
                if b1[i] is not None and out1 is not None:
                    _write_seq(out1, b1[i][0], b1[i][1], b1[i][2],
                               nfound)
                if b2[i] is not None and out2 is not None:
                    _write_seq(out2, b2[i][0], b2[i][1], b2[i][2],
                               nfound)
    err.write(f"\nIncluding {n_found} reads (or read pairs) "
              f"out of {n_total}.\n")


def main(argv=None) -> int:
    trace.reset()
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        sys.stderr.write(USAGE)
        return 1
    try:
        g = parse_args(argv)
    except SystemExit as e:
        if e.code == 0 or e.code is None:
            return 0
        sys.stderr.write(str(e.code) + "\n" if isinstance(e.code, str) else "")
        return 1
    if g.mode is None or g.seq1 is None or not g.dbs:
        sys.stderr.write(USAGE)
        return 1
    try:
        g.device = resolve_device(g.device)
    except (RuntimeError, ValueError) as e:
        sys.stderr.write(f"meryl-lookup: {e}\n")
        return 1
    load_tables(g)

    def open_out(p):
        if p is None or p == "-":
            return sys.stdout
        from .io.sequence import open_output
        return open_output(p)

    o1 = open_out(g.out1)
    o2 = open_out(g.out2) if g.out2 else None
    try:
        if g.mode in ("bed", "bed-runs", "wig-count", "wig-depth"):
            cmd_dump(g, o1)
        elif g.mode == "existence":
            cmd_existence(g, o1)
        else:
            cmd_filter(g, o1, o2)
    finally:
        if o1 is not sys.stdout:
            o1.close()
        if o2:
            o2.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
