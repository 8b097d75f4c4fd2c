"""The on-disk k-mer database.

Our own TPU-era format with the same *capabilities* as the reference
meryl DB (64-way prefix-partitioned, sorted, value histogram and
statistics stored in the index so `histogram`/`statistics`/threshold
initialization never rescan kmers  — reference
documentation/source/reference.rst:71-88 and
meryl src/meryl/merylOp-histogram.C:35-42).  Parity with the
reference is defined as decoded kmer/count equality, not byte identity
(the reference encoder lives in the absent meryl-utility submodule).

Layout of a database directory `<db>/`:
  merylIndex.json   magic, k, flags, numFiles=64, statistics
  histogram.tsv     "value<TAB>occurrences" lines, ascending value
  0x00.kmb .. 0x3f.kmb   one binary bucket per 6-bit kmer prefix

Bucket binary layout (little-endian):
  8s   magic  b"MTPUKMB1"
  u32  k
  u32  flags    (bit 0: labels present)
  u64  n
  u64[n] lo     (kmer bits  [0,64) )
  u64[n] hi     (kmer bits [64,128))
  u32[n] count
  u64[n] label  (only when flags bit 0 is set; meryl2 64-bit labels,
                 reference kmlabl: SURVEY.md §2.3)

Kmers within a bucket are sorted ascending in the A=00,C=01,T=10,G=11
integer order; one entry per kmer with value > 0 (multiset DBs may
repeat kmers — reference documentation/source/reference.rst:49-53,89-91).
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import kmer as km

MAGIC_INDEX = "merylTpuIndex.v01"
MAGIC_BUCKET = b"MTPUKMB1"
NUM_FILES = 64


def bucket_name(ff: int) -> str:
    return f"0x{ff:02x}.kmb"


def is_meryl_db(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "merylIndex.json"))


def compute_stats(counts: np.ndarray) -> dict:
    """unique/distinct/total from a full count array.

    For multiset DBs these count ENTRIES (instances), matching the
    reference, whose writer accumulates statistics per stored entry."""
    counts = np.asarray(counts)
    n_distinct = int(len(counts))
    n_total = int(counts.astype(np.uint64).sum())
    n_unique = int((counts == 1).sum())
    return {
        "numUnique": n_unique,
        "numDistinct": n_distinct,
        "numTotal": n_total,
    }


def label_dtype(bits: int):
    """Smallest unsigned dtype holding a `bits`-wide label (meryl2 -l:
    width selection affects DB size)."""
    if bits <= 8:
        return np.uint8
    if bits <= 16:
        return np.uint16
    if bits <= 32:
        return np.uint32
    return np.uint64


def label_mask(bits: int) -> np.uint64:
    if bits >= 64:
        return np.uint64(0xFFFFFFFFFFFFFFFF)
    return np.uint64((1 << bits) - 1)


def sparse_histogram(counts: np.ndarray):
    if len(counts) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    vals, occ = np.unique(counts, return_counts=True)
    return vals.astype(np.uint64), occ.astype(np.uint64)


class MerylDB:
    """Reader/writer for the 64-bucket kmer database."""

    def __init__(self, path: str, meta: dict):
        self.path = path
        self.meta = meta

    # ---------- read ----------

    @classmethod
    def open(cls, path: str) -> "MerylDB":
        with open(os.path.join(path, "merylIndex.json")) as f:
            meta = json.load(f)
        if meta.get("magic") != MAGIC_INDEX:
            raise ValueError(f"{path}: not a meryl-tpu database")
        return cls(path, meta)

    @property
    def k(self) -> int:
        return int(self.meta["k"])

    @property
    def multiset(self) -> bool:
        return bool(self.meta.get("multiset", False))

    @property
    def mode(self):
        """'canonical' / 'forward' / 'reverse' (None on DBs written
        before the field existed — callers must treat None as
        not-canonical)."""
        return self.meta.get("mode")

    def stats(self) -> dict:
        return {
            "numUnique": int(self.meta["numUnique"]),
            "numDistinct": int(self.meta["numDistinct"]),
            "numTotal": int(self.meta["numTotal"]),
        }

    def histogram(self):
        """(values, occurrences) ascending, from the stored histogram."""
        path = os.path.join(self.path, "histogram.tsv")
        vals, occ = [], []
        with open(path) as f:
            for line in f:
                v, o = line.split()
                vals.append(int(v))
                occ.append(int(o))
        return np.array(vals, np.uint64), np.array(occ, np.uint64)

    def load_bucket(self, ff: int):
        """-> (hi, lo, counts) numpy arrays for 6-bit prefix ff."""
        hi, lo, counts, _ = self.load_bucket_labels(ff)
        return hi, lo, counts

    def load_bucket_labels(self, ff: int):
        """-> (hi, lo, counts, labels-or-None) for 6-bit prefix ff."""
        p = os.path.join(self.path, bucket_name(ff))
        with open(p, "rb") as f:
            magic = f.read(8)
            if magic != MAGIC_BUCKET:
                raise ValueError(f"{p}: bad bucket magic")
            hdr = np.fromfile(f, dtype=np.uint32, count=2)
            if int(hdr[0]) != self.k:
                raise ValueError(f"{p}: k mismatch")
            n = int(np.fromfile(f, dtype=np.uint64, count=1)[0])
            lo = np.fromfile(f, dtype=np.uint64, count=n)
            hi = np.fromfile(f, dtype=np.uint64, count=n)
            counts = np.fromfile(f, dtype=np.uint32, count=n)
            labels = None
            if int(hdr[1]) & 1:
                bits = (int(hdr[1]) >> 8) & 0xFF or 64
                labels = np.fromfile(f, dtype=label_dtype(bits),
                                     count=n).astype(np.uint64)
        return hi, lo, counts, labels

    def load_all(self):
        his, los, cts = [], [], []
        for ff in range(NUM_FILES):
            hi, lo, c = self.load_bucket(ff)
            his.append(hi)
            los.append(lo)
            cts.append(c)
        return np.concatenate(his), np.concatenate(los), np.concatenate(cts)

    # ---------- write ----------

    @classmethod
    def write(cls, path: str, k: int, hi, lo, counts, *,
              mode: str = "canonical", hpc: bool = False,
              multiset: bool = False, histogram=None,
              labels=None, label_bits: int = 64) -> "MerylDB":
        """Write a full database from sorted (hi, lo, counts) arrays.

        Arrays must be sorted ascending by (hi, lo); counts > 0.
        label_bits (meryl2 -l) selects the stored label width: labels
        are masked to that many bits and packed into the smallest
        integer type that holds them (width selection affects DB size,
        as in the reference's kmer::setLabelSize).
        """
        hi = np.ascontiguousarray(hi, dtype=np.uint64)
        lo = np.ascontiguousarray(lo, dtype=np.uint64)
        counts = np.ascontiguousarray(counts, dtype=np.uint32)
        if label_bits == 0:
            labels = None  # -l 0: a 0-wide label is identically 0
        if labels is not None:
            labels = np.ascontiguousarray(labels, dtype=np.uint64)
            labels = labels & label_mask(label_bits)
        os.makedirs(path, exist_ok=True)

        # split by 6-bit prefix (monotonic in sorted order)
        pref = km.prefix6_from_hilo(hi, lo, k)
        bounds = np.searchsorted(pref, np.arange(NUM_FILES + 1, dtype=np.uint32))
        for ff in range(NUM_FILES):
            b, e = int(bounds[ff]), int(bounds[ff + 1])
            cls._write_bucket(os.path.join(path, bucket_name(ff)), k,
                              hi[b:e], lo[b:e], counts[b:e],
                              labels[b:e] if labels is not None else None,
                              label_bits)

        if histogram is None:
            hvals, hocc = sparse_histogram(counts)
        else:
            hvals, hocc = histogram
        with open(os.path.join(path, "histogram.tsv"), "w") as f:
            for v, o in zip(hvals.tolist(), hocc.tolist()):
                f.write(f"{v}\t{o}\n")

        stats = compute_stats(counts)
        meta = {
            "magic": MAGIC_INDEX,
            "k": int(k),
            "numFiles": NUM_FILES,
            "ordering": "ACTG",
            "mode": mode,
            "hpc": bool(hpc),
            "multiset": bool(multiset),
            **({"labelBits": int(label_bits)} if labels is not None
               else {}),
            **stats,
        }
        with open(os.path.join(path, "merylIndex.json"), "w") as f:
            json.dump(meta, f, indent=1)
        return cls(path, meta)

    @staticmethod
    def _write_bucket(p: str, k: int, hi, lo, counts, labels=None,
                      label_bits: int = 64):
        # flags word: bit 0 = labels present; bits 8..15 = stored label
        # width in bits (0 means 64 for pre-width files)
        flags = 0
        if labels is not None:
            flags = 1 | ((label_bits & 0xFF) << 8)
        with open(p, "wb") as f:
            f.write(MAGIC_BUCKET)
            np.array([k, flags], dtype=np.uint32).tofile(f)
            np.array([len(lo)], dtype=np.uint64).tofile(f)
            np.ascontiguousarray(lo, np.uint64).tofile(f)
            np.ascontiguousarray(hi, np.uint64).tofile(f)
            np.ascontiguousarray(counts, np.uint32).tofile(f)
            if labels is not None:
                np.ascontiguousarray(labels, label_dtype(label_bits)) \
                    .tofile(f)

    def bucket_path(self, ff: int) -> str:
        return os.path.join(self.path, bucket_name(ff))

    def dump_index(self) -> str:
        """Human-readable index report (reference `dumpIndex` debug tool)."""
        lines = [f"{k}: {v}" for k, v in self.meta.items()]
        return "\n".join(lines)


def stream_sorted_parts(path: str, k: int, parts, *,
                        mode: str = "canonical", hpc: bool = False,
                        multiset: bool = False) -> "MerylDB":
    """Write a DB from an ITERATOR of sorted (hi, lo, counts) pieces in
    ascending global kmer order (each piece internally sorted, pieces
    non-overlapping and ordered).  Buckets are written as soon as their
    6-bit prefix range is complete, so host peak memory is ~one piece
    plus the straddle buffer — never the whole kmer set.  Used by the
    sharded/multi-host assembly paths (their owner ranges may straddle
    a 64-file boundary when ownership uses > 6 prefix bits)."""
    w = MerylDBWriter(path, k, mode=mode, hpc=hpc, multiset=multiset)
    cur_ff = 0
    buf = []  # pieces belonging to cur_ff and beyond

    def flush_through(ff_end):
        """Write complete buckets cur_ff..ff_end-1 from buf."""
        nonlocal cur_ff, buf
        if not buf:
            hi = lo = np.zeros(0, np.uint64)
            c = np.zeros(0, np.uint32)
        else:
            hi = np.concatenate([b[0] for b in buf])
            lo = np.concatenate([b[1] for b in buf])
            c = np.concatenate([b[2] for b in buf])
        pref = km.prefix6_from_hilo(hi, lo, k)
        for ff in range(cur_ff, ff_end):
            m = pref == ff
            w.add_bucket(ff, hi[m], lo[m], c[m])
        keep = pref >= ff_end
        buf = [(hi[keep], lo[keep], c[keep])] if keep.any() else []
        cur_ff = ff_end

    for hi, lo, c in parts:
        if len(c):
            first = int(km.prefix6_from_hilo(hi[:1], lo[:1], k)[0])
            if first > cur_ff:
                flush_through(first)
            buf.append((np.asarray(hi, np.uint64),
                        np.asarray(lo, np.uint64),
                        np.asarray(c, np.uint32)))
    flush_through(NUM_FILES)
    return w.finalize()


class MerylDBWriter:
    """Incremental bucket-at-a-time DB writer (the merge phase emits one
    6-bit-prefix bucket at a time, mirroring the reference's per-slice
    stream writers, meryl src/meryl/merylOp-nextMer.C:154-158)."""

    def __init__(self, path: str, k: int, *, mode: str = "canonical",
                 hpc: bool = False, multiset: bool = False,
                 label_bits: int = 64):
        self.path = path
        self.k = int(k)
        self.mode = mode
        self.hpc = hpc
        self.multiset = multiset
        self.label_bits = int(label_bits)
        self._has_labels = False
        self._written = set()
        self._hist: dict[int, int] = {}
        self._n_distinct = 0
        self._n_total = 0
        self._n_unique = 0
        os.makedirs(path, exist_ok=True)

    def add_bucket(self, ff: int, hi, lo, counts, labels=None):
        if ff in self._written:
            raise ValueError(f"bucket {ff} written twice")
        self._written.add(ff)
        counts = np.ascontiguousarray(counts, dtype=np.uint32)
        if self.label_bits == 0:
            labels = None  # -l 0: a 0-wide label is identically 0
        if labels is not None:
            labels = np.ascontiguousarray(labels, np.uint64) & \
                label_mask(self.label_bits)
            self._has_labels = True
        MerylDB._write_bucket(os.path.join(self.path, bucket_name(ff)),
                              self.k, hi, lo, counts, labels,
                              self.label_bits)
        vals, occ = sparse_histogram(counts)
        for v, o in zip(vals.tolist(), occ.tolist()):
            self._hist[v] = self._hist.get(v, 0) + o
        self._n_distinct += len(counts)
        self._n_total += int(counts.astype(np.uint64).sum())
        self._n_unique += int((counts == 1).sum())

    def finalize(self) -> "MerylDB":
        for ff in range(NUM_FILES):
            if ff not in self._written:
                z = np.zeros(0, np.uint64)
                self.add_bucket(ff, z, z, np.zeros(0, np.uint32))
        with open(os.path.join(self.path, "histogram.tsv"), "w") as f:
            for v in sorted(self._hist):
                f.write(f"{v}\t{self._hist[v]}\n")
        meta = {
            "magic": MAGIC_INDEX,
            "k": self.k,
            "numFiles": NUM_FILES,
            "ordering": "ACTG",
            "mode": self.mode,
            "hpc": bool(self.hpc),
            "multiset": bool(self.multiset),
            **({"labelBits": self.label_bits} if self._has_labels
               else {}),
            "numUnique": self._n_unique,
            "numDistinct": self._n_distinct,
            "numTotal": self._n_total,
        }
        with open(os.path.join(self.path, "merylIndex.json"), "w") as f:
            json.dump(meta, f, indent=1)
        return MerylDB(self.path, meta)
