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

import ctypes
import json
import os
import threading

import numpy as np

from . import _build
from . import kmer as km

MAGIC_INDEX = "merylTpuIndex.v01"
MAGIC_BUCKET = b"MTPUKMB1"
NUM_FILES = 64

# DBs (MerylDB.write) and buckets (MerylDBWriter.add_bucket) written by
# each path of _write_files, since the process began
WRITE_STATS = {"native": 0, "numpy": 0}
_stats_lock = threading.Lock()
_write_lib = None        # the native writer; False once it failed to build
# a DB of fewer entries is written on the calling thread: below it the
# threads' start costs about what they save (tools/ab_dbwrite.py --sweep)
THREADED_MIN = 1 << 15


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


def _bucket_flags(has_labels: bool, label_bits: int) -> int:
    """A bucket's flags word: bit 0 = labels present; bits 8..15 =
    stored label width in bits (0 means 64 for pre-width files)."""
    return 1 | ((label_bits & 0xFF) << 8) if has_labels else 0


def _native_writer():
    """The native writer (csrc/db_write.cpp), built at first use, or None
    when it cannot be built or MERYL_TPU_NO_NATIVE is set."""
    global _write_lib
    if os.environ.get("MERYL_TPU_NO_NATIVE"):
        return None
    if _write_lib is None:
        try:
            lib = _build.load("db_write", ".cpp")
        except (OSError, RuntimeError):
            _write_lib = False
        else:
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.mt_db_write.argtypes = [ctypes.c_char_p, i64, i64, p, p, p,
                                        i32, p, ctypes.c_uint64, i32, i32,
                                        ctypes.c_uint32, i32]
            lib.mt_db_write.restype = p
            lib.mt_db_info.argtypes = [p, p]
            lib.mt_db_info.restype = None
            lib.mt_db_finish.argtypes = [p, p, p]
            lib.mt_db_finish.restype = None
            _write_lib = lib
    return _write_lib or None


def _count_words(counts) -> np.ndarray:
    """counts as contiguous u32 or u64 words whose low 32 bits are the
    values np.uint32 casts them to (4- and 8-byte integers are viewed,
    not copied)."""
    counts = np.asarray(counts)
    dt = counts.dtype
    if dt.kind in "iu" and dt.isnative and dt.itemsize in (4, 8):
        return np.ascontiguousarray(counts).view(
            np.uint32 if dt.itemsize == 4 else np.uint64)
    return np.ascontiguousarray(counts, np.uint32)


def _write_files(path: str, ff, k: int, hi, lo, counts, labels,
                 label_bits: int):
    """Write bucket files into the directory `path`: with ff None all 64
    from sorted entries (split by 6-bit prefix), else every entry to
    bucket ff.  One native pass (csrc/db_write.cpp, from several threads
    for a DB of THREADED_MIN entries or more) or, where it is not built,
    numpy.  -> ((values, occurrences), statistics) of the counts as
    stored (u32)."""
    hi = np.ascontiguousarray(hi, dtype=np.uint64)
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    if labels is not None:
        labels = np.ascontiguousarray(labels, dtype=np.uint64)
    lib = _native_writer()
    with _stats_lock:
        WRITE_STATS["numpy" if lib is None else "native"] += 1
    if lib is None:
        return _write_numpy(path, ff, k, hi, lo, counts, labels, label_bits)
    return _write_native(lib, path, ff, k, hi, lo, _count_words(counts),
                         labels, label_bits)


def _write_numpy(path, ff, k, hi, lo, counts, labels, label_bits):
    """_write_files in numpy (what MERYL_TPU_NO_NATIVE selects)."""
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    if labels is not None:
        labels = labels & label_mask(label_bits)
    if ff is None:  # split by 6-bit prefix (monotonic in sorted order)
        pref = km.prefix6_from_hilo(hi, lo, k)
        bounds = np.searchsorted(pref, np.arange(NUM_FILES + 1,
                                                 dtype=np.uint32))
        parts = [(f, int(bounds[f]), int(bounds[f + 1]))
                 for f in range(NUM_FILES)]
    else:
        parts = [(ff, 0, len(lo))]
    for f, b, e in parts:
        MerylDB._write_bucket(os.path.join(path, bucket_name(f)), k,
                              hi[b:e], lo[b:e], counts[b:e],
                              labels[b:e] if labels is not None else None,
                              label_bits)
    return sparse_histogram(counts), compute_stats(counts)


def _write_native(lib, path, ff, k, hi, lo, counts, labels, label_bits):
    """_write_files in one call of the native writer, which releases the
    GIL; counts as _count_words gives them."""
    n = len(lo)
    if len(hi) != n or len(counts) != n or (
            labels is not None and len(labels) != n):
        raise ValueError(f"{path}: hi, lo, counts and labels differ in "
                         f"length ({len(hi)}, {n}, {len(counts)}, "
                         f"{None if labels is None else len(labels)})")
    threads = 1
    if ff is None and n >= THREADED_MIN:
        threads = min(len(os.sched_getaffinity(0)), NUM_FILES)
    h = lib.mt_db_write(
        os.fsencode(path), -1 if ff is None else int(ff), n, hi.ctypes.data,
        lo.ctypes.data, counts.ctypes.data, counts.itemsize,
        None if labels is None else labels.ctypes.data,
        int(label_mask(label_bits)),
        np.dtype(label_dtype(label_bits)).itemsize, int(k),
        _bucket_flags(labels is not None, label_bits), threads)
    if not h:
        raise MemoryError(f"{path}: the DB writer could not start")
    info = np.zeros(5, np.uint64)
    lib.mt_db_info(h, info.ctypes.data)
    err, failed, n_unique, n_total, n_hist = (int(x) for x in info)
    if err:
        lib.mt_db_finish(h, None, None)
        raise OSError(err, os.strerror(err),
                      os.path.join(path, bucket_name(failed))
                      if failed < NUM_FILES else path)
    vals = np.empty(n_hist, np.uint64)
    occ = np.empty(n_hist, np.uint64)
    lib.mt_db_finish(h, vals.ctypes.data, occ.ctypes.data)
    return (vals, occ), {"numUnique": n_unique, "numDistinct": n,
                         "numTotal": n_total}


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
        as in the reference's kmer::setLabelSize).  The bucket files,
        the histogram and the statistics come from one pass
        (_write_files); histogram= replaces its histogram.
        """
        if label_bits == 0:
            labels = None  # -l 0: a 0-wide label is identically 0
        os.makedirs(path, exist_ok=True)
        hist, stats = _write_files(path, None, k, hi, lo, counts, labels,
                                   label_bits)
        hvals, hocc = hist if histogram is None else histogram
        with open(os.path.join(path, "histogram.tsv"), "w") as f:
            for v, o in zip(hvals.tolist(), hocc.tolist()):
                f.write(f"{v}\t{o}\n")

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
        with open(p, "wb") as f:
            f.write(MAGIC_BUCKET)
            np.array([k, _bucket_flags(labels is not None, label_bits)],
                     dtype=np.uint32).tofile(f)
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
        if not 0 <= ff < NUM_FILES:
            raise ValueError(f"bucket {ff} out of 0..{NUM_FILES - 1}")
        if ff in self._written:
            raise ValueError(f"bucket {ff} written twice")
        self._written.add(ff)
        if self.label_bits == 0:
            labels = None  # -l 0: a 0-wide label is identically 0
        if labels is not None:
            self._has_labels = True
        (vals, occ), stats = _write_files(self.path, ff, self.k, hi, lo,
                                          counts, labels, self.label_bits)
        for v, o in zip(vals.tolist(), occ.tolist()):
            self._hist[v] = self._hist.get(v, 0) + o
        self._n_distinct += stats["numDistinct"]
        self._n_total += stats["numTotal"]
        self._n_unique += stats["numUnique"]

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
