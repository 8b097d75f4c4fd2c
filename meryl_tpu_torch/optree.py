"""The action tree: nodes, inputs, and the bucket-at-a-time evaluator
(counterpart of meryl_tpu/optree.py, which imports jax and so cannot be
imported where JAX is absent).

Every node maps a group of 6-bit-prefix buckets' sorted unique (kmer,
value) arrays to new arrays through one batched device call
(ops/setops.py).  Buckets are processed in ascending prefix order, so
printed output is globally sorted.  DB reading and writing, the
reports and the histogram are the port's copies of meryl_tpu's
JAX-free host modules.
"""

from __future__ import annotations

import ctypes
import os
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from . import _build
from . import kmer as km
from . import trace
from .db import NUM_FILES, MerylDB, MerylDBWriter
from .ops import multiword as mw
from .ops import rowsort, setops

COUNT_OPS = ("count", "count-forward", "count-reverse")
REPORT_OPS = ("histogram", "statistics", "ploidy")
NEEDS_THRESHOLD = ("less-than", "greater-than", "at-least", "at-most",
                   "equal-to", "not-equal-to")
NEEDS_CONSTANT = ("increase", "decrease", "multiply", "divide",
                  "divide-round", "modulo")

# device calls of eval_buckets since the last reset (reset with
# reset_stats()): merge dispatches, the row-batched ones among them,
# their rows and padded row slots, and input entries merged; and the
# evaluator's packs by path (the native pass of csrc/rowpack_host.cpp,
# or numpy)
STATS = {}


def reset_stats() -> None:
    STATS.update(dispatches=0, row_dispatches=0, rows=0, row_slots=0,
                 entries=0, packs_native=0, packs_numpy=0)


reset_stats()

_rowpack_lib = None     # the native pass; False once it failed to build
# slots below which the native pass writes from the calling thread alone
PACK_THREADED_MIN = 1 << 16
# threads of the native pass above that: on an H100 host's 8 cores four
# pack a 1-4 M-entry group fastest, and eight lose to them
# (tools/ab_rowpack.py)
PACK_THREADS = 4


def _native_rowpack():
    """The native row pack (csrc/rowpack_host.cpp), built at first use,
    or None when it cannot be built or MERYL_TPU_NO_NATIVE is set."""
    global _rowpack_lib
    if os.environ.get("MERYL_TPU_NO_NATIVE"):
        return None
    if _rowpack_lib is None:
        try:
            lib = _build.load("rowpack_host", ".cpp")
        except (OSError, RuntimeError):
            _rowpack_lib = False
        else:
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.mt_rowpack_bounds.argtypes = [i32, p, p, p, p, p, i64, p]
            lib.mt_rowpack_bounds.restype = i64
            lib.mt_rowpack_fill.argtypes = [i32, p, p, p, p, p, i64, i64,
                                            i32, i32, i64, i64, p, p, p,
                                            i32]
            lib.mt_rowpack_fill.restype = None
            _rowpack_lib = lib
    return _rowpack_lib or None


def pack_threads(slots: int) -> int:
    """Threads of the native pack of `slots` slots: one below
    PACK_THREADED_MIN, else PACK_THREADS or the process's cores if
    fewer."""
    if slots < PACK_THREADED_MIN:
        return 1
    return min(PACK_THREADS, len(os.sched_getaffinity(0)))


class _NativePack:
    """One pack's inputs as the native pass reads them: contiguous u64
    (hi, lo) and u32 or int64 counts (other count types cast to int64,
    as numpy's assignment casts them), and arrays of their addresses."""

    def __init__(self, lib, ins):
        self.lib = lib
        self.m = len(ins)
        self._keep = []
        his, los, cts, nbytes, lens = [], [], [], [], []
        for hi, lo, c in ins:
            hi = np.ascontiguousarray(hi, np.uint64)
            lo = np.ascontiguousarray(lo, np.uint64)
            c = np.asarray(c)
            if c.dtype not in (np.uint32, np.int64, np.uint64):
                c = c.astype(np.int64)
            c = np.ascontiguousarray(c)
            if not len(hi) == len(lo) == len(c):
                raise ValueError(f"input of {len(hi)} hi, {len(lo)} lo and "
                                 f"{len(c)} counts")
            self._keep += [hi, lo, c]
            his.append(hi.ctypes.data)
            los.append(lo.ctypes.data)
            cts.append(c.ctypes.data)
            nbytes.append(c.itemsize)
            lens.append(len(c))
        self.his = np.array(his, np.uintp)
        self.los = np.array(los, np.uintp)
        self.counts = np.array(cts, np.uintp)
        self.count_bytes = np.array(nbytes, np.int32)
        self.lens = np.array(lens, np.int64)

    def bounds(self, cut_hi, cut_lo, R: int):
        """-> (m, R+1) row bounds at the R-1 cuts, the fullest row's
        occupancy."""
        cut_hi = np.ascontiguousarray(cut_hi, np.uint64)
        cut_lo = np.ascontiguousarray(cut_lo, np.uint64)
        b = np.empty((self.m, R + 1), np.int64)
        occ = self.lib.mt_rowpack_bounds(
            self.m, self.his.ctypes.data, self.los.ctypes.data,
            self.lens.ctypes.data, cut_hi.ctypes.data, cut_lo.ctypes.data,
            R, b.ctypes.data)
        return b, occ

    def fill(self, bounds, R: int, L: int, m: int, k: int):
        """-> (R, L) keys, values, ids, every slot written once."""
        bounds = np.ascontiguousarray(bounds, np.int64)
        sent = mw.sentinel_words(k)
        keys = np.empty((R, L) + (() if len(sent) == 1 else (2,)), np.int64)
        values = np.empty((R, L), np.int64)
        ids = np.empty((R, L), np.int32)
        self.lib.mt_rowpack_fill(
            self.m, self.his.ctypes.data, self.los.ctypes.data,
            self.counts.ctypes.data, self.count_bytes.ctypes.data,
            bounds.ctypes.data, R, L, m, len(sent), sent[0], sent[-1],
            keys.ctypes.data, values.ctypes.data, ids.ctypes.data,
            pack_threads(R * L))
        STATS["packs_native"] += 1
        return keys, values, ids


@dataclass
class DBInput:
    path: str
    db: MerylDB = None

    def open(self):
        if self.db is None:
            self.db = MerylDB.open(self.path)
        return self.db


@dataclass
class SeqInput:
    path: str


@dataclass
class OpNode:
    op: str = "nothing"
    inputs: list = field(default_factory=list)  # DBInput | SeqInput | OpNode
    threshold: int | None = None
    frac_distinct: float | None = None
    word_frequency: float | None = None
    output_path: str | None = None
    print_path: str | None = None   # "-" = stdout
    print_acgt: bool = False
    expected_kmers: int | None = None
    count_suffix: str | None = None
    segment: tuple[int, int] | None = None

    def is_counting(self) -> bool:
        return self.op in COUNT_OPS

    def describe(self, depth: int = 0, out=None) -> None:
        """Tree printout."""
        out = out or sys.stderr
        pad = "  " * depth
        extra = ""
        if self.threshold is not None:
            extra += f" threshold={self.threshold}"
        if self.output_path:
            extra += f" output={self.output_path}"
        if self.print_path:
            extra += f" print={self.print_path}"
        out.write(f"{pad}{self.op}{extra}\n")
        for inp in self.inputs:
            if isinstance(inp, OpNode):
                inp.describe(depth + 1, out)
            else:
                out.write("  " * (depth + 1) + f"input: {inp.path}\n")


def input_multiset(inp) -> bool:
    """Whether an input yields multiset (per-instance) entries."""
    if isinstance(inp, DBInput):
        return inp.open().multiset
    if isinstance(inp, OpNode):
        return node_output_multiset(inp)
    return False


def node_output_multiset(node: OpNode) -> bool:
    """A merge node's output is a multiset iff any input is; counting
    always produces a plain set."""
    if node.op in COUNT_OPS:
        return False
    return any(input_multiset(i) for i in node.inputs)


def _node_k(node: OpNode, k: int | None) -> int:
    """Resolve k from the global option or the first DB input."""
    if k:
        return k
    for inp in node.inputs:
        if isinstance(inp, DBInput):
            return inp.open().k
        if isinstance(inp, OpNode):
            kk = _node_k(inp, None)
            if kk:
                return kk
    return 0


def resolve_threshold(node: OpNode) -> None:
    """Convert distinct= / word-frequency= into an absolute threshold
    from the single DB input's stored histogram."""
    if node.frac_distinct is None and node.word_frequency is None:
        return
    if len(node.inputs) != 1 or not isinstance(node.inputs[0], DBInput):
        raise ValueError(
            "distinct=/word-frequency= thresholds need exactly one meryl "
            "database input")
    db = node.inputs[0].open()
    vals, occ = db.histogram()
    stats = db.stats()
    if node.frac_distinct is not None:
        target = node.frac_distinct * stats["numDistinct"]
        acc = 0
        for v, o in zip(vals.tolist(), occ.tolist()):
            acc += o
            if acc >= target:
                node.threshold = int(v)
                break
        else:
            node.threshold = int(vals[-1]) if len(vals) else 0
    if node.word_frequency is not None:
        node.threshold = int(node.word_frequency * stats["numTotal"])


class BucketEvaluator:
    """Evaluates an op tree bucket group by bucket group on `device`."""

    def __init__(self, k: int, device="cuda"):
        self.k = int(k)
        self.device = torch.device(device)

    @staticmethod
    def _pad_to(n: int) -> int:
        if n <= 256:
            return 256
        return 1 << (int(n - 1).bit_length())

    # row-batched merge packing: the merge inputs are already sorted, so
    # big bucket groups are split at shared key boundaries into
    # independent rows of ~ROW_TARGET entries and sorted as one (R, L)
    # batch by the bitonic row-sort kernel.  ROW_SPLIT_MIN keeps small
    # dispatches on the flat path.
    ROW_TARGET = 1 << 12
    ROW_SPLIT_MIN = 1 << 15

    @staticmethod
    def _quantize_rowlen(n: int) -> int:
        """Row length grid: quarter steps between powers of two."""
        if n <= 256:
            return 256
        p = 1 << (int(n - 1).bit_length() - 2)  # quarter step
        return ((n + p - 1) // p) * p

    @staticmethod
    def _row_cuts(ins, R: int):
        """R-1 ascending (hi, lo) cut keys that approximately balance
        total entries per row, from a rank-quantile sample."""
        his, los = [], []
        for hi, lo, c in ins:
            n = len(c)
            if n == 0:
                continue
            stride = max(1, n // (R * 32))
            his.append(hi[::stride])
            los.append(lo[::stride])
        hi = np.concatenate(his)
        lo = np.concatenate(los)
        order = np.lexsort((lo, hi))
        hi, lo = hi[order], lo[order]
        idx = (np.arange(1, R) * len(hi)) // R
        return hi[idx], lo[idx]

    @staticmethod
    def _searchsorted_hilo(hi, lo, cut_hi, cut_lo):
        """Lexicographic lower-bound of each (cut_hi, cut_lo) key in the
        sorted-unique (hi, lo) pair of arrays."""
        out = np.empty(len(cut_hi), np.int64)
        a_all = np.searchsorted(hi, cut_hi, "left")
        b_all = np.searchsorted(hi, cut_hi, "right")
        for j in range(len(cut_hi)):
            a, b = a_all[j], b_all[j]
            out[j] = a + np.searchsorted(lo[a:b], cut_lo[j], "left")
        return out

    def _row_bounds(self, ins, R: int, native=None):
        """Per-input (R+1,) row bounds at R-1 shared cut keys, and the
        quantized row length that holds the fullest row; found by the
        native pass when given one (a _NativePack of ins)."""
        cut_hi, cut_lo = self._row_cuts(ins, R)
        if native is not None:
            bounds, occ = native.bounds(cut_hi, cut_lo, R)
            return bounds, self._quantize_rowlen(int(occ))
        bounds = []
        for hi, lo, c in ins:
            b = np.empty(R + 1, np.int64)
            b[0] = 0
            b[-1] = len(c)
            b[1:-1] = self._searchsorted_hilo(hi, lo, cut_hi, cut_lo)
            bounds.append(b)
        occ = np.zeros(R, np.int64)
        for b in bounds:
            occ += b[1:] - b[:-1]
        return bounds, self._quantize_rowlen(int(occ.max()))

    @staticmethod
    def _native_pack(ins, extras):
        """A _NativePack of ins, or None where numpy packs: with extras
        (meryl2's labels), under MERYL_TPU_NO_NATIVE or without g++."""
        lib = None if extras is not None else _native_rowpack()
        return None if lib is None else _NativePack(lib, ins)

    def _pack_rows(self, ins, m: int, extras=None):
        """Pack m sorted-unique (hi, lo, counts) inputs into (R, L)
        padded key / value / id arrays split at shared key boundaries:
        all instances of a key land in exactly one row, so rows sort
        independently and the flattened result is globally ordered.

        R starts where the reference's packer puts it; while the longest
        row exceeds rowsort.MAX_ROW (the kernel's bound), R doubles.
        Splitting finer never changes the merged result.

        extras: optional per-input list of extra payload arrays (meryl2's
        label halves), each aligned with that input's counts; packed
        beside the values, zero-padded, and returned as a fourth element
        when given.

        Without extras the native pass finds the bounds and writes the
        arrays; with them, and under MERYL_TPU_NO_NATIVE or without g++,
        numpy does."""
        native = self._native_pack(ins, extras)
        total = sum(len(c) for _, _, c in ins)
        R = max(2, min(1 << 11, total // self.ROW_TARGET))
        R = 1 << (R - 1).bit_length()
        bounds, L = self._row_bounds(ins, R, native)
        while L > rowsort.MAX_ROW:
            if R > 2 * total:
                raise RuntimeError(f"cannot split {total} entries into rows "
                                   f"of at most {rowsort.MAX_ROW}")
            R *= 2
            bounds, L = self._row_bounds(ins, R, native)
        if native is not None:
            return native.fill(bounds, R, L, m, self.k)
        STATS["packs_numpy"] += 1
        nw = mw.num_words(self.k)
        shape = (R, L) if nw == 1 else (R, L, 2)
        keys = np.empty(shape, np.int64)
        keys[...] = np.array(mw.sentinel_words(self.k), np.int64) \
            if nw == 2 else mw.sentinel_words(self.k)[0]
        values = np.zeros((R, L), np.int64)
        ids = np.full((R, L), m, np.int32)
        packed_extra = [np.zeros((R, L), x.dtype) for x in extras[0]] \
            if extras else []
        pos = np.zeros(R, np.int64)   # next free column of each row
        for i, (hi, lo, c) in enumerate(ins):
            b = bounds[i]
            per_row = b[1:] - b[:-1]
            row = np.repeat(np.arange(R), per_row)
            col = pos[row] + np.arange(len(c)) - b[row]
            keys[row, col] = mw.from_hilo(hi, lo, self.k)
            values[row, col] = c
            ids[row, col] = i
            for out, x in zip(packed_extra, extras[i] if extras else ()):
                out[row, col] = x
            pos += per_row
        if extras is not None:
            return keys, values, ids, packed_extra
        return keys, values, ids

    def _pack_flat(self, ins, m: int, extras=None):
        """Concatenate m (hi, lo, counts) inputs into one padded flat
        key / value / id row; extras and the path as in _pack_rows (the
        native pass writes one row of N slots)."""
        native = self._native_pack(ins, extras)
        total = sum(len(c) for _, _, c in ins)
        N = self._pad_to(total)
        if native is not None:
            bounds = np.zeros((len(ins), 2), np.int64)
            bounds[:, 1] = native.lens
            keys, values, ids = native.fill(bounds, 1, N, m, self.k)
            return keys[0], values[0], ids[0]
        STATS["packs_numpy"] += 1
        nw = mw.num_words(self.k)
        keys = np.empty((N,) if nw == 1 else (N, 2), np.int64)
        keys[...] = np.array(mw.sentinel_words(self.k), np.int64) \
            if nw == 2 else mw.sentinel_words(self.k)[0]
        values = np.zeros(N, np.int64)
        ids = np.full(N, m, np.int32)   # padding id beyond any real input
        packed_extra = [np.zeros(N, x.dtype) for x in extras[0]] \
            if extras else []
        pos = 0
        for i, (hi, lo, c) in enumerate(ins):
            n = len(c)
            keys[pos:pos + n] = mw.from_hilo(hi, lo, self.k)
            values[pos:pos + n] = c
            ids[pos:pos + n] = i
            for out, x in zip(packed_extra, extras[i] if extras else ()):
                out[pos:pos + n] = x
            pos += n
        if extras is not None:
            return keys, values, ids, packed_extra
        return keys, values, ids

    def eval_bucket(self, node: OpNode, ff: int):
        """-> (hi, lo, counts) for 6-bit prefix bucket ff."""
        return self.eval_buckets(node, (ff,))

    @staticmethod
    def _concat_buckets(runs):
        if len(runs) == 1:
            return runs[0]
        return tuple(np.concatenate([r[i] for r in runs])
                     for i in range(3))

    def eval_buckets(self, node: OpNode, ffs):
        """-> (hi, lo, counts) for a GROUP of ascending 6-bit prefix
        buckets, evaluated in one device dispatch (buckets are disjoint
        ascending kmer ranges, so their concatenation keeps every run
        intact)."""
        if node.op in COUNT_OPS:
            raise RuntimeError("counting nodes must be materialized first")

        ins = []
        for inp in node.inputs:
            if isinstance(inp, DBInput):
                db = inp.open()
                with trace.span("setop.db_read"):
                    ins.append(self._concat_buckets(
                        [db.load_bucket(ff) for ff in ffs]))
            elif isinstance(inp, OpNode):
                ins.append(self.eval_buckets(inp, ffs))
            else:
                raise RuntimeError(f"unexpected input {inp} in merge phase")

        m = len(ins)
        if node.op in ("nothing", "passthrough") and m == 1:
            return ins[0]

        total = sum(len(c) for _, _, c in ins)
        if total == 0:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.uint32)

        thr = int(node.threshold or 0) & setops.MASK
        ms_flags = tuple(input_multiset(i) for i in node.inputs)
        rows = not any(ms_flags) and total >= self.ROW_SPLIT_MIN
        with trace.span("setop.pack"):
            keys, values, ids = (self._pack_rows if rows
                                 else self._pack_flat)(ins, m)
        with trace.span("setop.upload"):
            key_t, val_t, ids_t = [torch.from_numpy(a).to(self.device)
                                   for a in (keys, values, ids)]
        if any(ms_flags):
            skey, out_vals, keep = setops.merge_op_multiset(
                key_t, val_t, ids_t, node.op, m, thr, ms_flags, self.k)
        else:
            skey, out_vals, keep = setops.merge_op(
                key_t, val_t, ids_t, node.op, m, thr, self.k)
        STATS["dispatches"] += 1
        STATS["entries"] += total
        if rows:
            STATS["row_dispatches"] += 1
            STATS["rows"] += values.shape[0]
            STATS["row_slots"] += values.size
        with trace.span("setop.download"):  # waits for the merge too
            hi, lo = mw.to_hilo(skey[keep].cpu().numpy(), self.k)
            return hi, lo, out_vals[keep].cpu().numpy().astype(np.uint32)


def _bucket_entry_estimates(node: OpNode) -> np.ndarray:
    """Per-bucket input entry estimates from leaf DB file sizes."""
    from .db import bucket_name
    est = np.zeros(NUM_FILES, np.int64)

    def walk(n):
        for inp in n.inputs:
            if isinstance(inp, DBInput):
                db = inp.open()
                for ff in range(NUM_FILES):
                    try:
                        sz = os.path.getsize(
                            os.path.join(db.path, bucket_name(ff)))
                    except OSError:
                        sz = 0
                    est[ff] += max(0, sz - 24) // 20
            elif isinstance(inp, OpNode):
                walk(inp)

    walk(node)
    return est


def bucket_groups(node: OpNode, target: int | None = None) -> list:
    """Pack the 64 buckets into dispatch groups of ~target input
    entries each (one padded device call per group instead of 64)."""
    if target is None:
        target = int(os.environ.get("MERYL_TPU_SETOP_BATCH", 1 << 20))
    est = _bucket_entry_estimates(node)
    groups, cur, acc = [], [], 0
    for ff in range(NUM_FILES):
        cur.append(ff)
        acc += int(est[ff])
        if acc >= target:
            groups.append(tuple(cur))
            cur, acc = [], 0
    if cur:
        groups.append(tuple(cur))
    return groups


def execute_root(node: OpNode, k: int, *, device="cuda", out=None,
                 verbose: int = 0):
    """Run the merge phase for one root: bucket-group eval, printing
    and DB output as we go.  Returns the written MerylDB (or None)."""
    ev = BucketEvaluator(k, device)
    writer = None
    if node.output_path:
        writer = MerylDBWriter(node.output_path, k,
                               multiset=node_output_multiset(node))
    pf = None
    if node.print_path is not None:
        from .io.sequence import open_output
        pf = sys.stdout if node.print_path == "-" else \
            open_output(node.print_path)
    try:
        from .reports import print_kmers
        for group in bucket_groups(node):
            if verbose >= 2:
                sys.stderr.write(
                    f"merylOp::eval()-- STARTING operation {node.op} "
                    f"buckets {group[0]:02d}..{group[-1]:02d}\n")
            hi, lo, counts = ev.eval_buckets(node, group)
            if verbose >= 3 and len(counts):
                # one line per surviving kmer: a debugging aid,
                # deliberately unbounded
                from .reports import format_kmer_lines
                blob = format_kmer_lines(hi, lo, counts, k)
                for line in blob.decode().splitlines():
                    sys.stderr.write(
                        f"merylOp::eval()--   {node.op} kmer {line}\n")
            if writer is not None:
                with trace.span("setop.db_write"):
                    if len(group) == 1:
                        writer.add_bucket(group[0], hi, lo, counts)
                    else:
                        pref = km.prefix6_from_hilo(hi, lo, k)
                        for ff in group:
                            s = np.searchsorted(pref, ff, "left")
                            e = np.searchsorted(pref, ff, "right")
                            writer.add_bucket(ff, hi[s:e], lo[s:e],
                                              counts[s:e])
            if pf is not None and len(counts):
                print_kmers(hi, lo, counts, k, out=pf,
                            acgt_order=node.print_acgt)
        if writer is not None:
            with trace.span("setop.db_write"):
                return writer.finalize()
        return None
    finally:
        if pf is not None and pf is not sys.stdout:
            pf.close()


def execute_compare(node: OpNode, k: int, *, device="cuda", out=None):
    """The `compare` action: report kmers present in only one input or
    with differing values.  Multiset inputs compare per instance, by
    value rank."""
    out = out or sys.stdout
    ev = BucketEvaluator(k, device)
    assert len(node.inputs) == 2, "compare needs exactly two inputs"
    same = True
    for ff in range(NUM_FILES):
        ins = []
        for inp in node.inputs:
            if isinstance(inp, DBInput):
                ins.append(inp.open().load_bucket(ff))
            else:
                ins.append(ev.eval_bucket(inp, ff))
        a, b = ins
        ka: dict = {}
        kb: dict = {}
        for h, l, c in zip(*a):
            ka.setdefault((int(h) << 64) | int(l), []).append(int(c))
        for h, l, c in zip(*b):
            kb.setdefault((int(h) << 64) | int(l), []).append(int(c))
        for v in sorted(set(ka) | set(kb)):
            s = km.kmer_to_string(v, k)
            va = sorted(ka.get(v, []))
            vb = sorted(kb.get(v, []))
            # "only in input %u" is the 0-based input index, while the
            # value mismatch line says "input 1/2", as in the original
            for i in range(max(len(va), len(vb))):
                if i >= len(vb):
                    out.write(f"kmer {s} only in input 0\n")
                    same = False
                elif i >= len(va):
                    out.write(f"kmer {s} only in input 1\n")
                    same = False
                elif va[i] != vb[i]:
                    out.write(f"kmer {s} has value {va[i]} in input 1 "
                              f"!= value {vb[i]} in input 2\n")
                    same = False
    return same
