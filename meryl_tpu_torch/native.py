"""ctypes bindings for the native host substrate (native/mt_host.cpp).

A copy of meryl_tpu/native.py, so that the port imports nothing of the
JAX package.  It compiles the same sources (`native/*.cpp` at the repo
root), but into the port's own `meryl_tpu_torch/_build/` with
`make -C native TARGET=<that path>`: the reference's
`native/libmeryl_host.so` is never loaded or written here.  If
the toolchain or library is unavailable, callers fall back to the pure
python/numpy paths — capability is identical, the native scanner is a
host-throughput optimization (the reference's equivalent layer is the
C++ dnaSeqFile; SURVEY.md §2.3).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_HERE), "native")
_BUILD_DIR = os.path.join(_HERE, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libmeryl_host.so")

_lock = threading.Lock()
_lib = None
_tried = False


class _MtScanner(ctypes.Structure):
    _fields_ = [
        ("fmt", ctypes.c_int32),
        ("state", ctypes.c_int32),
        ("seqlen", ctypes.c_int64),
        ("quallen", ctypes.c_int64),
        ("last_base", ctypes.c_uint8),
        ("emitted", ctypes.c_uint8),
        ("hpc", ctypes.c_uint8),
        ("bol", ctypes.c_uint8),
    ]


def _build() -> bool:
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        r = subprocess.run(["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"],
                           capture_output=True, timeout=120)
        if r.returncode != 0:
            return False
        os.replace(tmp, _LIB_PATH)  # atomic: a concurrent loader sees
        return True                 # all of a library or none
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("MERYL_TPU_NO_NATIVE"):
            return None
        stale = False
        if os.path.exists(_LIB_PATH):
            try:  # rebuild when a source outran an old checkout's .so
                so_t = os.path.getmtime(_LIB_PATH)
                for src in ("mt_host.cpp", "mt_rans.cpp",
                            "mt_arith.cpp", "mt_route.cpp"):
                    sp = os.path.join(_NATIVE_DIR, src)
                    if os.path.exists(sp) and os.path.getmtime(sp) > so_t:
                        stale = True
            except OSError:
                pass
        if (stale or not os.path.exists(_LIB_PATH)) and not _build() \
                and not os.path.exists(_LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            lib.mt_scanner_init.argtypes = [ctypes.POINTER(_MtScanner),
                                            ctypes.c_int32]
            lib.mt_scan.argtypes = [ctypes.POINTER(_MtScanner),
                                    ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_uint8)]
            lib.mt_scan.restype = ctypes.c_int64
            lib.mt_scanner_finish.argtypes = [ctypes.POINTER(_MtScanner),
                                              ctypes.POINTER(ctypes.c_uint8)]
            lib.mt_scanner_finish.restype = ctypes.c_int64
            u64p = ctypes.POINTER(ctypes.c_uint64)
            lib.mt_merge2.argtypes = [u64p, u64p, u64p, ctypes.c_int64,
                                      u64p, u64p, u64p, ctypes.c_int64,
                                      u64p, u64p, u64p]
            lib.mt_merge2.restype = ctypes.c_int64
            i64p = ctypes.POINTER(ctypes.c_int64)
            if hasattr(lib, "mt_merge_kway"):
                lib.mt_merge_kway.argtypes = [
                    u64p, u64p, u64p, i64p, i64p, ctypes.c_int64,
                    u64p, u64p, u64p]
                lib.mt_merge_kway.restype = ctypes.c_int64
            if hasattr(lib, "mt_merge_kway64"):
                lib.mt_merge_kway64.argtypes = [
                    u64p, u64p, i64p, i64p, ctypes.c_int64, u64p, u64p]
                lib.mt_merge_kway64.restype = ctypes.c_int64
            u8p = ctypes.POINTER(ctypes.c_uint8)
            if hasattr(lib, "mt_rans4x8_decode"):
                lib.mt_rans4x8_decode.argtypes = [
                    u8p, ctypes.c_int64, u8p, ctypes.c_int64]
                lib.mt_rans4x8_decode.restype = ctypes.c_int64
            if hasattr(lib, "mt_ransnx16_core"):
                lib.mt_ransnx16_core.argtypes = [
                    u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                    u8p, ctypes.c_int64]
                lib.mt_ransnx16_core.restype = ctypes.c_int64
            if hasattr(lib, "mt_arith_decode"):
                lib.mt_arith_decode.argtypes = [
                    u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                    ctypes.c_int32, u8p, ctypes.c_int64]
                lib.mt_arith_decode.restype = ctypes.c_int64
            if hasattr(lib, "mt_fqz_decode"):
                lib.mt_fqz_decode.argtypes = [
                    u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int32, u8p,
                    ctypes.c_void_p, u8p, ctypes.c_int64]
                lib.mt_fqz_decode.restype = ctypes.c_int64
            if hasattr(lib, "mt_itf8_parse"):
                lib.mt_itf8_parse.argtypes = [
                    u8p, ctypes.c_int64, i64p, i64p, ctypes.c_int64]
                lib.mt_itf8_parse.restype = ctypes.c_int64
            if hasattr(lib, "mt_bam_scan"):
                lib.mt_bam_scan.argtypes = [
                    u8p, ctypes.c_int64, u8p, ctypes.c_int64,
                    ctypes.c_int32, i64p]
                lib.mt_bam_scan.restype = ctypes.c_int64
            if hasattr(lib, "mt_bacj_route"):
                u32p = ctypes.POINTER(ctypes.c_uint32)
                i32p = ctypes.POINTER(ctypes.c_int32)
                lib.mt_bacj_route.argtypes = [
                    u64p, u64p, ctypes.c_int64, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int32, ctypes.c_int32,
                    u32p, i32p, i64p, ctypes.c_int32]
                lib.mt_bacj_route.restype = ctypes.c_int32
            if hasattr(lib, "mt_bacj_build_grid"):
                u32p = ctypes.POINTER(ctypes.c_uint32)
                lib.mt_bacj_build_grid.argtypes = [
                    u64p, u64p, u32p, ctypes.c_int64, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                    u32p, u32p, ctypes.c_int32]
                lib.mt_bacj_build_grid.restype = ctypes.c_int32
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return get_lib() is not None


class NativeScanner:
    """Streaming FASTA/FASTQ -> 2-bit-code scanner over raw byte blocks."""

    def __init__(self, hpc: bool = False):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._st = _MtScanner()
        lib.mt_scanner_init(ctypes.byref(self._st), 1 if hpc else 0)

    def scan(self, data: bytes) -> np.ndarray:
        n = len(data)
        out = np.empty(n + 1, np.uint8)
        optr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        wrote = self._lib.mt_scan(ctypes.byref(self._st), data, n, optr)
        return out[:wrote]

    def finish(self) -> np.ndarray:
        out = np.empty(1, np.uint8)
        optr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        wrote = self._lib.mt_scanner_finish(ctypes.byref(self._st), optr)
        return out[:wrote]


def _u64p(a, off=0):
    return ctypes.cast(
        a.ctypes.data + 8 * off, ctypes.POINTER(ctypes.c_uint64))


def merge2(ha, la, ca, hb, lb, cb):
    """Merge two sorted unique (hi, lo, count-u64) runs, summing counts
    of equal kmers.  Returns (hi, lo, counts) numpy arrays."""
    return merge_cascade([(ha, la, ca), (hb, lb, cb)])


# one pool a thread: the members of a sharded count merge on threads of
# their own at the same time, and must not share staging buffers
_merge_pool = threading.local()


def _pool_buffers(total: int):
    """Reuse the cascade's two buffer sets across calls on this thread:
    large numpy allocations are fresh mmaps, and first-touch page
    faults cost ~15us/page in this environment."""
    pool = getattr(_merge_pool, "sets", None)
    if not pool or len(pool[0][0]) < total:
        cap = max(total, int(total * 1.5))
        pool = _merge_pool.sets = [[np.empty(cap, np.uint64)
                                    for _ in range(3)] for _ in range(2)]
        for bufset in pool:  # pre-fault once
            for b in bufset:
                b[::512] = 0
    return pool[0], pool[1]


def merge_threads() -> int:
    """Host merge parallelism: the CLI's threads= option (env
    MERYL_TPU_THREADS); default caps at 4 — the cascade is
    memory-bandwidth-bound well before that."""
    v = os.environ.get("MERYL_TPU_THREADS")
    if v:
        return max(1, int(v))
    from .resources import max_threads
    return max(1, min(4, max_threads() // 2))


def merge_cascade(runs, threads: int | None = None):
    """Merge any number of sorted unique (hi, lo, count-u64) runs with
    the native linear pairwise merge, ping-ponging two pooled buffer
    sets.  Pairwise merges within a cascade level are independent and
    run on `threads` host threads (ctypes releases the GIL) — the
    reference's threads= maps here (its OpenMP dump/merge loops)."""
    lib = get_lib()
    runs = [tuple(np.ascontiguousarray(x, np.uint64) for x in r)
            for r in runs]
    total = sum(len(r[2]) for r in runs)
    if threads is None:
        threads = merge_threads()
    A, B = _pool_buffers(total)
    segs = []  # (start, n) in A, ascending disjoint
    o = 0
    for h, l, c in runs:
        n = len(c)
        A[0][o:o + n] = h
        A[1][o:o + n] = l
        A[2][o:o + n] = c
        segs.append((o, n))
        o += n

    ex = None
    if threads > 1 and len(segs) > 2:
        from concurrent.futures import ThreadPoolExecutor
        ex = ThreadPoolExecutor(max_workers=threads)
    try:
        while len(segs) > 1:
            pairs = [(segs[i], segs[i + 1])
                     for i in range(0, len(segs) - 1, 2)]
            tail = segs[-1] if len(segs) % 2 else None
            Ai, Bi = A, B

            def do_pair(pq):
                (s0, n0), (s1, n1) = pq
                # output lands at the left input's start; the merged
                # size <= n0+n1 <= s_next - s0, so regions stay disjoint
                n = lib.mt_merge2(
                    _u64p(Ai[0], s0), _u64p(Ai[1], s0), _u64p(Ai[2], s0),
                    n0,
                    _u64p(Ai[0], s1), _u64p(Ai[1], s1), _u64p(Ai[2], s1),
                    n1,
                    _u64p(Bi[0], s0), _u64p(Bi[1], s0), _u64p(Bi[2], s0))
                return (s0, n)
            if ex is not None and len(pairs) > 1:
                new_segs = list(ex.map(do_pair, pairs))
            else:
                new_segs = [do_pair(p) for p in pairs]
            if tail is not None:  # odd run copies through
                s0, n = tail
                for x in range(3):
                    B[x][s0:s0 + n] = A[x][s0:s0 + n]
                new_segs.append((s0, n))
            A, B = B, A
            segs = new_segs
    finally:
        if ex is not None:
            ex.shutdown()
    s0, n = segs[0]
    return (A[0][s0:s0 + n].copy(), A[1][s0:s0 + n].copy(),
            A[2][s0:s0 + n].copy())


def _searchsorted_hilo(h, l, ph, pl):
    """Insertion index of 128-bit key (ph, pl) in sorted (h, l) arrays."""
    i0 = int(np.searchsorted(h, ph, "left"))
    i1 = int(np.searchsorted(h, ph, "right"))
    return i0 + int(np.searchsorted(l[i0:i1], pl, "left"))


_GROUP = 256  # max cursors per tournament (keys+heads must fit cache)


def _u64ptr(a, off=0):
    return ctypes.cast(a.ctypes.data + 8 * off,
                       ctypes.POINTER(ctypes.c_uint64))


def _i64ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _kway_call(lib, use64, src, dst, offs, lens, nruns, out_off):
    """Dispatch one tournament merge: the u64-key kernel when every
    staged hi word is one constant and no lo is all-ones (k <= 31 in
    practice) — u64 compares cmov where the 128-bit path branches."""
    if use64:
        return lib.mt_merge_kway64(_u64ptr(src[1]), _u64ptr(src[2]),
                                   _i64ptr(offs), _i64ptr(lens), nruns,
                                   _u64ptr(dst[1], out_off),
                                   _u64ptr(dst[2], out_off))
    return lib.mt_merge_kway(_u64ptr(src[0]), _u64ptr(src[1]),
                             _u64ptr(src[2]), _i64ptr(offs),
                             _i64ptr(lens), nruns,
                             _u64ptr(dst[0], out_off),
                             _u64ptr(dst[1], out_off),
                             _u64ptr(dst[2], out_off))


def _kway_pass(lib, src, dst, offs, lens, base_out: int,
               threads: int, ex, use64=False):
    """One k-way merge of the runs (offs, lens) within buffer set `src`
    into `dst` starting at base_out.  Range-partitions across `threads`
    when the work is large enough (the tournament is latency-bound, so
    disjoint kmer ranges scale).  Returns (out_offsets, out_lens)."""
    nruns = len(lens)
    total = int(lens.sum())
    nparts = min(threads, max(1, total // (1 << 20)))
    if nparts <= 1 or nruns <= 1 or ex is None:
        m = _kway_call(lib, use64, src, dst, offs, lens, nruns, base_out)
        return [base_out], [m]

    # pivots from a sorted sample; per-run split points by binary
    # search.  In u64 mode the hi plane of intermediate levels is
    # UNWRITTEN (the kernel skips it), so pivots/splits use lo only.
    step = max(1, total // 4096)
    sl = np.concatenate([src[1][o:o + n:step]
                         for o, n in zip(offs, lens)])
    if use64:
        sl = np.sort(sl)
        pivots = [int(sl[(len(sl) * t) // nparts])
                  for t in range(1, nparts)]
        splits = []
        for o, n in zip(offs, lens):
            l = src[1][o:o + n]
            cuts = [0] + [int(np.searchsorted(l, np.uint64(pl), "left"))
                          for pl in pivots] + [int(n)]
            splits.append(np.maximum.accumulate(np.array(cuts,
                                                         np.int64)))
    else:
        sh = np.concatenate([src[0][o:o + n:step]
                             for o, n in zip(offs, lens)])
        order = np.lexsort((sl, sh))
        sh, sl = sh[order], sl[order]
        pivots = [(int(sh[(len(sh) * t) // nparts]),
                   (int(sl[(len(sh) * t) // nparts])))
                  for t in range(1, nparts)]
        splits = []
        for o, n in zip(offs, lens):
            h, l = src[0][o:o + n], src[1][o:o + n]
            cuts = [0] + [_searchsorted_hilo(h, l, ph, pl)
                          for ph, pl in pivots] + [int(n)]
            splits.append(np.maximum.accumulate(np.array(cuts,
                                                         np.int64)))

    jobs = []
    for t in range(nparts):
        offs_t = np.array([offs[r] + splits[r][t]
                           for r in range(nruns)], np.int64)
        lens_t = np.array([splits[r][t + 1] - splits[r][t]
                           for r in range(nruns)], np.int64)
        out_off = base_out + int(sum(splits[r][t] for r in range(nruns)))
        jobs.append((out_off, offs_t, lens_t))

    def do(job):
        out_off, offs_t, lens_t = job
        return _kway_call(lib, use64, src, dst, offs_t, lens_t, nruns,
                          out_off)

    ms = list(ex.map(do, jobs))
    return [j[0] for j in jobs], ms


def merge_kway(runs, threads: int | None = None):
    """K-way loser-tree merge of sorted unique (hi, lo, count-u64)
    runs, summing counts of equal kmers.

    Replaces the pairwise cascade for the production finish: the
    cascade rewrites every entry log2(nruns) times and saturates host
    memory bandwidth regardless of threads, while the tournament
    touches memory once per level and is LATENCY-bound — disjoint
    kmer-range partitions scale across threads.  Fan-ins above _GROUP
    merge in two levels (groups of _GROUP, thread-parallel, then the
    group results) so cursors+cached keys stay in cache.  All staging
    ping-pongs between pre-faulted pooled buffers (fresh pages cost
    ~100+us/page in lazy-memory VMs)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "mt_merge_kway"):
        return merge_cascade(runs, threads)  # stale .so without symbol
    runs = [tuple(np.ascontiguousarray(x, np.uint64) for x in r)
            for r in runs]
    runs = [r for r in runs if len(r[2])]
    if not runs:
        z = np.zeros(0, np.uint64)
        return z, z.copy(), np.zeros(0, np.uint64)
    # The kernels key exhausted cursors as all-ones.  A REAL all-ones
    # kmer (hi=lo=2^64-1: the k=64 poly-G, G=11) would terminate the
    # tournament early, so strip it here (it can only be each run's
    # LAST entry) and re-append the summed entry afterwards.
    U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
    inf_count = 0
    stripped = []
    for h, l, c in runs:
        if h[-1] == U64MAX and l[-1] == U64MAX:
            inf_count += int(c[-1])
            h, l, c = h[:-1], l[:-1], c[:-1]
        if len(c):
            stripped.append((h, l, c))
    runs = stripped
    if not runs:
        one = np.full(1, U64MAX, np.uint64)
        return ((one.copy(), one.copy(),
                 np.array([inf_count], np.uint64)) if inf_count else
                (np.zeros(0, np.uint64), np.zeros(0, np.uint64),
                 np.zeros(0, np.uint64)))
    if threads is None:
        threads = merge_threads()
    total = sum(len(r[2]) for r in runs)
    A, B = _pool_buffers(total)
    lens = np.array([len(r[2]) for r in runs], np.int64)
    offs = np.zeros(len(runs), np.int64)
    o = 0
    for i, (h, l, c) in enumerate(runs):
        n = len(c)
        A[0][o:o + n] = h
        A[1][o:o + n] = l
        A[2][o:o + n] = c
        offs[i] = o
        o += n

    # u64-key eligibility: one constant hi word across all runs and no
    # all-ones lo (the kernel's exhausted sentinel) — true for k <= 31
    hi0 = int(runs[0][0][0])
    use64 = (hasattr(lib, "mt_merge_kway64")
             and all(int(h[0]) == hi0 and int(h[-1]) == hi0
                     for h, l, c in runs)
             and max(int(l[-1]) for h, l, c in runs
                     if int(h[-1]) == hi0) != 0xFFFFFFFFFFFFFFFF)

    ex = None
    if threads > 1:
        from concurrent.futures import ThreadPoolExecutor
        ex = ThreadPoolExecutor(max_workers=threads)
    try:
        src, dst = A, B
        while len(lens) > 1:
            if len(lens) > _GROUP:
                # group level: merge spans of _GROUP runs, one job per
                # group across threads (each group's tree fits cache)
                spans = [(i, min(i + _GROUP, len(lens)))
                         for i in range(0, len(lens), _GROUP)]

                def do_group(span):
                    b, e = span
                    return _kway_call(
                        lib, use64, src, dst, offs[b:e],
                        np.ascontiguousarray(lens[b:e]), e - b,
                        int(offs[b]))
                if ex is not None:
                    ms = list(ex.map(do_group, spans))
                else:
                    ms = [do_group(s) for s in spans]
                offs = np.array([offs[b] for b, _ in spans], np.int64)
                lens = np.array(ms, np.int64)
            else:
                oo, mm = _kway_pass(lib, src, dst, offs, lens, 0,
                                    threads, ex, use64)
                offs = np.array(oo, np.int64)
                lens = np.array(mm, np.int64)
                src, dst = dst, src
                break  # partition outputs are globally ordered/disjoint
            src, dst = dst, src
    finally:
        if ex is not None:
            ex.shutdown()

    # concatenate the (already globally ordered, disjoint) segments
    n_out = int(lens.sum())
    oh = np.empty(n_out, np.uint64)
    ol = np.empty(n_out, np.uint64)
    oc = np.empty(n_out, np.uint64)
    w = 0
    for o, n in zip(offs.tolist(), lens.tolist()):
        if not use64:
            oh[w:w + n] = src[0][o:o + n]
        ol[w:w + n] = src[1][o:o + n]
        oc[w:w + n] = src[2][o:o + n]
        w += n
    if use64:
        oh.fill(hi0)
    if inf_count:  # re-append the stripped all-ones kmer (sorts last)
        oh = np.concatenate([oh, np.full(1, U64MAX, np.uint64)])
        ol = np.concatenate([ol, np.full(1, U64MAX, np.uint64)])
        oc = np.concatenate([oc, np.array([inf_count], np.uint64)])
    return oh, ol, oc


def rans4x8_decode(data: bytes, out_sz: int):
    """Native full-stream rANS 4x8 decode, or None if unavailable/
    failed (callers fall back to the Python reference decoder)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "mt_rans4x8_decode"):
        return None
    src = np.frombuffer(data, np.uint8)
    out = np.empty(out_sz, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    r = lib.mt_rans4x8_decode(
        src.ctypes.data_as(u8), len(data),
        out.ctypes.data_as(u8), out_sz)
    if r < 0:
        return None
    return out[:r].tobytes()


def ransnx16_core(data, pos: int, order1: bool, n_states: int,
                  out_sz: int):
    """Native rANS-Nx16 entropy core starting at the frequency table.
    -> (decoded bytes, new pos) or None on unavailable/failure."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "mt_ransnx16_core"):
        return None
    src = np.frombuffer(data, np.uint8)[pos:]
    out = np.empty(out_sz, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    consumed = lib.mt_ransnx16_core(
        src.ctypes.data_as(u8), len(src), 1 if order1 else 0,
        n_states, out.ctypes.data_as(u8), out_sz)
    if consumed < 0:
        return None
    return out.tobytes(), pos + int(consumed)


def arith_core(data, pos: int, order1: bool, rle: bool, out_sz: int):
    """Native adaptive-arithmetic body decode (CRAM method 6) starting
    at the max-sym byte.  -> (decoded bytes, new pos) or None on
    unavailable/failure (callers fall back to the Python decoder)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "mt_arith_decode"):
        return None
    src = np.frombuffer(data, np.uint8)
    out = np.empty(out_sz, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    end = lib.mt_arith_decode(
        src.ctypes.data_as(u8), len(src), pos, 1 if order1 else 0,
        1 if rle else 0, out.ctypes.data_as(u8), out_sz)
    if end < 0:
        return None
    return out.tobytes(), int(end)


class _FqzCParam(ctypes.Structure):
    _fields_ = [
        ("context", ctypes.c_int32), ("pflags", ctypes.c_int32),
        ("max_sym", ctypes.c_int32), ("qbits", ctypes.c_int32),
        ("qshift", ctypes.c_int32), ("qloc", ctypes.c_int32),
        ("sloc", ctypes.c_int32), ("ploc", ctypes.c_int32),
        ("dloc", ctypes.c_int32), ("has_qmap", ctypes.c_int32),
        ("qmap", ctypes.c_uint8 * 256),
        ("qtab", ctypes.c_uint32 * 256),
        ("ptab", ctypes.c_uint32 * 1024),
        ("dtab", ctypes.c_uint32 * 256),
    ]


def fqz_core(data, pos: int, gflags: int, max_sel: int, stab, params,
             out_sz: int):
    """Native fqzcomp body decode (CRAM method 7) starting at the
    range-coded payload; `params` is a list of fqzcomp._Param.
    -> (decoded bytes, new pos) or None on unavailable/failure."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "mt_fqz_decode"):
        return None
    cparams = (_FqzCParam * len(params))()
    for i, pm in enumerate(params):
        cp = cparams[i]
        cp.context = pm.context
        cp.pflags = pm.pflags
        cp.max_sym = pm.max_sym
        cp.qbits = pm.qbits
        cp.qshift = pm.qshift
        cp.qloc = pm.qloc
        cp.sloc = pm.sloc
        cp.ploc = pm.ploc
        cp.dloc = pm.dloc
        cp.has_qmap = 1 if pm.qmap is not None else 0
        if pm.qmap is not None:
            for j, v in enumerate(pm.qmap[:256]):
                cp.qmap[j] = v
        for j in range(256):
            cp.qtab[j] = pm.qtab[j]
        for j in range(1024):
            cp.ptab[j] = pm.ptab[j]
        for j in range(256):
            cp.dtab[j] = pm.dtab[j]
    stab_arr = np.asarray(stab, np.uint8)
    src = np.frombuffer(data, np.uint8)
    out = np.empty(out_sz, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    end = lib.mt_fqz_decode(
        src.ctypes.data_as(u8), len(src), pos, gflags, len(params),
        max_sel, stab_arr.ctypes.data_as(u8),
        ctypes.cast(cparams, ctypes.c_void_p),
        out.ctypes.data_as(u8), out_sz)
    if end < 0:
        return None
    return out.tobytes(), int(end)


def itf8_parse(data: bytes):
    """Bulk-parse consecutive CRAM ITF8 values.  -> (values, end byte
    offsets) int64 arrays, or None when the native library is
    unavailable (callers fall back to per-value Python parsing)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "mt_itf8_parse"):
        return None
    if not len(data):
        z = np.zeros(0, np.int64)
        return z, z.copy()
    src = np.frombuffer(data, np.uint8)
    vals = np.empty(len(data), np.int64)
    ends = np.empty(len(data), np.int64)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.POINTER(ctypes.c_int64)
    cnt = lib.mt_itf8_parse(
        src.ctypes.data_as(u8), len(data),
        vals.ctypes.data_as(i64), ends.ctypes.data_as(i64), len(data))
    return vals[:cnt], ends[:cnt]


_bam_out: np.ndarray | None = None


def bam_scan(win: bytes, hpc: bool):
    """Native bulk BAM window scan: records -> 2-bit codes +
    separators.  -> (codes array copy, bytes consumed) or None
    (callers fall back to the numpy/python path).  Reuses one
    pre-faulted output buffer: fresh pages cost 10-400us/page in
    lazy-memory VMs."""
    global _bam_out
    lib = get_lib()
    if lib is None or not hasattr(lib, "mt_bam_scan"):
        return None
    cap = 2 * len(win) + 64
    if _bam_out is None or len(_bam_out) < cap:
        _bam_out = np.empty(max(cap, 1 << 23), np.uint8)
        _bam_out[::2048] = 0  # pre-fault
    src = np.frombuffer(win, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    consumed = ctypes.c_int64(0)
    w = lib.mt_bam_scan(
        src.ctypes.data_as(u8), len(win),
        _bam_out.ctypes.data_as(u8), len(_bam_out),
        1 if hpc else 0, ctypes.byref(consumed))
    if w < 0:
        return None
    return _bam_out[:w].copy(), int(consumed.value)


def scan_codes(path: str, hpc: bool = False, block: int = 1 << 22):
    """Yield uint8 code arrays (with 0xFF separators) for a sequence
    file, using the native scanner.  Transparently decompresses.

    Large plain FASTA files take the record-parallel scan (the serial
    scanner's ~1.25 GB/s is below the device pipeline's rate, so it
    would cap end-to-end counting); everything else streams through
    one stateful scanner."""
    if _parallel_scan_eligible(path):
        yield from scan_codes_parallel(path, hpc)
        return
    from .io.sequence import open_maybe_compressed
    sc = NativeScanner(hpc)
    with open_maybe_compressed(path) as f:
        while True:
            data = f.read(block)
            if not data:
                break
            codes = sc.scan(data)
            if len(codes):
                yield codes
    tail = sc.finish()
    if len(tail):
        yield tail


def _parallel_scan_eligible(path: str,
                            min_bytes: int = 1 << 26) -> bool:
    """Plain (uncompressed) FASTA files above a size floor.  FASTA
    splits are unambiguous ('>' can never begin a sequence or quality
    line); FASTQ stays serial — '@' is a legal quality character, so
    record-aligned splitting of multi-line FASTQ cannot be validated
    locally without risking silent misparses."""
    if os.environ.get("MERYL_TPU_PAR_SCAN", "1") == "0":
        return False
    try:
        if os.path.getsize(path) < min_bytes:
            return False
        with open(path, "rb") as f:
            return f.read(1) == b">"
    except OSError:
        return False


_MALLOPT_DONE = False


def _keep_large_allocs_on_heap(threshold: int = 1 << 26) -> None:
    """Pin glibc's mmap threshold so multi-MB numpy buffers (per-span
    result copies, chunk arrays) are served from the reusable heap
    instead of a fresh mmap/munmap per allocation.  Until glibc's
    dynamic threshold adapts on its own, every such alloc/free is a
    first-touch fault storm plus TLB-shootdown IPIs that stall the
    concurrent scanner threads (~5x measured on the first pass over a
    file).  One-time, best-effort."""
    global _MALLOPT_DONE
    if _MALLOPT_DONE or os.environ.get("MERYL_TPU_MALLOPT", "1") == "0":
        return
    _MALLOPT_DONE = True
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt(ctypes.c_int(-3),            # M_MMAP_THRESHOLD
                     ctypes.c_int(threshold))
    except (OSError, AttributeError):
        pass


def _fasta_span_bounds(path: str, span_bytes: int):
    """Record-aligned [start, end) spans for a plain FASTA file: each
    interior boundary is the tentative split advanced to the next
    b'\\n>' (a header start, which never occurs inside sequence
    data)."""
    size = os.path.getsize(path)
    nspans = max(1, size // span_bytes)
    bounds = [0]
    with open(path, "rb") as f:
        for i in range(1, nspans):
            pos = size * i // nspans
            if pos <= bounds[-1]:
                continue
            found = size
            while pos < size:
                f.seek(pos)
                buf = f.read(1 << 20)
                if not buf:
                    break
                j = buf.find(b"\n>")
                if j >= 0:
                    found = pos + j + 1
                    break
                pos += len(buf) - 1   # re-read 1 byte: '\n>' straddle
            if bounds[-1] < found < size:
                bounds.append(found)
    bounds.append(size)
    return list(zip(bounds[:-1], bounds[1:]))


def scan_codes_parallel(path: str, hpc: bool = False,
                        span_bytes: int = 1 << 25,
                        threads: int | None = None):
    """Record-parallel FASTA -> codes: scan record-aligned spans on a
    thread pool (one scanner state per span; mt_scan releases the GIL)
    and yield code blocks in file order.

    Workers only ever touch PRE-FAULTED, RECYCLED buffer pairs: on
    this VM concurrent large alloc/free storms collapse throughput
    ~5-10x (mmap_lock + TLB-shootdown serialization on first-touch
    page faults — see the prealloc scaling measurements), so the one
    fresh allocation per span (the yielded result copy) happens
    single-threaded in the consumer, overlapped with worker scans.
    Spans start at record boundaries, so separator/HPC state never
    crosses a span."""
    import queue as _queue
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    lib = get_lib()
    _keep_large_allocs_on_heap()
    if threads is None:
        from .resources import max_threads
        threads = max(1, min(8, max_threads() - 1))
    spans = _fasta_span_bounds(path, span_bytes)
    if threads <= 1 or len(spans) <= 1:
        # one serial pass (plain file; no decompression needed)
        sc = NativeScanner(hpc)
        with open(path, "rb") as f:
            while True:
                data = f.read(1 << 22)
                if not data:
                    break
                codes = sc.scan(data)
                if len(codes):
                    yield codes
        tail = sc.finish()
        if len(tail):
            yield tail
        return

    max_span = max(b - a for a, b in spans)
    free: "_queue.SimpleQueue" = _queue.SimpleQueue()
    for _ in range(min(threads + 1, len(spans))):
        # pre-fault with full sequential writes, single-threaded:
        # dense first-touch maps huge pages (~free), while sparse
        # stride-4096 probing faults one 4K page at a time (~22us
        # each on this VM) and concurrent faulting collapses 5-10x
        # on mmap_lock / TLB shootdowns
        buf_in = np.empty(max_span, np.uint8)
        buf_out = np.empty(max_span + 2, np.uint8)
        buf_in.fill(0)
        buf_out.fill(0)
        free.put((buf_in, buf_out, _MtScanner()))

    u8 = ctypes.POINTER(ctypes.c_uint8)

    def scan_span(a: int, b: int):
        bufs = free.get()
        buf_in, buf_out, st = bufs
        n = b - a
        with open(path, "rb") as f:
            f.seek(a)
            got = f.readinto(memoryview(buf_in[:n]))
        if got != n:
            raise IOError(f"{path}: short read at {a}")
        lib.mt_scanner_init(ctypes.byref(st), 1 if hpc else 0)
        wrote = lib.mt_scan(ctypes.byref(st),
                            buf_in.ctypes.data_as(ctypes.c_char_p), n,
                            buf_out.ctypes.data_as(u8))
        wrote += lib.mt_scanner_finish(
            ctypes.byref(st),
            ctypes.cast(buf_out.ctypes.data + wrote, u8))
        return bufs, wrote

    with ThreadPoolExecutor(max_workers=threads) as ex:
        it = iter(spans)
        pending = deque()
        for _ in range(threads + 1):
            pair = next(it, None)
            if pair is None:
                break
            pending.append(ex.submit(scan_span, *pair))
        while pending:
            fut = pending.popleft()
            bufs, wrote = fut.result()
            codes = bufs[1][:wrote].copy()   # sole fresh alloc, here
            free.put(bufs)
            pair = next(it, None)
            if pair is not None:
                pending.append(ex.submit(scan_span, *pair))
            if wrote:
                yield codes


def n_threads() -> int:
    """General host parallelism for native helpers (router, scans):
    all available cores, honoring MERYL_TPU_THREADS."""
    v = os.environ.get("MERYL_TPU_THREADS")
    if v:
        return max(1, int(v))
    from .resources import max_threads
    return max(1, max_threads())
