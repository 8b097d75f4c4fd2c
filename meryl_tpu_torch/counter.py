"""Counting driver: sequence files -> sorted unique (kmer, count) arrays
-> DB (counterpart of meryl_tpu/counter.py).

The main path is the device accumulator (DeviceAccCounter): per chunk
the device extracts, routes and stages cells; every M chunks it merges
them into a sorted unique accumulator; the host downloads the unique
set once.  The exactness hatches (cell overflow, accumulator capacity)
finish on the host sort path: per-chunk sort + run starts on the
device, run lengths and a k-way merge on the host.

memory= is a real bound: when the plan (configure_counting) says the
merged unique set may pass it, count_to_db counts in batches, each
written as a partial DB with a resume manifest, and union-sums them
(count_to_db_batched).

Several GPUs: one process counts over every card it sees on the
sharded path (parallel/shard_count.py, one thread a card: on by default
on a host with several cards, MERYL_TPU_SHARDED=1 forces it,
MERYL_TPU_LOCAL_DEVICES=n members on the CPU); a job of processes
started by parallel/launch.py (MERYL_TPU_COORD; one device a process,
or --devices-per-proc D, one thread a device) runs the same step
through parallel/multihost.py.

The host modules (kmer, db, io.sequence, native) are the port's own
copies of meryl_tpu's; nothing here imports JAX or meryl_tpu.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import os as _os
import threading
import time as _time

import numpy as np
import torch

from . import _build
from . import kmer as km
from . import resolve_device
from . import trace
from .db import MerylDB
from .io.sequence import SEP, SequenceChunker
from .ops import accum
from .ops import count as cnt
from .ops import extract_cuda
from .ops import multiword as mw


def default_chunk() -> int:
    """Bases per device chunk (env MERYL_TPU_CHUNK, read at call
    time)."""
    return int(_os.environ.get("MERYL_TPU_CHUNK", 1 << 22))


def shard_default_chunk() -> int:
    """Bases a rank feeds a step of the sharded count (env
    MERYL_TPU_SHARD_CHUNK, read at call time); 2^22 matches the single
    device's chunk."""
    return int(_os.environ.get("MERYL_TPU_SHARD_CHUNK", 1 << 22))


def _sort_rowlen(chunk_len: int) -> int | None:
    """Row length of the host-path chunk sort: chunks sort as
    independent rows of 2^11 (the reference's default) and the host
    merge union-sums duplicates across rows.  None for chunks the row
    length does not divide."""
    r = 1 << 11
    if chunk_len % r or chunk_len // r <= 1:
        return None
    return r


def _parse_suffix(count_suffix, k: int):
    """count-suffix string -> (bits, length), or None."""
    if not count_suffix:
        return None
    if len(count_suffix) > k:
        raise ValueError("count-suffix longer than k")
    return km.string_to_kmer(count_suffix), len(count_suffix)


def _suffix_filter(key, valid, suffix, k: int):
    """Keep only k-mers whose last `length` bases encode to `bits`
    (suffix = (bits, length)): the low 2 * length bits of the k-mer as
    it is stored (canonical, forward or reverse), 64 bits a word."""
    if suffix is None:
        return valid
    sbits, slen = suffix
    need = 2 * slen
    for w, word in enumerate(reversed(mw.split(key, k))):  # low word first
        bits_here = min(64, need - 64 * w)
        if bits_here <= 0:
            break
        mask = (1 << bits_here) - 1
        want = (sbits >> (64 * w)) & mask
        # as signed int64 constants
        mask, want = (v - (1 << 64) if v >> 63 else v for v in (mask, want))
        valid = valid & (((word ^ mw.FLIP) & mask) == want)
    return valid


def _wire(codes: np.ndarray, device):
    """Host codes -> packed wire tensors on `device` (packed words as
    int32 bit patterns)."""
    packed2, exc, n_real = km.pack_codes_2bit(codes)
    return _wire_tensors(packed2, exc, device) + (n_real,)


def _wire_tensors(packed2, exc, device):
    return (torch.from_numpy(packed2.view(np.int32)).to(device),
            torch.from_numpy(exc).to(device))


def _count_chunk(chunk, k: int, mode: str, device, suffix=None):
    """Dispatch one chunk on the host sort path: host codes, or a wire
    triple (packed2, exc, n_real) already on the device.  suffix: an
    optional (bits, length) pair (_parse_suffix).  Returns the
    arguments of _finish_chunk, the first an opaque device result."""
    if isinstance(chunk, np.ndarray):
        chunk = _wire(chunk, device)
    packed2, exc, n_real = chunk
    L = packed2.shape[0] * 16
    key, valid = extract_cuda.extract_kmers_packed(packed2, exc, n_real,
                                                   k, mode)
    valid = _suffix_filter(key, valid, suffix, k)
    rowlen = _sort_rowlen(L)
    return cnt.sort_starts(key, valid, k, rowlen), rowlen, k


def _finish_chunk(result, rowlen, k):
    """Device result -> LIST of host (hi, lo, counts-u64) sorted unique
    triples, one per sort row (rows are sorted independently)."""
    skey, start, n_invalid = result
    n_inv = n_invalid.cpu().numpy() if rowlen else int(n_invalid)
    (keys,), c, idx = cnt.host_rle_finish(
        [skey.cpu().numpy()], start.cpu().numpy(), n_inv, rowlen)
    hi, lo = mw.to_hilo(keys, k)
    if rowlen is None:
        return [(hi, lo, c)]
    rows = len(start) // rowlen
    cuts = np.searchsorted(idx, np.arange(1, rows) * rowlen)
    out = []
    prev = 0
    for cut in list(cuts) + [len(c)]:
        if cut > prev:
            out.append((hi[prev:cut], lo[prev:cut], c[prev:cut]))
        prev = cut
    return out


def merge_runs(runs):
    """Merge per-chunk unique (hi, lo, counts-u64) triples into one
    globally sorted unique triple; counts clamped to kmvalu max.  Uses
    the native k-way merge when it is built (each run is sorted)."""
    if not runs:
        z = np.zeros(0, np.uint64)
        return z, z.copy(), np.zeros(0, np.uint32)
    if len(runs) == 1:  # one sorted unique run is its own merge
        hi, lo, c = runs[0]
        return hi, lo, np.minimum(c, km.VALUE_MAX).astype(np.uint32)

    from . import native
    if native.available():
        lib = native.get_lib()
        if len(runs) > 2 and hasattr(lib, "mt_merge_kway"):
            hi, lo, c = native.merge_kway(runs)
        else:
            hi, lo, c = native.merge_cascade(runs)
        return hi, lo, np.minimum(c, km.VALUE_MAX).astype(np.uint32)

    hi = np.concatenate([r[0] for r in runs])
    lo = np.concatenate([r[1] for r in runs])
    c = np.concatenate([r[2] for r in runs]).astype(np.uint64)
    order = np.lexsort((lo, hi))
    hi, lo, c = hi[order], lo[order], c[order]
    new = np.empty(len(hi), dtype=bool)
    new[0:1] = True
    np.logical_or(hi[1:] != hi[:-1], lo[1:] != lo[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    csum = np.add.reduceat(c, starts) if len(starts) \
        else np.zeros(0, np.uint64)
    counts = np.minimum(csum, km.VALUE_MAX).astype(np.uint32)
    return hi[starts], lo[starts], counts


# runs that hold together at most this many entries go into a larger
# run by insert_runs rather than by a merge that rewrites it
INSERT_MAX = 1 << 12


def insert_runs(big, small_runs):
    """merge_runs([big] + small_runs) where the small runs hold few
    entries: a binary search a small key and one insertion pass over
    the big run, where the native merge copies every entry of it
    through its staging buffers and back (a sharded count's owner
    takes its few captured windows so: about 0.5 s an owner of 26 M
    entries, and only in counts that captured a window)."""
    shi, slo, sc = merge_runs(list(small_runs))
    hi, lo, c = big
    if not len(sc) or not len(c):
        return merge_runs([r for r in (big, (shi, slo, sc)) if len(r[2])])
    i0 = np.searchsorted(hi, shi, "left")
    i1 = np.searchsorted(hi, shi, "right")
    pos = np.fromiter((a + np.searchsorted(lo[a:b], key)
                       for a, b, key in zip(i0, i1, slo)),
                      np.int64, len(slo))
    at = np.minimum(pos, len(c) - 1)
    hit = (pos < len(c)) & (hi[at] == shi) & (lo[at] == slo)
    new = ~hit
    vmax = np.uint64(km.VALUE_MAX)
    out = np.minimum(c, vmax).astype(np.uint32)
    out[pos[hit]] = np.minimum(c[pos[hit]] + sc[hit].astype(np.uint64),
                               vmax)
    if new.any():
        # each new key goes before the entry at its position
        if hi[-1] or shi.any():
            hi = np.insert(hi, pos[new], shi[new])
        else:   # one-word keys: hi is zeros, left untouched until read
            hi = np.zeros(len(hi) + int(new.sum()), np.uint64)
        lo = np.insert(lo, pos[new], slo[new])
        out = np.insert(out, pos[new], sc[new])
    return hi, lo, out


# one-card finalizes by path (the native pass of csrc/finalize_host.cpp,
# or numpy), and the small-run entries the native pass merged, since the
# process began
FINALIZE_STATS = {"native": 0, "numpy": 0, "merged": 0}
_stats_lock = threading.Lock()
_finalize_lib = None     # the native pass; False once it failed to build
# threads of the native finalize pass: on an H100 host's 8 cores four
# fill a 16 M-entry download in half the time of one, and eight gain
# nothing more (tools/ab_finalize.py)
FINALIZE_THREADS = 4


def _native_finalize():
    """The native finalize pass (csrc/finalize_host.cpp), built at first
    use, or None when it cannot be built or MERYL_TPU_NO_NATIVE is
    set."""
    global _finalize_lib
    if _os.environ.get("MERYL_TPU_NO_NATIVE"):
        return None
    if _finalize_lib is None:
        try:
            lib = _build.load("finalize_host", ".cpp")
        except (OSError, RuntimeError):
            _finalize_lib = False
        else:
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.mt_finalize_plan.argtypes = [p, i64, i32, p, p, i64, p, p,
                                             i32]
            lib.mt_finalize_plan.restype = i64
            lib.mt_finalize_fill.argtypes = [p, p, i64, i32, p, p, p, i64,
                                             p, p, p, p, p, i32]
            lib.mt_finalize_fill.restype = None
            _finalize_lib = lib
    return _finalize_lib or None


def finalize_dense(lib, keys, counts, small, threads: int = 1):
    """The dense download as fetched (keys: (n,) or (n, 2) int64 words,
    each unsigned word ^ 2^63; counts: (n,) uint32) with one small
    sorted unique run (hi, lo, counts) merged in, in one native pass
    -> sorted unique (hi, lo, counts-u32): what mw.to_hilo, merge_runs
    of the two and its clamp give, written once.  A binary search
    places each small key; `threads` fill disjoint ranges of the
    download."""
    keys = np.ascontiguousarray(keys, np.int64)
    counts = np.ascontiguousarray(counts, np.uint32)
    words = 1 if keys.ndim == 1 else 2
    n = len(counts)
    shi = np.ascontiguousarray(small[0], np.uint64)
    slo = np.ascontiguousarray(small[1], np.uint64)
    sc = np.minimum(small[2], km.VALUE_MAX).astype(np.uint32)
    m = len(sc)
    pos = np.empty(m, np.int64)
    hit = np.empty(m, np.uint8)
    out = n + lib.mt_finalize_plan(keys.ctypes.data, n, words,
                                   shi.ctypes.data, slo.ctypes.data, m,
                                   pos.ctypes.data, hit.ctypes.data, threads)
    # one-word keys: hi stays zeros, as mw.to_hilo leaves it
    hi = np.zeros(out, np.uint64) if words == 1 else np.empty(out, np.uint64)
    lo = np.empty(out, np.uint64)
    c = np.empty(out, np.uint32)
    lib.mt_finalize_fill(keys.ctypes.data, counts.ctypes.data, n, words,
                         shi.ctypes.data, slo.ctypes.data, sc.ctypes.data, m,
                         pos.ctypes.data, hit.ctypes.data,
                         None if words == 1 else hi.ctypes.data,
                         lo.ctypes.data, c.ctypes.data, threads)
    return hi, lo, c


def _unique_run(hi, lo):
    """Raw (hi, lo) windows -> one sorted unique run with counts."""
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    new = np.empty(len(hi), bool)
    new[:1] = True
    np.logical_or(hi[1:] != hi[:-1], lo[1:] != lo[:-1], out=new[1:])
    st = np.flatnonzero(new)
    cnt_ = np.diff(np.append(st, len(hi))).astype(np.uint64)
    return hi[st], lo[st], cnt_


# a download at least this large goes through a pinned host buffer
PIN_MIN_BYTES = 1 << 20


def _to_host(x: torch.Tensor) -> np.ndarray:
    """Device tensor -> numpy.  A large CUDA tensor is copied into a
    pinned (page-locked) host buffer with one asynchronous copy and one
    synchronize; a small one, or a CPU tensor, takes the plain path."""
    if x.is_cuda and x.numel() * x.element_size() >= PIN_MIN_BYTES:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        torch.cuda.current_stream(x.device).synchronize()
        return host.numpy()
    return x.cpu().numpy()


def prepack(codes: np.ndarray, chunk_len: int):
    """Pad one chunk to chunk_len and 2-bit-pack it:
    -> (codes, packed2, exc, n_real, n_orig), what
    DeviceAccCounter.add_codes takes."""
    n_orig = len(codes)
    if n_orig < chunk_len:
        codes = np.concatenate(
            [codes, np.full(chunk_len - n_orig, SEP, np.uint8)])
    packed2, exc, n_real = km.pack_codes_2bit(codes, pad_to=chunk_len)
    return (codes, packed2, exc, n_real, n_orig)


def acc_bytes_per_unique(k: int) -> int:
    """Device bytes the accumulator path budgets for each accumulator
    slot (each expected unique): the int64 tensors that merge_cells
    holds at its peak, 4 shaped like the keys (W words) and 10 like the
    positions, and 3 more index tensors for a two-word sort.  112 at
    k <= 32, where an H100's peak grows by 114-115 B a slot
    (PERF.md)."""
    w = mw.num_words(k)
    return 8 * (4 * w + 10 + 3 * (w - 1))


def acc_cap_bytes(device) -> int:
    """The accumulator's device-memory budget: MERYL_TPU_ACC_CAP_GB when
    set, else half the card's memory, or 4 GB for device=cpu."""
    env = _os.environ.get("MERYL_TPU_ACC_CAP_GB")
    if env:
        return int(float(env) * 1e9)
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory // 2
    return 4 * 10 ** 9


class AccCapacity(Exception):
    """The accumulator would outgrow its device-memory budget: the
    driver salvages the device state exactly and finishes on the host
    path."""


class DeviceAccCounter:
    """Single-device accumulator counting driver (ops/accum.py): the
    device keeps the running sorted-unique (kmer, count) set; the host
    downloads only the final uniques.

    Correctness hatches (all exact):
      * cell overflow: a few overflow windows per routing row are
        captured and counted on the host; past OVF_CAP the chunk is
        recounted on the host path
      * accumulator row overflow: the merge is re-run with a grown row
        capacity (the old accumulator and staged cells stay alive until
        the new one is verified)
      * capacity: past the MERYL_TPU_ACC_CAP_GB budget, AccCapacity;
        salvage() rescues the device state exactly
      * the all-ones k-mer (real when 2k % 32 == 0) is counted by a
        device scalar and appended at finalize

    The final download is dense: the used entries' keys as they are
    and their counts narrowed to 32 bits, in one device buffer that
    crosses through pinned host memory in one copy (download).
    """

    def __init__(self, k: int, mode: str, chunk_len: int,
                 expected_uniques: int, device="cuda"):
        self.device = resolve_device(device)
        self.k = int(k)
        self.P = km.num_planes(self.k)
        self.mode = mode
        self.chunk_len = int(chunk_len)
        if self.chunk_len % 16:
            raise ValueError(f"chunk_len must be a multiple of 16, got "
                             f"{chunk_len}")
        plan = accum.plan_route(self.chunk_len, self.k,
                                max(1, expected_uniques))
        self.B = plan["B"]
        self.M = plan["M"]
        self.La = plan["La0"]
        self.cfg = (self.k, self.P, mode, self.B, plan["R0"],
                    plan["L0"], plan["c"], plan["bits"])
        self._acc = None
        self._unverified = None
        self._staged = []          # routed cell tensors awaiting merge
        self._pending = []         # (cells, ovf, n_ovf_row, codes,
        #                             n_allones scalar)
        self._nallones = []        # device scalars, fetched at the end
        self._fallback_runs = []   # host-counted overflow chunks
        self._ovf_keys = []        # captured cell-overflow windows
        self._cap_bytes = acc_cap_bytes(self.device)
        self._max_run = None       # largest row of the last merge
        self.n_chunks = 0
        self.n_merges = 0
        self.n_regrows = 0
        self.n_recounts = 0
        self.n_captured = 0
        self.wire_h2d_bytes = 0
        self.wire_d2h_bytes = 0
        self._bases_seen = 0
        self.download_s = 0.0      # the last download's whole span
        # every host<->device interaction runs in a span
        # (trace.LAST_SPANS: count.h2d, count.dispatch, count.fetch)

    def _put(self, x: np.ndarray):
        with trace.span("count.h2d"):
            return torch.from_numpy(x).to(self.device)

    def _dispatch(self, fn, *args, **kw):
        with trace.span("count.dispatch"):
            return fn(*args, **kw)

    def _fetch(self, x: torch.Tensor) -> np.ndarray:
        with trace.span("count.fetch"):
            return _to_host(x)

    def _fetch_int(self, x: torch.Tensor) -> int:
        with trace.span("count.fetch"):
            return int(x)

    def _tail(self):
        return () if mw.num_words(self.k) == 1 else (2,)

    def _fresh_acc(self, la):
        key = mw.sentinel(self.k, self.device).expand(
            (self.B, la) + self._tail()).clone()
        return key, torch.zeros((self.B, la), dtype=torch.int64,
                                device=self.device)

    def _grow(self, acc, la):
        """Pad an accumulator to row capacity la."""
        pad_key, pad_cnt = self._fresh_acc(la - acc[1].shape[1])
        return (torch.cat([acc[0], pad_key], dim=1),
                torch.cat([acc[1], pad_cnt], dim=1))

    def prepack(self, codes: np.ndarray):
        """Pad + 2-bit-pack one chunk for add_codes; runs on the
        prefetch reader thread, so the pack overlaps device work."""
        return prepack(codes, self.chunk_len)

    def add_codes(self, codes):
        """codes: (chunk_len,) uint8 host codes, or a prepack() tuple."""
        if isinstance(codes, tuple):
            codes, packed2, exc, n_real, n_orig = codes
            self._bases_seen += int(n_orig)
        else:
            self._bases_seen += int(len(codes))
            if len(codes) < self.chunk_len:
                codes = np.concatenate(
                    [codes, np.full(self.chunk_len - len(codes), SEP,
                                    np.uint8)])
            with trace.span("count.host_pack"):
                packed2, exc, n_real = km.pack_codes_2bit(
                    codes, pad_to=self.chunk_len)
        self.n_chunks += 1
        self.wire_h2d_bytes += packed2.nbytes + exc.nbytes
        cells, ovf, n_ovf_row, n_allones = self._dispatch(
            accum.route_chunk_packed, self._put(packed2.view(np.int32)),
            self._put(exc), n_real, self.cfg)
        # n_allones travels WITH the pending chunk: it is committed only
        # when the chunk's cells are staged — a host-path recount counts
        # the all-ones k-mer itself, so committing eagerly double-counts
        self._pending.append((cells, ovf, n_ovf_row, codes, n_allones))
        # overflow counts are checked in a batch at merge cadence; the
        # raw codes stay until their check clears, so an overflowed
        # chunk can still be recounted exactly
        if len(self._pending) >= self.M:
            self._resolve_batch()
        if len(self._staged) >= self.M:
            self._merge()

    def _resolve_batch(self):
        """Resolve every pending chunk with one fetch of all their
        overflow-row counts and one of every needed capture region."""
        if not self._pending:
            return
        stacked = self._fetch(self._dispatch(
            torch.stack, [item[2] for item in self._pending]))
        need = [i for i in range(len(self._pending))
                if 0 < int(stacked[i].max(initial=0)) <= accum.OVF_CAP]
        ovf_np = {}
        if need:
            ov = self._fetch(self._dispatch(
                torch.stack, [self._pending[i][1] for i in need]))
            for j, i in enumerate(need):
                ovf_np[i] = ov[j]
        for i, item in enumerate(self._pending):
            self._resolve(item, stacked[i], ovf_np.get(i))
        self._pending = []

    def _resolve(self, item, nrow, ovf_np):
        cells, _, _, codes, n_allones = item
        mx = int(nrow.max()) if len(nrow) else 0
        if mx > accum.OVF_CAP:
            # a capture row overflowed: recount this chunk on the host
            # path and drop its cells and its all-ones scalar
            self.n_recounts += 1
            self._fallback_runs.extend(_finish_chunk(
                *_count_chunk(codes, self.k, self.mode, self.device)))
            return
        self._nallones.append(n_allones)
        if mx > 0:
            # the overflowed windows sit at the head of each capture row
            for r in np.flatnonzero(nrow):
                n = int(nrow[r])
                self._ovf_keys.append(ovf_np[r, :n].copy())
                self.n_captured += n
        self._staged.append(cells)

    def _staged_bytes(self, staged):
        return sum(s.numel() * s.element_size() for s in staged)

    def _merge(self):
        """Dispatch a merge of the staged cells and DEFER its row
        overflow check to the next merge (or finalize / salvage), so the
        device folds while the host packs the next chunks.  The
        pre-merge accumulator and the staged cells stay alive in
        _unverified until the check clears."""
        if self._acc is None:
            self._acc = self._fresh_acc(self.La)
        self._verify_merge()
        staged = tuple(self._staged)
        key, counts, n_runs = self._dispatch(
            accum.merge_cells, self._acc[0], self._acc[1], staged, self.k,
            self.La, int(km.VALUE_MAX))
        self.n_merges += 1
        self._unverified = (key, counts, n_runs, self._acc, staged,
                            self.La)
        self._acc = (key, counts)  # optimistic: overflow is rare
        self._staged = []

    def _verify_merge(self):
        """Resolve the previous deferred merge: fetch its largest row
        and, on a row overflow, regrow against the preserved pre-merge
        accumulator.  On AccCapacity the pre-merge state (old acc +
        staged cells) is restored so salvage() rescues exactly what
        existed before the merge."""
        uv = self._unverified
        if uv is None:
            return
        self._unverified = None
        _, _, n_runs, old_acc, staged, la_then = uv
        del uv  # a truncated merge result must not stay alive in a regrow
        hi = self._fetch_int(n_runs.max())
        if hi <= la_then:
            self._max_run = hi
            return
        self._acc = None  # drop the truncated merge result
        held = (self._staged_bytes(staged) + old_acc[0].numel() * 8
                + old_acc[1].numel() * 8)
        la = la_then
        while True:
            new_la = la
            while new_la < hi:
                new_la *= 2
            # the merge's working set plus what stays alive meanwhile:
            # the old accumulator and the staged cells
            need = new_la * self.B * acc_bytes_per_unique(self.k) + held
            if need > self._cap_bytes:
                self._acc = old_acc
                self.La = la_then
                self._staged = list(staged) + self._staged
                raise AccCapacity()
            la = new_la
            self.n_regrows += 1
            key, counts, n_runs = self._dispatch(
                accum.merge_cells, *self._grow(old_acc, la), staged,
                self.k, la, int(km.VALUE_MAX))
            hi = self._fetch_int(n_runs.max())
            if hi <= la:
                break
        self.La = la
        self._max_run = hi
        self._acc = (key, counts)

    def _allones_run(self, n):
        twok = 2 * self.k
        return (np.array([(1 << max(0, twok - 64)) - 1], np.uint64),
                np.array([(1 << min(64, twok)) - 1], np.uint64),
                np.array([n], np.uint64))

    def _capture_run(self):
        """Captured overflow windows (count 1 each) as one unique run;
        sentinel-keyed entries are capture padding and drop."""
        hi, lo = mw.to_hilo(np.concatenate(self._ovf_keys), self.k)
        s_hi, s_lo = mw.sentinel_hilo(self.k)
        real = ~((hi == np.uint64(s_hi)) & (lo == np.uint64(s_lo)))
        self._ovf_keys = []
        return _unique_run(hi[real], lo[real])

    def salvage(self):
        """Exact device-state rescue after AccCapacity: download the
        accumulator and every staged cell group, count them on the
        host, and return the run list — the driver finishes the rest of
        the input on the host path and union-merges everything."""
        self._resolve_batch()
        try:
            self._verify_merge()
        except AccCapacity:
            pass  # pre-merge acc + staged cells restored by the raise
        runs = list(self._fallback_runs)
        self._fallback_runs = []
        if self._acc is not None:
            keys = self._fetch(self._acc[0].reshape(
                (-1,) + self._tail()))
            counts = self._fetch(self._acc[1].reshape(-1))
            keepm = counts > 0
            hi, lo = mw.to_hilo(keys[keepm], self.k)
            runs.append((hi, lo, counts[keepm].astype(np.uint64)))
            self._acc = None
        s_hi, s_lo = mw.sentinel_hilo(self.k)
        for cells in self._staged:
            hi, lo = mw.to_hilo(self._fetch(cells.reshape(
                (-1,) + self._tail())), self.k)
            real = ~((hi == np.uint64(s_hi)) & (lo == np.uint64(s_lo)))
            runs.append(_unique_run(hi[real], lo[real]))
        self._staged = []
        if self._ovf_keys:
            runs.append(self._capture_run())
        n_allones = sum(self._fetch_int(x) for x in self._nallones)
        self._nallones = []
        if n_allones:
            runs.append(self._allones_run(n_allones))
        return runs

    def download_lmax(self) -> int:
        """Columns of the accumulator the download takes: the used row
        prefix (the accumulator is sized from an over-estimate),
        quantized like the row capacity."""
        return min(self.La, accum._eighth_round(
            max(256, self._max_run or self.La)))

    def download(self, decode: bool = True):
        """The accumulator as one sorted unique (hi, lo, counts-u64)
        run, or with decode False as fetched (_download_dense)."""
        return self._download_dense(self.download_lmax(), decode)

    def _download_dense(self, lmax: int, decode: bool = True):
        """Dense download: the used entries (count > 0) are compacted on
        the device in row order, which is key order; their key words
        and their counts, narrowed to 32-bit patterns (counts saturate
        at the 32-bit VALUE_MAX in merge_cells), are laid out in ONE
        int32 device buffer that crosses in one copy.  The host only
        reinterprets it: decoded to (hi, lo, counts-u64), or with
        decode False left as (int64 key words, u32 counts) views of the
        fetched buffer, which finalize_dense reads in place."""
        key, counts = self._acc[0][:, :lmax], self._acc[1][:, :lmax]
        keep = counts > 0
        ukey = key[keep]
        n = ukey.shape[0]
        nk = n * 2 * mw.num_words(self.k)      # int32 slots of the keys
        buf = torch.empty(nk + n, dtype=torch.int32, device=self.device)
        buf[:nk].view(torch.int64).view(ukey.shape).copy_(ukey)
        buf[nk:].copy_(counts[keep])
        host = self._fetch(buf)
        self.wire_d2h_bytes += host.nbytes
        with trace.span("count.host_decode"):
            keys = host[:nk].view(np.int64).reshape((n,) + self._tail())
            if not decode:
                return keys, host[nk:].view(np.uint32)
            hi, lo = mw.to_hilo(keys, self.k)
            return hi, lo, host[nk:].view(np.uint32).astype(np.uint64)

    def finalize(self):
        """-> sorted unique (hi, lo, counts-u32).  The download, decoded
        and merged with the captured windows, the host-counted chunks
        and the all-ones k-mer in one native pass (finalize_dense), or
        where it is not built decoded and merged by numpy."""
        self._resolve_batch()
        if self._staged:
            self._merge()
        self._verify_merge()
        n_allones = 0
        if self._nallones:
            n_allones = self._fetch_int(torch.stack(self._nallones).sum())

        lib = _native_finalize()
        runs = list(self._fallback_runs)
        dense = None
        if self._acc is not None:
            with trace.span("count.download") as sp:
                dense = self.download(decode=lib is None)
            self.download_s = sp.seconds
        # the host merge as a leaf of its own: a trace's gap past the
        # download's many operators is then still named after finalize
        with trace.span("count.finalize"):
            if self._ovf_keys:
                runs.append(self._capture_run())
            if lib is not None:
                return self._finalize_native(lib, dense, runs, n_allones)
            with _stats_lock:
                FINALIZE_STATS["numpy"] += 1
            if dense is not None:
                runs.insert(0, dense)
            hi, lo, counts = merge_runs(runs)
            if n_allones:
                ao_hi, ao_lo, _ = self._allones_run(0)
                n = min(n_allones, int(km.VALUE_MAX))
                if len(lo) and hi[-1] == ao_hi[0] and lo[-1] == ao_lo[0]:
                    counts[-1] = min(int(counts[-1]) + n,
                                     int(km.VALUE_MAX))
                else:
                    hi = np.append(hi, ao_hi)
                    lo = np.append(lo, ao_lo)
                    counts = np.append(counts, np.uint32(n))
            return hi, lo, counts

    def _finalize_native(self, lib, dense, runs, n_allones):
        """finalize's merge in one native pass: the small runs (the
        captured windows, the host-counted chunks, the all-ones k-mer)
        merged first by merge_runs, then into the dense download as it
        was fetched."""
        if n_allones:
            runs.append(self._allones_run(n_allones))
        small = merge_runs(runs)
        if dense is None:
            dense = (np.zeros((0,) + self._tail(), np.int64),
                     np.zeros(0, np.uint32))
        with _stats_lock:
            FINALIZE_STATS["native"] += 1
            FINALIZE_STATS["merged"] += len(small[2])
        return finalize_dense(lib, *dense, small, min(
            FINALIZE_THREADS, len(_os.sched_getaffinity(0))))


def device_bytes_per_base(k: int) -> int:
    """Device bytes the host sort path holds for each base of a chunk,
    from the program's structure (W = int64 words a key): the extracted
    key and its masked copy (2 x 8W), the sorted keys with the sort's
    int64 indices and its double buffer (8W + 8 + 8W + 8), the previous
    chunk's sorted keys awaiting the host in the 1-deep pipeline (8W),
    the valid and start masks (2); two words sort in two stable passes
    and hold three more index-sized temporaries (24).  On an H100 a
    2^22 chunk at k=21 peaks at 42 B a base (PERF.md)."""
    w = mw.num_words(k)
    return 40 * w + 18 + 24 * (w - 1)


def device_memory_gb(device) -> float:
    """Memory of the counting device in GB: MERYL_TPU_HBM_GB when set,
    else the card's total memory, or the host's physical memory for
    device=cpu."""
    env = _os.environ.get("MERYL_TPU_HBM_GB")
    if env:
        return float(env)
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory / 1e9
    from .resources import physical_memory_bytes
    return physical_memory_bytes() / 1e9


def expected_kmers(paths) -> int:
    """K-mers guessed from file sizes: x1 plain, x3 gz, x3.5 bz2, x4
    xz."""
    if isinstance(paths, str):
        paths = [paths]
    exp = 0
    for p in paths:
        sz = _os.path.getsize(p)
        with open(p, "rb") as f:
            magic = f.read(6)
        if magic[:2] == b"\x1f\x8b":
            exp += sz * 3
        elif magic[:3] == b"BZh":
            exp += int(sz * 3.5)
        elif magic[:6] == b"\xfd7zXZ\x00":
            exp += sz * 4
        else:
            exp += sz
    return int(exp)


def configure_counting(paths, k: int, memory_gb: float | None = None,
                       chunk_len: int | None = None,
                       hbm_gb: float | None = None,
                       device="cuda") -> dict:
    """Counting plan: expected k-mers, device chunk size, batch count.

    Expected k-mers are guessed from file sizes x1 (plain) / x3 (gz) /
    x3.5 (bz2) / x4 (xz); the device chunk is the largest power of two
    whose pipeline (device_bytes_per_base) fits half the device's
    memory (hbm_gb, default device_memory_gb(device)); the batch count
    bounds the host memory of the merged unique set by memory_gb
    (default resources.max_memory_gb()).  One device: `devices` is 1
    and `sharded` false."""
    exp = expected_kmers(paths)
    hbm = hbm_gb if hbm_gb is not None else device_memory_gb(device)
    dev_bpb = device_bytes_per_base(k)
    fit = int(hbm * 1e9 * 0.5 / dev_bpb)
    max_chunk = 1 << max(16, fit.bit_length() - 1)
    if chunk_len is None:
        chunk_len = min(default_chunk(), max_chunk)
    else:
        chunk_len = min(chunk_len, max_chunk)

    bytes_per_kmer = 8 + 8 + 4  # hi, lo, count on host
    if memory_gb is None:
        from .resources import max_memory_gb
        memory_gb = max_memory_gb()
    n_batches = max(1, int(np.ceil(exp * bytes_per_kmer
                                   / (memory_gb * 1e9))))
    return {
        "k": k,
        "expected_kmers": int(exp),
        "chunk_len": int(chunk_len),
        "device_bytes_per_base": dev_bpb,
        "device_chunk_hbm_bytes": int(chunk_len) * dev_bpb,
        "hbm_gb": hbm,
        "devices": 1,
        "sharded": False,
        "host_bytes_per_kmer": bytes_per_kmer,
        "memory_gb": memory_gb,
        "host_peak_bytes": int(min(exp, np.ceil(exp / n_batches)) *
                               bytes_per_kmer),
        "batches": n_batches,
        "batch_bases": int(np.ceil(exp / n_batches)),
    }


def _acc_admits(expected: int, k: int, device) -> bool:
    """Whether `expected` k-mers (a file-size guess) fit the
    accumulator's budget; the 0.35 FASTQ/dedup discount is the one the
    accumulator sizes itself with.  If the uniques outgrow the budget
    mid-run all the same, AccCapacity salvages the device state."""
    return expected * 0.35 * acc_bytes_per_unique(k) <= \
        acc_cap_bytes(device)


def _use_device_acc(paths, k, device, count_suffix=None) -> int:
    """Expected-uniques estimate when the device-accumulator path
    should run, else 0.  A count-suffix takes the host sort path (the
    filter is not part of the routed step).  MERYL_TPU_DEVICE_ACC=1/0
    forces; auto = on for a CUDA device when the expected unique set
    fits the accumulator budget."""
    if count_suffix is not None:
        return 0
    env = _os.environ.get("MERYL_TPU_DEVICE_ACC", "auto")
    if env == "0":
        return 0
    try:
        exp = min(expected_kmers(paths), 4 ** k if k < 32 else 1 << 63)
    except OSError:
        return 0
    if env == "1":
        return max(1, exp)
    if resolve_device(device).type != "cuda" or \
            not _acc_admits(exp, k, device):
        return 0
    return max(1, exp)


# wire volumes and sync counts of the most recent device-accumulator
# run (same keys as meryl_tpu.counter.LAST_WIRE_STATS)
LAST_WIRE_STATS: dict = {}


def _acc_counters(acc) -> dict:
    """A device accumulator's own counters, which LAST_WIRE_STATS sums
    over a count's accumulators (one, or one a batch)."""
    return {"h2d_bytes": acc.wire_h2d_bytes, "d2h_bytes": acc.wire_d2h_bytes,
            "t_download_s": acc.download_s, "chunks": acc.n_chunks,
            "merges": acc.n_merges, "regrows": acc.n_regrows,
            "recounts": acc.n_recounts, "captured": acc.n_captured}


def _publish_wire_stats(sp: dict, accs: dict, *, bases: int,
                        t_finalize_s: float, salvaged: bool,
                        native_packs: int):
    """LAST_WIRE_STATS of a count: `sp` its spans (trace.since), `accs`
    its accumulators' counters (_acc_counters, summed; a missing key
    reads 0), `bases` the codes read, `t_finalize_s` the finalize
    spans' whole seconds."""
    def s(name):
        return round(sp.get(f"count.{name}_s", 0.0), 4)

    def n(name):
        return sp.get(f"count.{name}_n", 0)

    LAST_WIRE_STATS.clear()
    LAST_WIRE_STATS.update(
        h2d_bytes=accs["h2d_bytes"], d2h_bytes=accs["d2h_bytes"],
        bases=bases, scan_stall_s=s("wait_reader"),
        reader_busy_s=round(s("reader_scan") + s("reader_pack"), 4),
        t_finalize_s=round(t_finalize_s, 4),
        n_h2d=n("h2d"), n_dispatch=n("dispatch"), n_fetch=n("fetch"),
        t_h2d_s=s("h2d"), t_dispatch_s=s("dispatch"), t_fetch_s=s("fetch"),
        host_pack_s=s("host_pack"), host_finalize_s=s("host_decode"),
        t_download_s=round(accs["t_download_s"], 4),
        chunks=accs["chunks"], merges=accs["merges"],
        regrows=accs["regrows"], recounts=accs["recounts"],
        captured=accs["captured"], salvaged=salvaged,
        # native 2-bit packs: one a chunk, one more a recounted chunk
        native_packs=native_packs)


def _prefetch_chunks(chunker, depth: int = 2, transform=None):
    """Iterate a SequenceChunker through a small queue fed by a reader
    thread: the file scan and the per-chunk `transform` (the 2-bit
    pack) overlap the device work.  Reader errors re-raise here.  When
    the consumer stops early (an error, close()), the reader ends too.
    The reader's spans (count.reader_scan, count.reader_pack) reach
    trace.LAST_SPANS before the consumer sees the end."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    DONE = object()
    stop = threading.Event()

    def _reader():
        try:
            with trace.thread_spans():
                it = iter(chunker)
                while not stop.is_set():
                    with trace.span("count.reader_scan"):
                        c = next(it, DONE)
                    if c is DONE:
                        break
                    if transform is not None:
                        with trace.span("count.reader_pack"):
                            c = transform(c)
                    q.put(c)
            q.put(DONE)
        except BaseException as e:  # surface reader errors, then stop
            q.put(e)

    t = threading.Thread(target=_reader, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # a reader blocked on the full queue is freed by draining it
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass


def count_to_arrays_device_acc(paths, k: int, mode: str, hpc: bool,
                               chunk_len: int, expected_uniques: int,
                               progress=None, device="cuda", segment=None):
    acc = DeviceAccCounter(k, mode, chunk_len, expected_uniques, device)
    spans0 = dict(trace.LAST_SPANS)
    packs0 = km.PACK_STATS["native"]
    nbases = 0
    it = iter(_prefetch_chunks(SequenceChunker(paths, k, chunk_len,
                                               hpc=hpc, segment=segment),
                               depth=4, transform=acc.prepack))
    salvage_runs = None
    while True:
        with trace.span("count.wait_reader"):  # the loop blocked on it
            chunk = next(it, None)
        if chunk is None:
            break
        try:
            acc.add_codes(chunk)
        except AccCapacity:
            # the unique set outgrew the budget: rescue the device state
            # exactly and finish the stream on the host sort path
            salvage_runs = acc.salvage()
            break
        nbases += chunk[4]
        if progress:
            progress(nbases)
    with trace.span("count.finalize") as fin:
        if salvage_runs is not None:
            runs = salvage_runs
            for chunk in it:
                # prepack() built the wire on the reader thread already
                wire = _wire_tensors(chunk[1], chunk[2], acc.device)
                runs.extend(_finish_chunk(*_count_chunk(
                    wire + (chunk[3],), k, mode, acc.device)))
                acc.n_chunks += 1
                nbases += chunk[4]
                if progress:
                    progress(nbases)
            out = merge_runs(runs)
        else:
            try:
                out = acc.finalize()
            except AccCapacity:  # the final merge itself outgrew the budget
                salvage_runs = acc.salvage()
                out = merge_runs(salvage_runs)
    _publish_wire_stats(trace.since(spans0), _acc_counters(acc),
                        bases=nbases, t_finalize_s=fin.seconds,
                        salvaged=salvage_runs is not None,
                        native_packs=km.PACK_STATS["native"] - packs0)
    return out


def _check_count_args(k: int, mode: str):
    if not 1 <= k <= km.K_MAX:
        raise ValueError(f"k must be in [1, {km.K_MAX}], got {k}")
    if mode not in ("canonical", "forward", "reverse"):
        raise ValueError(f"mode must be canonical, forward or reverse, "
                         f"got {mode!r}")


def _in_job() -> bool:
    """Whether this process is a rank of a launcher job
    (MERYL_TPU_COORD) or already has a torch.distributed group."""
    from .parallel import multihost as mh
    if mh.env_requested():
        return True
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _use_sharded(count_suffix, device) -> bool:
    """Whether counting runs the sharded path (meryl_tpu/counter.py
    _use_sharded): MERYL_TPU_SHARDED=1 forces it, 0 turns it off, and
    auto (the default) is on when device is cuda and this process has
    more than one card: every card it sees, or in a launcher job its
    MERYL_TPU_LOCAL_DEVICES.  A count-suffix is not part of the routed
    step and is never sharded."""
    if count_suffix is not None:
        return False
    env = _os.environ.get("MERYL_TPU_SHARDED", "auto")
    if env == "0":
        return False
    if env == "1":
        return True
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return False
    if _in_job():
        from .parallel import multihost as mh
        return mh.local_device_count() > 1
    return torch.cuda.device_count() > 1


def shard_devices(device) -> list:
    """The devices of this process's sharded count: on cuda every
    visible card once; on cpu MERYL_TPU_LOCAL_DEVICES members (the
    reference's virtual CPU devices a process, default 1)."""
    dev = resolve_device(device)
    env = _os.environ.get("MERYL_TPU_LOCAL_DEVICES")
    if dev.type == "cuda":
        if env:
            raise ValueError(
                "MERYL_TPU_LOCAL_DEVICES sets virtual CPU devices "
                "(device=cpu); with device=cuda the sharded count takes "
                "every visible card")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev] * int(env or 1)


class _Dealer:
    """Deals one chunk stream out to the members of a group, a step at
    a time: step s gives chunk s * n + d to member d, and a short last
    step is padded with `pad` (the empty prepacked chunk).  The first
    member to ask for a step reads it; every member sees the same end
    (None) and the same reader error."""

    def __init__(self, chunks, n: int, pad, progress=None):
        import threading
        self._chunks = chunks
        self._n = n
        self._pad = pad
        self._progress = progress
        self._lock = threading.Lock()
        self._steps: dict = {}   # step -> [chunks or None, takers left]
        self._error = None
        self.nbases = 0

    def take(self, step: int, rank: int):
        with trace.span("shard.wait_dealer"), self._lock:
            if self._error is not None:
                raise self._error
            if step not in self._steps:
                try:
                    got = list(itertools.islice(self._chunks, self._n))
                except BaseException as e:
                    self._error = e
                    raise
                deal = None
                if got:
                    self.nbases += sum(c[4] for c in got)
                    deal = got + [self._pad] * (self._n - len(got))
                    if self._progress:
                        self._progress(self.nbases)
                self._steps[step] = [deal, self._n]
            entry = self._steps[step]
            entry[1] -= 1
            if not entry[1]:
                del self._steps[step]
            return None if entry[0] is None else entry[0][rank]


@contextlib.contextmanager
def _shard_group(device, devices):
    """The group of a sharded count in this process: a LocalGroup over
    `devices` (default shard_devices(device)); inside a launcher job (or
    a group the caller made) this process's part of the job, over its
    MERYL_TPU_LOCAL_DEVICES devices (multihost.job_group; a 1-rank group
    is made here when the job has none)."""
    import torch.distributed as dist

    from .parallel import multihost as mh
    from .parallel.local_group import LocalGroup
    from .parallel.shard_count import one_rank_group
    if devices is not None or not _in_job():
        yield LocalGroup(shard_devices(device) if devices is None
                         else devices)
        return
    devs = mh.local_devices(device)
    with one_rank_group(devs[0]):
        if dist.get_world_size() != 1:
            raise ValueError(
                f"a job of {dist.get_world_size()} processes counts "
                f"through count_to_db (each process reads its own "
                f"segment), not count_to_arrays_sharded")
        yield mh.job_group(devs)


def _count_members(group, paths, k: int, *, mode: str, hpc: bool,
                   chunk_len: int, progress, segment,
                   spill_dir: str | None = None, lockstep: bool = False,
                   **shard_kw):
    """Count `segment` of the input over this process's members of
    `group`: one reader, whose chunks a _Dealer deals out one a member a
    step (the reference's _feed_sharded), one ShardedCounter a member,
    settled at the end.  -> (the members' counters in member order,
    their owner_parts remaining; the bases read); LAST_SHARD_STATS is
    written.  With spill_dir, member r spills to spill_dir/m<r>.
    A member's spans (shard.wait_dealer, shard.step, shard.exchange,
    shard.settle) are counters of its thread, summed over the members
    into trace.LAST_SPANS.
    lockstep: the processes of a job read segments of their own, so a
    member whose process has no chunk left feeds the empty chunk (the
    keep-alive pad) until no member of the job has one (one all_reduce
    MIN over the group a step), and the collectives stay in step."""
    import functools

    from .parallel import shard_count as shc
    from .parallel.local_group import MIN

    if any(m.device.type == "cuda" for m in group.members):
        extract_cuda.build()  # once, before any member thread
    from . import native
    native.get_lib()
    chunks = _prefetch_chunks(
        SequenceChunker(paths, k, chunk_len, hpc=hpc, segment=segment),
        depth=max(4, 2 * len(group.members)),
        transform=functools.partial(prepack, chunk_len=chunk_len))
    pad = prepack(np.zeros(0, np.uint8), chunk_len)
    dealer = _Dealer(chunks, len(group.members), pad, progress)

    def member(m):
        sc = shc.ShardedCounter(
            k, chunk_len=chunk_len, mode=mode, group=m,
            spill_dir=None if spill_dir is None
            else _os.path.join(spill_dir, f"m{m.rank}"), **shard_kw)
        step = 0
        with trace.thread_spans():
            while True:
                chunk = dealer.take(step, m.local)
                if lockstep:
                    done = torch.tensor([int(chunk is None)],
                                        dtype=torch.int64, device=m.device)
                    m.all_reduce(done, MIN)
                    if done.item():
                        break
                elif chunk is None:
                    break
                sc.add_codes(pad if chunk is None else chunk)
                step += 1
            with trace.span("shard.settle"):
                sc.settle()
        return sc

    try:
        counters = group.run(member)
    finally:
        chunks.close()
    shc.publish_stats(counters)
    return counters, dealer.nbases


def _count_sharded(paths, k: int, *, mode: str, hpc: bool, chunk_len,
                   progress, segment, device, devices=None,
                   spill_dir: str | None = None, **shard_kw):
    """Count the whole input on the sharded path over this process's
    group (_shard_group).  -> the members' counters (_count_members)."""
    with _shard_group(device, devices) as group:
        return _count_members(
            group, paths, k, mode=mode, hpc=hpc,
            chunk_len=chunk_len or shard_default_chunk(),
            progress=progress, segment=segment, spill_dir=spill_dir,
            **shard_kw)[0]


def count_to_arrays_sharded(paths, k: int, mode: str = "canonical",
                            hpc: bool = False,
                            chunk_len: int | None = None, progress=None,
                            segment=None, device="cuda", devices=None,
                            **shard_kw):
    """Sharded counting in one process to sorted (hi, lo, counts): over
    `devices` (the reference's mesh=; devices may repeat), by default
    every visible card on cuda or MERYL_TPU_LOCAL_DEVICES members on cpu
    (shard_devices).  Owner ranges ascend with the member index, so the
    members' parts concatenate in order."""
    _check_count_args(k, mode)
    parts = [p for sc in _count_sharded(
        paths, k, mode=mode, hpc=hpc, chunk_len=chunk_len,
        progress=progress, segment=segment, device=device,
        devices=devices, **shard_kw) for p in sc.owner_parts()]
    if not parts:
        z = np.zeros(0, np.uint64)
        return z, z.copy(), np.zeros(0, np.uint32)
    return tuple(np.concatenate([p[i] for p in parts]) for i in (1, 2, 3))


def _use_multihost(count_suffix, segment) -> bool:
    """Whether count_to_db runs the multi-process path: the launcher's
    MERYL_TPU_COORD contract with more than one process, or a process
    group of several ranks that the caller made.  count-suffix and an
    explicit segment= count locally."""
    if count_suffix is not None or segment is not None:
        return False
    from .parallel import multihost as mh
    if mh.env_requested():
        return int(_os.environ.get("MERYL_TPU_NPROCS", "1")) > 1
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def count_to_arrays(paths, k: int, mode: str = "canonical",
                    hpc: bool = False, chunk_len: int | None = None,
                    progress=None, device="cuda",
                    count_suffix: str | None = None, segment=None):
    """Count k-mers in sequence files on `device` ("cuda" or
    "cpu"; no fallback from one to the other).  count_suffix: count
    only k-mers that end in these bases; segment=(a, b): only sequences
    with index % b == a - 1.  Returns sorted (hi, lo, counts)."""
    _check_count_args(k, mode)
    dev = resolve_device(device)
    if _use_sharded(count_suffix, dev):
        # the sharded path has its own default chunk: pass the caller's
        return count_to_arrays_sharded(paths, k, mode=mode, hpc=hpc,
                                       chunk_len=chunk_len,
                                       progress=progress, segment=segment,
                                       device=dev)
    chunk_len = chunk_len or default_chunk()
    exp_uniques = _use_device_acc(paths, k, dev, count_suffix)
    if exp_uniques:
        return count_to_arrays_device_acc(
            paths, k, mode=mode, hpc=hpc, chunk_len=chunk_len,
            expected_uniques=exp_uniques, progress=progress, device=dev,
            segment=segment)
    suffix = _parse_suffix(count_suffix, k)
    runs = []
    nbases = 0
    pending = None  # 1-deep pipeline: the device works on chunk i+1
    #                 while the host finishes chunk i
    for chunk in SequenceChunker(paths, k, chunk_len, hpc=hpc,
                                 segment=segment):
        result = _count_chunk(chunk, k, mode, dev, suffix)
        if pending is not None:
            runs.extend(_finish_chunk(*pending))
        pending = result
        nbases += len(chunk)
        if progress:
            progress(nbases)
    if pending is not None:
        runs.extend(_finish_chunk(*pending))
    return merge_runs(runs)


def count_to_db(paths, out_path: str, k: int, mode: str = "canonical",
                hpc: bool = False, chunk_len: int | None = None,
                progress=None, device="cuda",
                count_suffix: str | None = None, segment=None,
                memory_gb: float | None = None) -> MerylDB:
    """Count to a meryl DB.  In a job of several ranks (MERYL_TPU_COORD,
    or a group the caller made) every rank counts its segment and rank 0
    assembles the DB (parallel/multihost.py).  memory_gb is a real
    bound: when the plan says the merged unique set may pass it, the
    count runs out of core: in batches (count_to_db_batched), or on the
    sharded path with its accumulator spilling to disk; otherwise the
    plan's chunk size is used."""
    if _use_multihost(count_suffix, segment):
        from .parallel import multihost as mh
        _check_count_args(k, mode)
        if mh.env_requested():
            mh.init_from_env(device)
        return mh.count_to_db_multihost(paths, out_path, k, mode=mode,
                                        hpc=hpc, chunk_len=chunk_len,
                                        progress=progress, device=device,
                                        memory_gb=memory_gb)
    if memory_gb is not None and count_suffix is None:
        plan = configure_counting(paths, k, memory_gb, chunk_len,
                                  device=device)
        if plan["batches"] > 1:
            if _use_sharded(count_suffix, device):
                return _count_to_db_sharded_spill(
                    paths, out_path, k, mode=mode, hpc=hpc,
                    chunk_len=plan["chunk_len"], progress=progress,
                    segment=segment, device=device)
            return count_to_db_batched(
                paths, out_path, k, mode=mode, hpc=hpc,
                chunk_len=plan["chunk_len"], memory_gb=memory_gb,
                segment=segment, progress=progress, device=device)
        chunk_len = plan["chunk_len"]
    hi, lo, counts = count_to_arrays(paths, k, mode=mode, hpc=hpc,
                                     chunk_len=chunk_len,
                                     progress=progress, device=device,
                                     count_suffix=count_suffix,
                                     segment=segment)
    with trace.span("count.db_write"):
        return MerylDB.write(out_path, k, hi, lo, counts, mode=mode,
                             hpc=hpc)


def _count_to_db_sharded_spill(paths, out_path: str, k: int, *, mode: str,
                               hpc: bool, chunk_len: int, progress,
                               segment, device) -> MerylDB:
    """The sharded out-of-core count: accumulator spills go to DISK
    (`<out>.spills/m<member>`, removed at the end), and the DB is written
    bucket by bucket as the members' owner ranges stream out, one owner
    loaded and merged at a time, so host peak is one owner's merged
    range."""
    import shutil

    from .db import stream_sorted_parts

    _check_count_args(k, mode)
    spill_dir = out_path + ".spills"
    try:
        counters = _count_sharded(paths, k, mode=mode, hpc=hpc,
                                  chunk_len=chunk_len, progress=progress,
                                  segment=segment, device=device,
                                  spill_dir=spill_dir)
        return stream_sorted_parts(
            out_path, k, ((hi, lo, c) for sc in counters
                          for _, hi, lo, c in sc.owner_parts()),
            mode=mode, hpc=hpc)
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)


# what the most recent count_to_db_batched did: chunks seen, batches,
# the indices skipped as done by an earlier run, a dict a counted batch
# (bases, wall seconds, k-mers, whether the device accumulator carried
# it to the end), the whole seconds of the batches' flushes (t_flush_s)
# and of the final merge (t_merge_s), each partial DB's entries
# (partial_entries) and their sum, the merge's input (merge_entries)
LAST_BATCH_STATS: dict = {}


def count_to_db_batched(paths, out_path: str, k: int, *,
                        mode: str = "canonical", hpc: bool = False,
                        chunk_len: int | None = None,
                        batch_bases: int | None = None,
                        memory_gb: float | None = None,
                        segment=None, resume: bool = True,
                        progress=None, device="cuda") -> MerylDB:
    """Out-of-core, restartable counting.

    The input stream is split into batches of ~batch_bases; each batch
    is counted and written as a partial DB `<out>.batch<i>`, with a
    manifest `<out>.manifest.json` recording completion (same names and
    keys as meryl_tpu's, so a run begun by either package is resumed or
    refused alike).  Completed batches are skipped on resume; the final
    union-sum over the partials writes the output DB and removes them.
    """
    import json
    import shutil

    _check_count_args(k, mode)
    dev = resolve_device(device)
    chunk_len = chunk_len or default_chunk()
    if batch_bases is None:
        batch_bases = configure_counting(paths, k, memory_gb, chunk_len,
                                         device=dev)["batch_bases"]
    manifest_path = out_path + ".manifest.json"
    # chunk_len and segment are part of the resume identity: batch
    # boundaries are counted in chunks, so another chunk size (or input
    # segment) renames which bases "batch i" covers
    manifest = {"k": k, "mode": mode, "hpc": hpc,
                "batch_bases": batch_bases, "chunk_len": chunk_len,
                "segment": list(segment) if segment else None,
                "done": []}
    if resume and _os.path.exists(manifest_path):
        with open(manifest_path) as f:
            old = json.load(f)
        if all(old.get(key) == manifest[key]
               for key in ("k", "mode", "hpc", "batch_bases",
                           "chunk_len", "segment")):
            manifest["done"] = old.get("done", [])
    done_before = frozenset(manifest["done"])

    def save_manifest():
        with open(manifest_path, "w") as f:
            json.dump(manifest, f)

    chunks_per_batch = max(1, int(np.ceil(batch_bases / chunk_len)))

    # per-batch device accumulator: a batch is sized to fit, so its
    # dedup stays on the device.  The gate is _use_device_acc's, for
    # ONE batch's uniques; AccCapacity mid-batch salvages exactly and
    # that batch finishes on the host path (the next batch tries again)
    acc_exp = 0
    env_acc = _os.environ.get("MERYL_TPU_DEVICE_ACC", "auto")
    exp_b = min(batch_bases, 4 ** k if k < 32 else 1 << 63)
    if env_acc == "1" or (env_acc != "0" and dev.type == "cuda"
                          and _acc_admits(exp_b, k, dev)):
        acc_exp = max(1, exp_b)

    # deterministic: the manifest names a batch by its chunk indices, so
    # the chunk stream must be bit-reproducible.  The reader thread
    # packs the chunks of the batches still to count and passes only
    # the length of a skipped one
    seen = itertools.count()

    def transform(codes):
        if next(seen) // chunks_per_batch in done_before:
            return len(codes)
        return prepack(codes, chunk_len)

    chunks = _prefetch_chunks(
        SequenceChunker(paths, k, chunk_len, hpc=hpc, segment=segment,
                        deterministic=True), depth=4, transform=transform)

    batch_idx = 0
    runs = []
    acc = None
    nchunks = 0
    nbases = 0
    stats = {"batches": 0, "chunks": 0, "skipped": sorted(done_before),
             "counted": [], "t_flush_s": 0.0}
    cur = {"bases": 0, "t0": _time.perf_counter()}
    spans0 = dict(trace.LAST_SPANS)
    packs0 = km.PACK_STATS["native"]
    # LAST_WIRE_STATS of the whole count: each accumulator's counters
    # added as it is let go, and the host path's chunks
    wire = collections.Counter()
    t_finalize_s = 0.0
    salvaged = False

    def flush_batch(idx):
        nonlocal acc, t_finalize_s, salvaged
        if idx in manifest["done"]:
            acc = None
            return  # counted by an earlier run
        with trace.span("count.batch_flush") as flush:
            parts = list(runs)
            on_device = acc is not None and not parts
            with trace.span("count.finalize") as fin:
                if acc is not None:
                    try:
                        parts.append(acc.finalize())
                    except AccCapacity:  # the final merge outgrew it
                        parts.extend(acc.salvage())
                        on_device = False
                        salvaged = True
                    wire.update(_acc_counters(acc))
                    acc = None
                hi, lo, counts = parts[0] if len(parts) == 1 \
                    else merge_runs(parts)
            t_finalize_s += fin.seconds
            with trace.span("count.db_write"):
                MerylDB.write(f"{out_path}.batch{idx}", k, hi, lo, counts,
                              mode=mode, hpc=hpc)
            manifest["done"].append(idx)
            save_manifest()
        stats["t_flush_s"] += flush.seconds
        stats["counted"].append(
            {"batch": idx, "bases": cur["bases"], "kmers": len(lo),
             "wall_s": round(_time.perf_counter() - cur["t0"], 4),
             "device_acc": on_device})

    while True:
        with trace.span("count.wait_reader"):  # the loop blocked on it
            chunk = next(chunks, None)
        if chunk is None:
            break
        batch_idx_cur = nchunks // chunks_per_batch
        nchunks += 1
        if isinstance(chunk, int):
            nbases += chunk
            continue  # resume: a chunk of a completed batch
        nbases += chunk[4]
        if batch_idx_cur != batch_idx and (runs or acc is not None):
            flush_batch(batch_idx)
            runs = []
        if batch_idx_cur != batch_idx or not cur["bases"]:
            cur.update(bases=0, t0=_time.perf_counter())
        batch_idx = batch_idx_cur
        cur["bases"] += chunk[4]
        if acc_exp and acc is None and not runs:
            acc = DeviceAccCounter(k, mode, chunk_len, acc_exp, dev)
        if acc is not None:
            try:
                acc.add_codes(chunk)
            except AccCapacity:
                # salvage is exact and includes everything staged; the
                # rest of THIS batch runs on the host path
                runs.extend(acc.salvage())
                salvaged = True
                wire.update(_acc_counters(acc))
                acc = None
        else:
            wire["chunks"] += 1
            tensors = _wire_tensors(chunk[1], chunk[2], dev)
            runs.extend(_finish_chunk(*_count_chunk(
                tensors + (chunk[3],), k, mode, dev)))
        if progress:
            progress(nbases)
    if nchunks and (runs or acc is not None
                    or batch_idx not in manifest["done"]):
        flush_batch(batch_idx)
    _publish_wire_stats(trace.since(spans0), wire, bases=nbases,
                        t_finalize_s=t_finalize_s, salvaged=salvaged,
                        native_packs=km.PACK_STATS["native"] - packs0)
    stats.update(chunks=nchunks)
    LAST_BATCH_STATS.clear()
    LAST_BATCH_STATS.update(stats)
    if nchunks == 0:  # empty input
        z = np.zeros(0, np.uint64)
        if _os.path.exists(manifest_path):
            _os.remove(manifest_path)
        return MerylDB.write(out_path, k, z, z.copy(),
                             np.zeros(0, np.uint32), mode=mode, hpc=hpc)
    n_batches = (nchunks + chunks_per_batch - 1) // chunks_per_batch
    batch_paths = [p for p in (f"{out_path}.batch{i}"
                               for i in range(n_batches))
                   if _os.path.exists(p)]
    partial = [MerylDB.open(p).stats()["numDistinct"] for p in batch_paths]
    LAST_BATCH_STATS.update(batches=n_batches, partial_entries=partial,
                            merge_entries=sum(partial))

    # final merge: union-sum over the batch partials
    with trace.span("count.batch_merge") as merge:
        if len(batch_paths) == 1:
            if _os.path.exists(out_path):
                shutil.rmtree(out_path)
            _os.rename(batch_paths[0], out_path)
            db = MerylDB.open(out_path)
        else:
            from .optree import DBInput, OpNode, execute_root
            node = OpNode(op="union-sum",
                          inputs=[DBInput(p) for p in batch_paths],
                          output_path=out_path)
            db = execute_root(node, k, device=dev)
            for p in batch_paths:
                shutil.rmtree(p, ignore_errors=True)
    LAST_BATCH_STATS.update(t_merge_s=merge.seconds)
    if _os.path.exists(manifest_path):
        _os.remove(manifest_path)
    return db
