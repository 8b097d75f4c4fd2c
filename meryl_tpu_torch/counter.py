"""Counting driver: sequence files -> sorted unique (kmer, count) arrays
-> DB (counterpart of meryl_tpu/counter.py, single device).

The main path is the device accumulator (DeviceAccCounter): per chunk
the device extracts, routes and stages cells; every M chunks it merges
them into a sorted unique accumulator; the host downloads the unique
set once.  The exactness hatches (cell overflow, accumulator capacity)
finish on the host sort path: per-chunk sort + run starts on the
device, run lengths and a k-way merge on the host.

The host modules (kmer, db, io.sequence, native) are the port's own
copies of meryl_tpu's; nothing here imports JAX or meryl_tpu.
"""

from __future__ import annotations

import os as _os
import time as _time

import numpy as np
import torch

from . import kmer as km
from . import resolve_device
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


def _sort_rowlen(chunk_len: int) -> int | None:
    """Row length of the host-path chunk sort: chunks sort as
    independent rows of 2^11 (the reference's default) and the host
    merge union-sums duplicates across rows.  None for chunks the row
    length does not divide."""
    r = 1 << 11
    if chunk_len % r or chunk_len // r <= 1:
        return None
    return r


def _wire(codes: np.ndarray, device):
    """Host codes -> packed wire tensors on `device` (packed words as
    int32 bit patterns)."""
    packed2, exc, n_real = km.pack_codes_2bit(codes)
    return _wire_tensors(packed2, exc, device) + (n_real,)


def _wire_tensors(packed2, exc, device):
    return (torch.from_numpy(packed2.view(np.int32)).to(device),
            torch.from_numpy(exc).to(device))


def _count_chunk(chunk, k: int, mode: str, device):
    """Dispatch one chunk on the host sort path: host codes, or a wire
    triple (packed2, exc, n_real) already on the device.  Returns an
    opaque device result for _finish_chunk."""
    if isinstance(chunk, np.ndarray):
        chunk = _wire(chunk, device)
    packed2, exc, n_real = chunk
    L = packed2.shape[0] * 16
    rowlen = _sort_rowlen(L)
    key, valid = extract_cuda.extract_kmers_packed(packed2, exc, n_real,
                                                   k, mode)
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
        self._cap_bytes = int(float(
            _os.environ.get("MERYL_TPU_ACC_CAP_GB", 4.0)) * 1e9)
        self.n_chunks = 0
        self.n_merges = 0
        self.n_regrows = 0
        self.n_recounts = 0
        self.n_captured = 0
        self.wire_h2d_bytes = 0
        self.wire_d2h_bytes = 0
        self._bases_seen = 0
        # every host<->device interaction is counted, with the time the
        # host was blocked in it
        self.sync = {"n_h2d": 0, "n_dispatch": 0, "n_fetch": 0,
                     "t_h2d_s": 0.0, "t_dispatch_s": 0.0,
                     "t_fetch_s": 0.0, "host_pack_s": 0.0,
                     "host_finalize_s": 0.0}

    def _put(self, x: np.ndarray):
        t0 = _time.perf_counter()
        r = torch.from_numpy(x).to(self.device)
        self.sync["n_h2d"] += 1
        self.sync["t_h2d_s"] += _time.perf_counter() - t0
        return r

    def _dispatch(self, fn, *args, **kw):
        t0 = _time.perf_counter()
        r = fn(*args, **kw)
        self.sync["n_dispatch"] += 1
        self.sync["t_dispatch_s"] += _time.perf_counter() - t0
        return r

    def _fetch(self, x: torch.Tensor) -> np.ndarray:
        t0 = _time.perf_counter()
        r = x.cpu().numpy()
        self.sync["n_fetch"] += 1
        self.sync["t_fetch_s"] += _time.perf_counter() - t0
        return r

    def _fetch_int(self, x: torch.Tensor) -> int:
        t0 = _time.perf_counter()
        r = int(x)
        self.sync["n_fetch"] += 1
        self.sync["t_fetch_s"] += _time.perf_counter() - t0
        return r

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
        n_orig = len(codes)
        if n_orig < self.chunk_len:
            codes = np.concatenate(
                [codes, np.full(self.chunk_len - n_orig, SEP, np.uint8)])
        packed2, exc, n_real = km.pack_codes_2bit(
            codes, pad_to=self.chunk_len)
        return (codes, packed2, exc, n_real, n_orig)

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
            t0 = _time.perf_counter()
            packed2, exc, n_real = km.pack_codes_2bit(
                codes, pad_to=self.chunk_len)
            self.sync["host_pack_s"] += _time.perf_counter() - t0
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
        words = mw.num_words(self.k)
        la = la_then
        while True:
            new_la = la
            while new_la < hi:
                new_la *= 2
            # the merge's working set (keys + counts, int64, x3) plus
            # what stays alive meanwhile: the old accumulator and the
            # staged cells
            need = new_la * self.B * (words + 1) * 8 * 3 + held
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

    def finalize(self):
        """-> sorted unique (hi, lo, counts-u32)."""
        self._resolve_batch()
        if self._staged:
            self._merge()
        self._verify_merge()
        n_allones = 0
        if self._nallones:
            n_allones = self._fetch_int(torch.stack(self._nallones).sum())

        runs = list(self._fallback_runs)
        if self._acc is not None:
            # dense download of the used row prefix
            t0 = _time.perf_counter()
            lmax = min(self.La, accum._eighth_round(
                max(256, getattr(self, "_max_run", self.La))))
            keys = self._fetch(self._acc[0][:, :lmax].reshape(
                (-1,) + self._tail()))
            counts = self._fetch(self._acc[1][:, :lmax].reshape(-1))
            self.wire_d2h_bytes += keys.nbytes + counts.nbytes
            keepm = counts > 0
            hi, lo = mw.to_hilo(keys[keepm], self.k)
            runs.insert(0, (hi, lo, counts[keepm].astype(np.uint64)))
            self.sync["host_finalize_s"] += _time.perf_counter() - t0
        if self._ovf_keys:
            runs.append(self._capture_run())
        hi, lo, counts = merge_runs(runs)
        if n_allones:
            ao_hi, ao_lo, _ = self._allones_run(0)
            n = min(n_allones, int(km.VALUE_MAX))
            if len(lo) and hi[-1] == ao_hi[0] and lo[-1] == ao_lo[0]:
                counts[-1] = min(int(counts[-1]) + n, int(km.VALUE_MAX))
            else:
                hi = np.append(hi, ao_hi)
                lo = np.append(lo, ao_lo)
                counts = np.append(counts, np.uint32(n))
        return hi, lo, counts


def configure_counting(paths, k: int) -> dict:
    """Expected k-mers from file sizes (x1 plain, x3 gz, x3.5 bz2, x4
    xz), as the reference's configuration pass guesses them."""
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
    return {"k": k, "expected_kmers": int(exp)}


def _use_device_acc(paths, k, device) -> int:
    """Expected-uniques estimate when the device-accumulator path
    should run, else 0.  MERYL_TPU_DEVICE_ACC=1/0 forces; auto = on for
    a CUDA device when the expected unique set fits the accumulator
    budget."""
    env = _os.environ.get("MERYL_TPU_DEVICE_ACC", "auto")
    if env == "0":
        return 0
    try:
        exp = min(configure_counting(paths, k)["expected_kmers"],
                  4 ** k if k < 32 else 1 << 63)
    except OSError:
        return 0
    if env == "1":
        return max(1, exp)
    if resolve_device(device).type != "cuda":
        return 0
    cap = int(float(_os.environ.get("MERYL_TPU_ACC_CAP_GB", 4.0)) * 1e9)
    # keys + count as int64, x3 for the merge sort's working set; the
    # 0.35 FASTQ/dedup discount is the one the accumulator sizes with
    acc_bytes = (mw.num_words(k) + 1) * 8 * 3
    if exp * 0.35 * acc_bytes > cap:
        return 0
    return max(1, exp)


# wire volumes and sync counts of the most recent device-accumulator
# run (same keys as meryl_tpu.counter.LAST_WIRE_STATS)
LAST_WIRE_STATS: dict = {}


def _prefetch_chunks(chunker, depth: int = 2, transform=None,
                     stats: dict | None = None):
    """Iterate a SequenceChunker through a small queue fed by a reader
    thread: the file scan and the per-chunk `transform` (the 2-bit
    pack) overlap the device work.  Reader errors re-raise here."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    DONE = object()

    def _reader():
        busy = 0.0
        try:
            it = iter(chunker)
            while True:
                t0 = _time.perf_counter()
                try:
                    c = next(it)
                except StopIteration:
                    break
                if transform is not None:
                    c = transform(c)
                busy += _time.perf_counter() - t0
                q.put(c)
            if stats is not None:
                stats["reader_busy_s"] = round(busy, 4)
            q.put(DONE)
        except BaseException as e:  # surface reader errors, then stop
            q.put(e)

    t = threading.Thread(target=_reader, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is DONE:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def count_to_arrays_device_acc(paths, k: int, mode: str, hpc: bool,
                               chunk_len: int, expected_uniques: int,
                               progress=None, device="cuda"):
    acc = DeviceAccCounter(k, mode, chunk_len, expected_uniques, device)
    nbases = 0
    reader_stats: dict = {}
    it = iter(_prefetch_chunks(SequenceChunker(paths, k, chunk_len,
                                               hpc=hpc),
                               depth=4, transform=acc.prepack,
                               stats=reader_stats))
    salvage_runs = None
    scan_stall_s = 0.0  # consumer time blocked on the reader thread
    while True:
        t0 = _time.perf_counter()
        try:
            chunk = next(it)
        except StopIteration:
            scan_stall_s += _time.perf_counter() - t0
            break
        scan_stall_s += _time.perf_counter() - t0
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
    t_fin0 = _time.perf_counter()
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
    LAST_WIRE_STATS.clear()
    LAST_WIRE_STATS.update(
        h2d_bytes=acc.wire_h2d_bytes, d2h_bytes=acc.wire_d2h_bytes,
        bases=nbases, scan_stall_s=round(scan_stall_s, 4),
        reader_busy_s=reader_stats.get("reader_busy_s", 0.0),
        t_finalize_s=round(_time.perf_counter() - t_fin0, 4),
        **{kk: (round(v, 4) if isinstance(v, float) else v)
           for kk, v in acc.sync.items()},
        chunks=acc.n_chunks, merges=acc.n_merges, regrows=acc.n_regrows,
        recounts=acc.n_recounts, captured=acc.n_captured,
        salvaged=salvage_runs is not None)
    return out


def count_to_arrays(paths, k: int, mode: str = "canonical",
                    hpc: bool = False, chunk_len: int | None = None,
                    progress=None, device="cuda"):
    """Count k-mers in sequence files on `device` ("cuda" or
    "cpu"; no fallback from one to the other).  Returns sorted
    (hi, lo, counts)."""
    if not 1 <= k <= km.K_MAX:
        raise ValueError(f"k must be in [1, {km.K_MAX}], got {k}")
    if mode not in ("canonical", "forward", "reverse"):
        raise ValueError(f"mode must be canonical, forward or reverse, "
                         f"got {mode!r}")
    dev = resolve_device(device)
    chunk_len = chunk_len or default_chunk()
    exp_uniques = _use_device_acc(paths, k, dev)
    if exp_uniques:
        return count_to_arrays_device_acc(
            paths, k, mode=mode, hpc=hpc, chunk_len=chunk_len,
            expected_uniques=exp_uniques, progress=progress, device=dev)
    runs = []
    nbases = 0
    pending = None  # 1-deep pipeline: the device works on chunk i+1
    #                 while the host finishes chunk i
    for chunk in SequenceChunker(paths, k, chunk_len, hpc=hpc):
        result = _count_chunk(chunk, k, mode, dev)
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
                progress=None, device="cuda") -> MerylDB:
    """Count to a meryl DB (written by the port's copy of db.py)."""
    hi, lo, counts = count_to_arrays(paths, k, mode=mode, hpc=hpc,
                                     chunk_len=chunk_len,
                                     progress=progress, device=device)
    return MerylDB.write(out_path, k, hi, lo, counts, mode=mode, hpc=hpc)
