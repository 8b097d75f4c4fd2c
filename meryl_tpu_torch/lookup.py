"""Batched exact k-mer lookup: the merylExactLookup equivalent
(counterpart of meryl_tpu/lookup.py).

The table is the DB's sorted keys as the port's flipped int64 words
(ops/multiword.py: one word for k <= 32, (N, 2) above), its values as
int32 bit patterns of the uint32 counts, and a prefix-offset table.
Queries come in batches and take one of two regimes, chosen by where
the table lives:

  * binary search (`values_batch`), for a table on the device: for
    k <= 32 one word is the whole key and `torch.searchsorted` over the
    sorted words is the exact lower bound; for k > 32 the reference's
    prefix-bucketed lexicographic search runs in torch;
  * grid join (`_values_bulk_bacj`, ops/bacjoin.py), for a bulk batch
    of at least JOIN_MIN_Q valid queries against a table past the
    device budget (MERYL_TPU_LOOKUP_DEVICE_GB): the DB padded into a
    bucket grid, host-routed query slabs, a dense compare; one grid on
    the device, or segments streamed through it one at a time.

Smaller batches and point probes against such a table take the host
search (`values_host`: numpy searchsorted on the host copy).  Every
regime is exact; the grid join's hatches (cell overflow, a lost
capture window, a slab the router rejects) are the reference's, end in
the host search and are counted in STATS.

value(kmer) == 0 means absent, as in the reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import kmer as km
from . import resolve_device
from .db import MerylDB
from .ops import bacjoin as bj
from .ops import multiword as mw

SENTQ = 0xFFFFFFFF
M32 = 0xFFFFFFFF

# regime and hatch counters since the last reset_stats()
STATS: dict = {}


def reset_stats() -> None:
    STATS.clear()
    STATS.update(bsearch_calls=0, bsearch_queries=0, bacj_slabs=0,
                 bacj_segments=0, bacj_cell_overflow=0, bacj_lost_rows=0,
                 bacj_rejected_slabs=0, host_fallback=0, host_queries=0)


reset_stats()


def _budget_bytes(env: str, device: torch.device) -> float:
    """A device-memory budget: the env var in GB when set, else half the
    card's memory (6 GB for the CPU, the reference's default)."""
    v = os.environ.get(env)
    if v:
        return float(v) * 1e9
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory / 2
    return 6e9


def _prefix_bits_for(n_kmers: int, k: int) -> int:
    """Table of 2^B offsets; aim for ~4 kmers per prefix slot."""
    b = max(1, int(n_kmers).bit_length() - 2)
    return min(b, 2 * k, 22)


def _top_bits_t(key: torch.Tensor, k: int, b: int) -> torch.Tensor:
    """Top b bits (b <= 2k, b <= 26) of each key word tensor, int64.

    Bits of a word above 2k (set only in the sentinel) are masked off,
    so the sentinel's prefix is all ones, as the reference's planes
    give it."""
    shift = 2 * k - b
    mask = (1 << b) - 1
    if mw.num_words(k) == 1:
        return ((key ^ mw.FLIP) >> shift) & mask
    hi = key[..., 0] ^ mw.FLIP
    lo = key[..., 1] ^ mw.FLIP
    if shift >= 64:
        return (hi >> (shift - 64)) & mask
    nlo = 64 - shift                       # bits from the top of lo
    hi = hi & ((1 << (2 * k - 64)) - 1)
    return ((hi << nlo) | ((lo >> shift) & ((1 << nlo) - 1))) & mask


def _lower_bound(db_key, offsets, q_key, k: int, b: int, iters: int):
    """Exact lower bound of each query in the sorted DB keys (shared by
    the value lookup here and the rank lookup in
    tools/position_lookup.py).

    db_key: (N,) or (N, 2) sorted words; offsets: (2^b + 1,) int32 start
    of each b-bit prefix; q_key: (Q,) or (Q, 2).
    -> (idx, found): clipped lower-bound rank per query, and whether the
       key at idx equals the query (the caller ANDs its own validity)."""
    n = db_key.shape[0]
    end = offsets[-1].to(torch.int64)           # the real entry count
    if mw.num_words(k) == 1:
        # one word is the whole key: searchsorted is the lower bound
        lo = torch.searchsorted(db_key, q_key)
    else:
        pref = _top_bits_t(q_key, k, b)
        lo = offsets[pref].to(torch.int64)
        hi = offsets[pref + 1].to(torch.int64)
        end = hi
        for _ in range(iters):
            mid = (lo + hi) >> 1
            less = mw.lt(db_key[mid.clamp(max=n - 1)], q_key, k)
            active = lo < hi
            lo = torch.where(active & less, mid + 1, lo)
            hi = torch.where(active & ~less, mid, hi)
    idx = lo.clamp(max=n - 1)
    found = mw.eq(db_key[idx], q_key, k) & (lo < end)
    return idx, found


def _query_kernel(db_key, db_values, offsets, q_key, valid, k: int, b: int,
                  iters: int) -> torch.Tensor:
    """Value of each query (int64 in [0, 2^32)); 0 where absent or
    invalid."""
    idx, found = _lower_bound(db_key, offsets, q_key, k, b, iters)
    v = db_values[idx].to(torch.int64) & M32
    return torch.where(found & valid, v, 0)


class ExactLookup:
    """Exact lookup table for one database (merylExactLookup:
    load(db, minV, maxV), value(), exists(), nKmers()).

    Batched methods take key word tensors (or numpy arrays) and
    validity masks; `device` is where the table lives ("cuda" unless
    the caller asks for the CPU).  A table past MERYL_TPU_LOOKUP_DEVICE_GB
    (default half the card's memory) stays on the host: bulk queries
    then run the grid join, point probes the host search."""

    BULK_SLAB = 1 << 22      # queries per binary-search dispatch

    # Regimes, from the port's measurements on an H100 (PERF.md §6: 2^23
    # queries, half hits): on the device the binary search answers
    # 1070-1687 Mq/s at 10.56 M entries, where every join measured at
    # most 251 Mq/s.  So a table on the device always takes the binary
    # search.  A table past the device budget takes the grid join from
    # JOIN_MIN_Q valid queries (one grid, or segments streamed through
    # the device) and the host search below that.
    JOIN_MIN_Q = 1 << 17     # below: binary search or host search
    BACJ_SLAB = 1 << 23      # queries per grid-join dispatch

    def __init__(self, db: MerylDB, min_value: int = 0,
                 max_value: int = km.VALUE_MAX, device="cuda"):
        self.db = db
        self.k = db.k
        self.P = km.num_planes(self.k)
        self.device = resolve_device(device)
        hi, lo, counts = db.load_all()
        if min_value > 0 or max_value < km.VALUE_MAX:
            keep = (counts >= min_value) & (counts <= max_value)
            hi, lo, counts = hi[keep], lo[keep], counts[keep]
        self._n = len(counts)
        self.B = _prefix_bits_for(max(self._n, 1), self.k)
        pref = bj._top_bits_np(hi, lo, self.k, self.B)
        offsets = np.searchsorted(
            pref, np.arange((1 << self.B) + 1)).astype(np.int32)
        key = mw.from_hilo(hi, lo, self.k)
        vals = np.ascontiguousarray(counts, np.uint32)
        if self._n == 0:  # one row of key 0, value 0: never found
            z = np.zeros(1, np.uint64)
            key, vals = mw.from_hilo(z, z, self.k), np.zeros(1, np.uint32)
        self._device_resident = self.estimate_memory_bytes() <= \
            _budget_bytes("MERYL_TPU_LOOKUP_DEVICE_GB", self.device)
        if self._device_resident:
            self._offsets = torch.from_numpy(offsets).to(self.device)
            self._key = torch.from_numpy(np.ascontiguousarray(key)) \
                .to(self.device)
            self._values = bj.to_device_u32(vals, self.device)
        else:
            self._offsets = self._key = self._values = None
        max_range = int((offsets[1:] - offsets[:-1]).max()) if self._n else 1
        self._iters = max(1, int(max_range).bit_length())
        # host copies for the host search and the lazily built layouts
        self._np_hi, self._np_lo = hi, lo
        self._np_counts = vals
        self._bacj = None

    def n_kmers(self) -> int:
        return self._n

    def estimate_memory_bytes(self) -> int:
        """Device bytes of the loaded table in the port's layout: 8 bytes
        a key word and 4 a value per entry, plus the int32 offsets
        table.  (The reference reports its own (P * 4 + 4) bytes an
        entry of uint32 planes.)"""
        W = mw.num_words(self.k)
        return (8 * W + 4) * max(self._n, 1) + 4 * ((1 << self.B) + 1)

    # ---- conversions

    def _key_t(self, key) -> torch.Tensor:
        if isinstance(key, torch.Tensor):
            return key.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(key, np.int64)) \
            .to(self.device)

    def _valid_t(self, valid) -> torch.Tensor:
        if isinstance(valid, torch.Tensor):
            return valid.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(valid, bool)) \
            .to(self.device)

    def _hilo(self, key):
        """Key words (tensor or numpy) -> host (hi, lo) uint64 arrays."""
        if isinstance(key, torch.Tensor):
            key = key.cpu().numpy()
        return mw.to_hilo(key, self.k)

    # ---- binary search

    def values_batch(self, key, valid) -> torch.Tensor:
        """key: (Q,) or (Q, 2) words, valid: (Q,) bool -> int64 values
        on the key's device (0 where absent or invalid)."""
        if not self._device_resident:
            qhi, qlo = self._hilo(key)
            out = self.values_host(qhi, qlo).astype(np.int64)
            vmask = valid.cpu().numpy() if isinstance(valid, torch.Tensor) \
                else np.asarray(valid)
            out[~vmask] = 0
            dev = key.device if isinstance(key, torch.Tensor) else self.device
            return torch.from_numpy(out).to(dev)
        STATS["bsearch_calls"] += 1
        STATS["bsearch_queries"] += int(key.shape[0])
        return _query_kernel(self._key, self._values, self._offsets,
                             self._key_t(key), self._valid_t(valid),
                             self.k, self.B, self._iters)

    def values_host(self, qhi: np.ndarray, qlo: np.ndarray) -> np.ndarray:
        """Host-side exact probe against the sorted (hi, lo) arrays: the
        path of a table past the device budget (point probes and the
        grid join's hatches).  searchsorted for 2k <= 64; two-stage for
        wider keys."""
        n = self._n
        STATS["host_queries"] += len(qlo)
        out = np.zeros(len(qlo), np.uint32)
        if n == 0:
            return out
        if 2 * self.k <= 64:
            # searchsorted walks sorted queries from the last answer: an
            # argsort first costs less than random probes of a big table
            order = np.argsort(qlo)
            idx = np.empty(len(qlo), np.int64)
            idx[order] = np.searchsorted(self._np_lo, qlo[order])
            ok = idx < n
            ii = np.minimum(idx, n - 1)
            ok &= self._np_lo[ii] == qlo
            out[ok] = self._np_counts[ii[ok]]
            return out
        # each hi value is one contiguous run of the sorted keys: loop
        # over the distinct query hi values with a lo search per run
        idx = np.empty(len(qlo), np.int64)
        for h in np.unique(qhi):
            m = qhi == h
            a = np.searchsorted(self._np_hi, h, "left")
            b = np.searchsorted(self._np_hi, h, "right")
            idx[m] = a + np.searchsorted(self._np_lo[a:b], qlo[m])
        ok = idx < n
        ii = np.minimum(idx, n - 1)
        ok &= (self._np_lo[ii] == qlo) & (self._np_hi[ii] == qhi)
        out[ok] = self._np_counts[ii[ok]]
        return out

    def _bsearch_t(self, key: torch.Tensor, valid: torch.Tensor):
        """Binary search in BULK_SLAB slabs -> int64 values tensor."""
        parts = [self.values_batch(key[s:s + self.BULK_SLAB],
                                   valid[s:s + self.BULK_SLAB])
                 for s in range(0, key.shape[0], self.BULK_SLAB)]
        if not parts:
            return torch.zeros(0, dtype=torch.int64, device=key.device)
        return torch.cat(parts)

    def _values_bulk_bsearch(self, key, valid) -> np.ndarray:
        """Binary-search bulk path -> uint32 numpy values."""
        return bj.download_u32(self._bsearch_t(self._key_t(key),
                                               self._valid_t(valid)))

    # ---- bulk

    def values_bulk(self, key, valid, exists_only: bool = False) -> np.ndarray:
        """Values for a large query batch -> uint32 numpy (Q,).

        key: (Q,) or (Q, 2) words as a tensor (kept where it is when the
        regime runs on the device) or a numpy array; valid: (Q,) bool.
        exists_only=True returns 0/1 instead of counts.  A table past the
        device budget takes the grid join from JOIN_MIN_Q valid queries;
        everything else the binary search (the host search for such a
        table)."""
        if not self._device_resident:
            if isinstance(valid, torch.Tensor):
                n_valid = int(valid.sum())
            else:
                n_valid = int(np.count_nonzero(valid))
            if n_valid >= self.JOIN_MIN_Q:
                if self._bacj is None:
                    self._bacj = self._build_bacj() or "degenerate"
                if self._bacj != "degenerate":
                    return self._values_bulk_bacj(key, valid, exists_only)
        v = self._bsearch_t(self._key_t(key), self._valid_t(valid))
        if exists_only:
            return (v > 0).cpu().numpy().astype(np.uint32)
        return bj.download_u32(v)

    def _build_bacj(self):
        """One-time host build of the bucket-grid layout for the grid
        compare-join (ops/bacjoin.py).  None when no geometry fits the
        device-memory cap (MERYL_TPU_BACJ_CAP_GB, default half the
        card's memory) with sane padding."""
        if 2 * self.k < 18 or self._n == 0:
            return None
        cap = _budget_bytes("MERYL_TPU_BACJ_CAP_GB", self.device)
        # the max-bucket scan's resolution bounded by the table size
        bm = min(26, 2 * self.k - 1, self._n.bit_length() + 3)
        topM = bj._top_bits_np(self._np_hi, self._np_lo, self.k, bm)
        cM = np.bincount(topM, minlength=1 << bm)

        def bucket_max(b):
            return int(cM.reshape(1 << b, -1).sum(axis=1).max())

        cfg = bj.plan_bacjoin_segmented(self._n, self.k, bucket_max,
                                        self.BACJ_SLAB, cap, b_hi=bm)
        if cfg is None:
            return None
        dbd, dbv = bj.build_db_grid(self._np_hi, self._np_lo,
                                    self._np_counts, self.k, cfg)
        out = {
            "cfg": cfg,
            "segments": cfg.get("segments", 1),
            "kcfg": (self.k, cfg["b"], cfg["b1"], cfg["c"],
                     cfg["capA"], cfg["s_cap"], cfg["ovfcap"]),
        }
        if out["segments"] == 1:
            out["dbd"] = tuple(bj.to_device_u32(d, self.device) for d in dbd)
            out["dbv"] = bj.to_device_u32(dbv, self.device)
        else:
            # host-resident grid, streamed one key-range segment at a time
            out["dbd_np"] = dbd
            out["dbv_np"] = dbv
        return out

    def _values_bulk_bacj(self, key, valid, exists_only=False) -> np.ndarray:
        """Bulk lookup through the bucket-grid compare-join.  Every
        escape is exact: cell-overflow queries are captured by position,
        a coarse row whose capture window overflows (ovfcap) falls back
        whole, a slab the host router cannot place falls back whole; all
        of them are answered together by the host search at the end."""
        g = self._bacj
        cfg, kcfg = g["cfg"], g["kcfg"]
        capA, ovfcap = cfg["capA"], cfg["ovfcap"]
        K = g["segments"]
        dev = self.device
        if isinstance(valid, torch.Tensor):
            valid = valid.cpu().numpy()
        Q = len(valid)
        out = np.zeros(Q, np.uint32)
        vidx = np.flatnonzero(valid)
        qhi, qlo = self._hilo(key)      # the router runs on the host
        fb_idx: list = []

        def resolve_fallbacks():
            if not fb_idx:
                return
            idx = np.unique(np.concatenate(fb_idx))
            fb_idx.clear()
            STATS["host_fallback"] += len(idx)
            ov = self.values_host(qhi[idx], qlo[idx])
            out[idx] = (ov > 0).astype(np.uint32) if exists_only else ov

        def run_slabs(sel, dbd, dbv, row_base, n_rows):
            """One-deep pipeline over sel's slabs against one resident
            grid: the host routes slab i+1 while the device resolves
            slab i (launches are asynchronous; the download blocks)."""
            def dispatch(take):
                routed = bj.route_queries_host(
                    qhi[take], qlo[take], self.k, cfg,
                    row_base=row_base, n_rows=n_rows)
                if routed is None:
                    STATS["bacj_rejected_slabs"] += 1
                    fb_idx.append(take)
                    return None
                qlow, n_row, perm = routed
                STATS["bacj_slabs"] += 1
                return take, perm, bj.bacjoin_kernel(
                    dbd, dbv, tuple(bj.to_device_u32(x, dev) for x in qlow),
                    torch.from_numpy(n_row).to(dev), kcfg,
                    exists_only=exists_only)

            slabs = [sel[s:s + self.BACJ_SLAB]
                     for s in range(0, len(sel), self.BACJ_SLAB)]
            inflight = None
            for i in range(len(slabs) + 1):
                nxt = dispatch(slabs[i]) if i < len(slabs) else None
                if inflight is not None:
                    collect(*inflight)
                inflight = nxt

        def collect(take, perm, handles):
            if exists_only:
                packed, ovf_pos, n_ovf = handles
                packed = bj.download_u32(packed)
                rows, cols = np.nonzero(packed != SENTQ)
                pw = packed[rows, cols]
                orig = perm[rows * capA + (pw & 0x7FFFFFFF).astype(np.int64)]
                out[take[orig]] = (pw >> 31).astype(np.uint32)
            else:
                vals, pos, ovf_pos, n_ovf = handles
                vals, pos = bj.download_u32(vals), bj.download_u32(pos)
                rows, cols = np.nonzero(pos != SENTQ)
                orig = perm[rows * capA + pos[rows, cols].astype(np.int64)]
                out[take[orig]] = vals[rows, cols]
            n_ovf = n_ovf.cpu().numpy()
            lost_rows = np.flatnonzero(n_ovf > ovfcap)
            STATS["bacj_lost_rows"] += len(lost_rows)
            for r in lost_rows:
                # capture window overflowed: the whole coarse row again
                rp = perm[r * capA:(r + 1) * capA]
                fb_idx.append(take[rp[rp >= 0]])
            op = bj.download_u32(ovf_pos)
            orr, occ = np.nonzero((op != SENTQ)
                                  & (n_ovf <= ovfcap)[:, None])
            STATS["bacj_cell_overflow"] += len(orr)
            if len(orr):
                fb_idx.append(take[perm[orr * capA
                                        + op[orr, occ].astype(np.int64)]])

        if K == 1:
            run_slabs(vidx, g["dbd"], g["dbv"], 0, 1 << cfg["b1"])
            resolve_fallbacks()
            return out

        # segmented grid: partition queries by key-range segment (top
        # log2 K bits), then stream one grid segment through the device
        # at a time; each upload serves all of that segment's slabs
        B1 = 1 << cfg["b1"]
        rows_per_seg = B1 // K
        buckets_per_seg = cfg["B"] // K
        coarse = bj._top_bits_np(qhi[vidx], qlo[vidx], self.k, cfg["b1"])
        seg_ids = (coarse // rows_per_seg).astype(np.int64)
        order = np.argsort(seg_ids, kind="stable")
        bounds = np.searchsorted(seg_ids[order], np.arange(K + 1))
        for s in range(K):
            sel = vidx[order[bounds[s]:bounds[s + 1]]]
            if len(sel) == 0:
                continue
            STATS["bacj_segments"] += 1
            a, b = s * buckets_per_seg, (s + 1) * buckets_per_seg
            dbd_s = tuple(bj.to_device_u32(d[a:b], dev) for d in g["dbd_np"])
            dbv_s = bj.to_device_u32(g["dbv_np"][a:b], dev)
            run_slabs(sel, dbd_s, dbv_s, s * rows_per_seg, rows_per_seg)
            del dbd_s, dbv_s
        resolve_fallbacks()
        return out

    # ---- convenience host-side probes (small batches)

    def values_np(self, hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
        key = mw.from_hilo(np.asarray(hi, np.uint64),
                           np.asarray(lo, np.uint64), self.k)
        valid = np.ones(len(lo), bool)
        return bj.download_u32(self.values_batch(self._key_t(key),
                                                 self._valid_t(valid)))

    def value(self, kmer_int: int) -> int:
        hi, lo = km.hilo_from_int(kmer_int)
        return int(self.values_np(np.array([hi], np.uint64),
                                  np.array([lo], np.uint64))[0])

    def exists(self, kmer_int: int) -> bool:
        return self.value(kmer_int) > 0
