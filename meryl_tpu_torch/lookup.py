"""Batched exact k-mer lookup: the merylExactLookup equivalent
(counterpart of meryl_tpu/lookup.py).

The table is the DB's sorted keys as the port's flipped int64 words
(ops/multiword.py: one word for k <= 32, (N, 2) above), its values as
int32 bit patterns of the uint32 counts, and a prefix-offset table.
Queries come in batches and take one of the reference's regimes:

  * binary search (`values_batch`): for k <= 32 one word is the whole
    key and `torch.searchsorted` over the sorted words is the exact
    lower bound; for k > 32 the reference's prefix-bucketed
    lexicographic search runs in torch;
  * sort-merge join (`values_join`): one stable sort of [DB, queries];
  * routed join (`_values_bulk_join`): queries routed to bucket groups
    of the DB, one sort a group row, each query read from its
    predecessor;
  * grid join (`_values_bulk_bacj`, ops/bacjoin.py): the DB padded into
    a bucket grid, host-routed query slabs, a dense compare; segmented
    and streamed through the device for tables past its budget;
  * host search (`values_host`): numpy searchsorted on the host copy.

`values_bulk` picks among them with the class thresholds (JOIN_MIN_Q,
JOIN_MIN_N, BACJ_MIN_N), which the port sets from its own measurements
on the card (PERF.md).  Every regime is exact; the hatches that fall
back to another regime (cell overflow, a lost capture window, a slab
the router rejects) are the reference's and are counted in STATS.

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
    STATS.update(bsearch_calls=0, bsearch_queries=0, join_slabs=0,
                 join_overflow=0, bacj_slabs=0, bacj_segments=0,
                 bacj_cell_overflow=0, bacj_lost_rows=0,
                 bacj_rejected_slabs=0, host_fallback=0,
                 sortjoin_slabs=0, host_queries=0)


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


def _join_kernel(db_key, db_values, q_key, q_valid, k: int):
    """Sort-merge join: one stable sort of [db, queries] (each DB entry
    sorts before its equal queries), then each run's first entry's
    value broadcast to the run.  -> (values in sorted order, each
    entry's query index; Q for DB entries)."""
    from .ops import segscan

    N, Q = db_key.shape[0], q_key.shape[0]
    dev = q_key.device
    sent = mw.sentinel(k, dev)
    keys = torch.cat([db_key, mw.where(q_valid, q_key, sent, k)])
    is_db = torch.cat([torch.ones(N, dtype=torch.bool, device=dev),
                       torch.zeros(Q, dtype=torch.bool, device=dev)])
    vals = torch.cat([db_values.to(torch.int64) & M32,
                      torch.zeros(Q, dtype=torch.int64, device=dev)])
    qidx = torch.cat([torch.full((N,), Q, dtype=torch.int64, device=dev),
                      torch.arange(Q, dtype=torch.int64, device=dev)])
    skey, (s_isdb, s_vals, s_qidx) = mw.sort(keys, k, (is_db, vals, qidx),
                                             stable=True)
    start = mw.run_starts(skey, k)
    # each element's run start: the running max of the start positions
    pos = torch.arange(N + Q, dtype=torch.int64, device=dev)
    first = segscan.seg_scan(torch.maximum, torch.where(start, pos, 0), start)
    out = torch.where(~s_isdb & s_isdb[first], s_vals[first], 0)
    return out, s_qidx


def _rows_take(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Gather along the position axis of a (R, L) or (R, L, 2) tensor."""
    if x.dim() == order.dim():
        return torch.gather(x, 1, order)
    return torch.gather(x, 1, order.unsqueeze(-1).expand(*order.shape, 2))


def _route_join_kernel(gkey, gvalues, q_key, n_valid: int, pad_key, cfg,
                       exists_only: bool = False):
    """Routed join of one (R0, L0) query slab against the bucket-grouped
    DB (counterpart of meryl_tpu/lookup.py _route_join_kernel_impl).

    Routing: one sort of each row by bucket prefix, a cummax rank, a
    per-(row, bucket) count by searchsorted, and one stable compaction
    sort of [queries ++ pads] gives exactly c slots per bucket; the
    cells transpose so each group's queries sit beside that group's DB
    entries.  Join: one sort a group row by (key, kind << 22 | qidx);
    a query's value is its predecessor's when that is its DB entry, and
    further equal queries are flagged as duplicates (the caller
    forward-fills them).  Results move to each row's front.
    -> (values, qidx | dup << 31, n_ovf, tail qidx), or
       (packed, n_ovf, tail qidx) with exists_only."""
    k, P, b, B, G, SUB, LDB, R0, L0, c = cfg
    D = B * c
    dev = q_key.device
    i64 = torch.int64

    # query ids in slab order, SENTQ for the padding past n_valid
    iot0 = torch.arange(R0 * L0, dtype=i64, device=dev).reshape(R0, L0)
    q_qidx = torch.where(iot0 < n_valid, iot0, SENTQ)

    # sort 1: queries by bucket prefix
    pref = _top_bits_t(q_key, k, b)
    pref1, order = torch.sort(pref, dim=1, stable=True)
    key1 = _rows_take(q_key, order)
    qidx1 = torch.gather(q_qidx, 1, order)

    # rank within the bucket: position minus the segment start's
    seg_start = torch.cat([torch.ones(R0, 1, dtype=torch.bool, device=dev),
                           pref1[:, 1:] != pref1[:, :-1]], dim=1)
    iot = torch.arange(L0, dtype=i64, device=dev).expand(R0, L0)
    seg_base = torch.cummax(torch.where(seg_start, iot, -1), dim=1).values
    kept_q = (iot - seg_base) < c

    # per-(row, bucket) query counts; pads fill slot j of a bucket with
    # n kept queries iff j >= min(n, c)
    tgt = torch.arange(B + 1, dtype=i64, device=dev).expand(R0, B + 1)
    lo_b = torch.searchsorted(pref1.contiguous(), tgt.contiguous())
    n_bucket = lo_b[:, 1:] - lo_b[:, :-1]
    pad_rank = torch.arange(c, dtype=i64, device=dev).repeat(B)
    kept_p = pad_rank[None, :] >= torch.minimum(
        n_bucket.repeat_interleave(c, dim=1), torch.tensor(c, device=dev))

    # sort 2: one compaction sort of [reals ++ pads] keyed by bucket (or
    # SENTQ): the leading D slots are the bucket-major cells
    key2 = torch.cat([torch.where(kept_q, pref1, SENTQ),
                      torch.where(kept_p, pad_key.expand(R0, D), SENTQ)],
                     dim=1)
    sent = mw.sentinel(k, dev)
    pads = sent.expand(R0, D, 2) if q_key.dim() == 3 else sent.expand(R0, D)
    keys2 = torch.cat([key1, pads], dim=1)
    qidx2 = torch.cat([qidx1, torch.full((R0, D), SENTQ, dtype=i64,
                                         device=dev)], dim=1)
    _, order = torch.sort(key2, dim=1, stable=True)
    keys2 = _rows_take(keys2, order)
    qidx2 = torch.gather(qidx2, 1, order)
    cells_key, cells_qidx = keys2[:, :D], qidx2[:, :D]
    tail_qidx = qidx2[:, D:]
    n_ovf = int((tail_qidx != SENTQ).sum())

    # align cells with DB groups: (R0, D) -> (G, SUB*c*R0)
    CQ = SUB * c * R0
    cells_key = cells_key.transpose(0, 1).reshape(
        (G, CQ) + tuple(cells_key.shape[2:]))
    cells_qidx = cells_qidx.transpose(0, 1).reshape(G, CQ)

    # per-group join: kind 0 = DB entry, 1 = query, 3 = padding; kind
    # and qidx pack into one sort word (kind << 22 | qidx, qidx < 2^21)
    QMASK = (1 << 22) - 1
    db_pk = torch.where(gvalues != 0, 0, 3 << 22) | QMASK
    q_pk = torch.where(cells_qidx != SENTQ, (1 << 22) | cells_qidx,
                       (3 << 22) | QMASK)
    packed = torch.cat([db_pk.to(i64).expand(G, LDB), q_pk], dim=1)
    jkey = torch.cat([gkey, cells_key], dim=1)
    jval = torch.cat([gvalues.to(i64) & M32,
                      torch.zeros(G, CQ, dtype=i64, device=dev)], dim=1)
    packed, order = torch.sort(packed, dim=1, stable=True)
    jkey = _rows_take(jkey, order)
    jval = torch.gather(jval, 1, order)
    skey, (packed3, val3) = mw.sort(jkey, k, (packed, jval), stable=True)
    kind3 = packed3 >> 22

    # 1-step lookback: the DB entry sorts immediately before its equal
    # queries; further equal queries chain as duplicates
    def prev(x, fill):
        return torch.cat([torch.full((G, 1), fill, dtype=x.dtype,
                                     device=dev), x[:, :-1]], dim=1)

    same = skey[:, 1:] == skey[:, :-1]
    if same.dim() == 3:
        same = same.all(dim=-1)
    eq_prev = torch.cat([torch.zeros(G, 1, dtype=torch.bool, device=dev),
                         same], dim=1)
    pk = prev(kind3, 3)
    is_q = kind3 == 1
    out_val = torch.where(is_q & (pk == 0) & eq_prev, prev(val3, 0), 0)
    dup = (is_q & (pk == 1) & eq_prev).to(i64)

    # compact each row's query results to its front
    flag = (~is_q).to(torch.int8)
    _, order = torch.sort(flag, dim=1, stable=True)
    if exists_only:
        pw = torch.where(is_q, (packed3 & ((1 << 21) - 1))
                         | ((out_val > 0).to(i64) << 22) | (dup << 31),
                         SENTQ)
        return torch.gather(pw, 1, order)[:, :CQ], n_ovf, tail_qidx
    out_qidx = torch.where(is_q, (packed3 & QMASK) | (dup << 31), SENTQ)
    return (torch.gather(out_val, 1, order)[:, :CQ],
            torch.gather(out_qidx, 1, order)[:, :CQ], n_ovf, tail_qidx)


class ExactLookup:
    """Exact lookup table for one database (merylExactLookup:
    load(db, minV, maxV), value(), exists(), nKmers()).

    Batched methods take key word tensors (or numpy arrays) and
    validity masks; `device` is where the table lives ("cuda" unless
    the caller asks for the CPU).  A table past MERYL_TPU_LOOKUP_DEVICE_GB
    (default half the card's memory) stays on the host: bulk queries
    then run the segmented grid join, point probes the host search."""

    BULK_SLAB = 1 << 22      # queries per binary-search dispatch

    # Regime thresholds, from the port's measurements on an H100 (PERF.md
    # §6, chip_smoke.py phase 14: 2^23 queries, half hits): the binary
    # search answers 1070-1687 Mq/s at 10.56 M entries and 1222-1866 at
    # 2^16, the routed join 78-162, values_join 107-251, the grid join
    # with its host router at most 4.  So a table on the device always
    # takes the binary search (JOIN_MIN_N, BACJ_MIN_N out of reach), and
    # the segmented grid join serves a table past the device budget from
    # JOIN_MIN_Q valid queries.  Every regime stays exact and can be
    # forced through these attributes.
    JOIN_SLAB = 1 << 21      # valid queries per routed-join dispatch
    JOIN_R0 = 1 << 4         # routing rows per slab
    JOIN_MIN_Q = 1 << 17     # below: binary search
    JOIN_MIN_N = 1 << 62     # routed join from this table size
    _LDB_TARGET = 1 << 13    # DB entries per join row (pre padding)
    BACJ_MIN_N = 1 << 62     # grid join for a device-resident table
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
        self._grouped = None
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
        exists_only=True returns 0/1 instead of counts.  The grid join
        runs for a table past the device budget (or from BACJ_MIN_N
        entries), the routed join from JOIN_MIN_N, each from JOIN_MIN_Q
        valid queries; the binary search otherwise."""
        if isinstance(valid, torch.Tensor):
            n_valid = int(valid.sum())
        else:
            n_valid = int(np.count_nonzero(valid))
        if (self._n >= self.BACJ_MIN_N or not self._device_resident) \
                and n_valid >= self.JOIN_MIN_Q:
            if self._bacj is None:
                self._bacj = self._build_bacj() or "degenerate"
            if self._bacj != "degenerate":
                return self._values_bulk_bacj(key, valid, exists_only)
        if (self._n >= self.JOIN_MIN_N and n_valid >= self.JOIN_MIN_Q
                and self._device_resident):
            if self._grouped is None:
                self._grouped = self._build_grouped() or "degenerate"
            if self._grouped != "degenerate":
                return self._values_bulk_join(key, valid, exists_only)
        v = self._bsearch_t(self._key_t(key), self._valid_t(valid))
        if exists_only:
            return (v > 0).cpu().numpy().astype(np.uint32)
        return bj.download_u32(v)

    def _build_grouped(self):
        """One-time build of the bucket-grouped DB layout: (G, LDB) key
        and value rows, each row SUB consecutive top-b-bit buckets,
        padded with the sentinel key and value 0.  None when the DB's
        prefix skew would blow the query cell capacity."""
        N = self._n
        G = 1 << max(0, (max(1, (N + self._LDB_TARGET - 1)
                            // self._LDB_TARGET) - 1).bit_length())
        b = max(G, 512).bit_length() - 1
        b = min(b, 2 * self.k, 26)
        B = 1 << b
        SUB = max(1, B // G)
        G = B // SUB
        top = bj._top_bits_np(self._np_hi, self._np_lo, self.k, b)
        counts = np.bincount(top, minlength=B)
        gcounts = counts.reshape(G, SUB).sum(axis=1)
        # eighth-pow2 quantization of the longest group row
        mx = int(max(1, gcounts.max()))
        q = max(64, 1 << max(0, mx.bit_length() - 4))
        LDB = max(256, ((mx + q - 1) // q) * q)
        assert self.JOIN_SLAB <= 1 << 21  # qidx packs into 22 bits
        # query cell capacity for the hotter of a uniform miss stream and
        # a hit stream following the DB's own bucket skew, 2.5 sigma
        L0 = self.JOIN_SLAB // self.JOIN_R0
        mean_uni = L0 / B
        mean_hot = L0 * (counts.max() / max(N, 1))
        mean = max(mean_uni, mean_hot, 1.0)
        c = int(np.ceil(mean + 2.5 * np.sqrt(mean) + 8))
        if c * B > 4 * L0:  # degenerate skew: give up on the join
            return None
        starts = np.zeros(G + 1, np.int64)
        np.cumsum(gcounts, out=starts[1:])
        grp = top // SUB
        col = np.arange(N, dtype=np.int64) - starts[grp]
        key = mw.from_hilo(self._np_hi, self._np_lo, self.k)
        sent = np.array(mw.sentinel_words(self.k), np.int64)
        gkey = np.empty((G, LDB) + key.shape[1:], np.int64)
        gkey[:] = sent if key.ndim == 2 else sent[0]
        gkey[grp, col] = key
        gvalues = np.zeros((G, LDB), np.uint32)
        gvalues[grp, col] = self._np_counts[:N]
        dev = self.device
        return {
            "cfg": (self.k, self.P, b, B, G, SUB, LDB, self.JOIN_R0, L0, c),
            "gkey": torch.from_numpy(gkey).to(dev),
            "gvalues": bj.to_device_u32(gvalues, dev),
            "pad_key": torch.arange(B, dtype=torch.int64,
                                    device=dev).repeat_interleave(c),
        }

    def _values_bulk_join(self, key, valid, exists_only=False) -> np.ndarray:
        """Routed join over slabs of R0 x L0 valid queries, on the
        device; only the values cross to the host."""
        g = self._grouped
        cfg = g["cfg"]
        R0, L0 = cfg[7], cfg[8]
        key, valid = self._key_t(key), self._valid_t(valid)
        dev = key.device
        out = torch.zeros(valid.shape[0], dtype=torch.int64, device=dev)
        vidx = torch.nonzero(valid).squeeze(1)
        slab = R0 * L0
        sent = mw.sentinel(self.k, dev)
        for s in range(0, vidx.shape[0], slab):
            take = vidx[s:s + slab]
            n = take.shape[0]
            qk = sent.expand((slab,) + tuple(key.shape[1:])).clone()
            qk[:n] = key[take]
            qk = qk.reshape((R0, L0) + tuple(key.shape[1:]))
            STATS["join_slabs"] += 1
            if exists_only:
                pk, n_ovf, tail = _route_join_kernel(
                    g["gkey"], g["gvalues"], qk, n, g["pad_key"], cfg, True)
                pk = pk.reshape(-1)
                pk = pk[pk != SENTQ]
                v = (pk >> 22) & 1
                dup = (pk >> 31) != 0
                qn = pk & 0x1FFFFF
            else:
                val2, qidx2, n_ovf, tail = _route_join_kernel(
                    g["gkey"], g["gvalues"], qk, n, g["pad_key"], cfg)
                val2, qidx2 = val2.reshape(-1), qidx2.reshape(-1)
                mask = qidx2 != SENTQ
                v, qraw = val2[mask], qidx2[mask]
                dup = (qraw >> 31) != 0
                qn = qraw & 0x7FFFFFFF
            # duplicates copy their run representative's value: results
            # are in sorted-key order, so chains are contiguous
            src = torch.where(dup, 0, torch.arange(v.shape[0], device=dev))
            v = v[torch.cummax(src, 0).values]
            out[take[qn]] = v
            if n_ovf:
                # cell-capacity overflow: those queries exactly through
                # the binary search
                STATS["join_overflow"] += n_ovf
                tq = tail.reshape(-1)
                opos = take[tq[tq != SENTQ]]
                ov = self._bsearch_t(key[opos], torch.ones(
                    opos.shape[0], dtype=torch.bool, device=dev))
                out[opos] = (ov > 0).to(torch.int64) if exists_only else ov
        return bj.download_u32(out)

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

    def values_join(self, key, valid) -> np.ndarray:
        """Sort-merge-join variant of values_bulk: one stable sort of DB
        and queries a slab, no binary search."""
        key, valid = self._key_t(key), self._valid_t(valid)
        Q = valid.shape[0]
        out = torch.zeros(Q, dtype=torch.int64, device=key.device)
        slab = max(self._n, 1 << 22)
        for s in range(0, Q, slab):
            e = min(Q, s + slab)
            STATS["sortjoin_slabs"] += 1
            vals, qidx = _join_kernel(self._key, self._values, key[s:e],
                                      valid[s:e], self.k)
            m = qidx < (e - s)
            out[s + qidx[m]] = vals[m]
        out[~valid] = 0
        return bj.download_u32(out)

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
