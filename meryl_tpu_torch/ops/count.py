"""Sort and run-length count of extracted k-mers (counterpart of
meryl_tpu/ops/count.py) for the host sort path: the exactness hatches
of the device accumulator recount a chunk here (sort_starts, then
host_rle_finish).  The compacted merges (merge_counted, merge_many)
leave the unique entries at the front of the array on the device, and
value_histogram bins counts.

Invalid windows are forced to the sentinel key, which sorts last.  The
real all-ones k-mer aliases the sentinel when 2k % 32 == 0; the
sentinel run is corrected by subtracting the invalid count
(host_rle_finish).
"""

from __future__ import annotations

import numpy as np
import torch

from . import multiword as mw


def sort_count(key: torch.Tensor, valid: torch.Tensor, k: int):
    """Sort keys and run-length count duplicates.

    -> (sorted key, counts, start mask, n_unique): entries where start
    is True are the unique valid k-mers in ascending order with their
    counts (> 0)."""
    L = valid.shape[0]
    n_invalid = (~valid).sum()
    skey, _ = mw.sort(mw.where(valid, key, mw.sentinel(k, key.device), k),
                      k)
    start = mw.run_starts(skey, k)
    pos = torch.arange(L, device=key.device)
    sp = torch.where(start, pos, L)
    nxt = torch.cat([torch.flip(torch.cummin(torch.flip(sp, [0]), 0)
                                .values, [0])[1:],
                     torch.full((1,), L, device=key.device)])
    counts = nxt - pos
    counts = counts - torch.where(mw.is_sentinel(skey, k), n_invalid, 0)
    start = start & (counts > 0)
    counts = torch.where(start, counts, 0)
    return skey, counts, start, start.sum()


def sort_starts(key: torch.Tensor, valid: torch.Tensor, k: int,
                rowlen: int | None = None):
    """Sort (as independent rows of `rowlen` when set) and mark run
    starts; the host turns start positions into run lengths
    (host_rle_finish).

    -> (sorted key, start mask, n_invalid): flat, with n_invalid a
    scalar for rowlen=None or a per-row vector.  Invalid entries sort
    into each row's trailing sentinel run."""
    sent = mw.sentinel(k, key.device)
    masked = mw.where(valid, key, sent, k)
    L = valid.shape[0]
    if rowlen is None:
        skey, _ = mw.sort(masked, k)
        return skey, mw.run_starts(skey, k), (~valid).sum()
    if L % rowlen:
        raise ValueError(f"rowlen {rowlen} does not divide {L}")
    rows = L // rowlen
    n_invalid = (~valid).reshape(rows, rowlen).sum(dim=1)
    skey, _ = mw.sort(masked.reshape((rows, rowlen) + key.shape[1:]), k)
    start = mw.run_starts(skey, k)
    return skey.reshape(key.shape), start.reshape(L), n_invalid


def host_rle_finish(skeys_np, start_np, n_invalid, rowlen=None):
    """Host side of sort_starts: unique keys + counts from the start
    mask (numpy; a copy of meryl_tpu/ops/count.py host_rle_finish).
    skeys_np is a list of arrays indexed by position.  n_invalid: int
    scalar (rowlen=None) or per-row vector; each row's last run is its
    sentinel run whenever that row saw invalid entries.

    -> (keys, counts, start_idx); with rowlen set the output is sorted
    per ROW, so callers split at row boundaries."""
    idx = np.flatnonzero(start_np)
    L = len(start_np)
    ends = np.append(idx[1:], L)
    counts = (ends - idx).astype(np.int64)
    if rowlen is None:
        n_invalid = int(n_invalid)
        if n_invalid and len(counts):
            counts[-1] -= n_invalid
            if counts[-1] <= 0:
                idx = idx[:-1]
                counts = counts[:-1]
    else:
        inv = np.asarray(n_invalid, np.int64)
        rows = L // rowlen
        last = np.searchsorted(idx, np.arange(1, rows + 1) * rowlen) - 1
        sel = inv > 0
        if sel.any():
            counts[last[sel]] -= inv[sel]
            keep = counts > 0
            idx = idx[keep]
            counts = counts[keep]
    keys = [p[idx] for p in skeys_np]
    return keys, counts.astype(np.uint64), idx


def _compact_by_flag(flag: torch.Tensor, payloads, k: int | None = None):
    """Stable-sort payloads so entries with flag=True come first, in
    their original order.  A payload with a trailing word axis (a
    two-word key) is gathered by position when k is given."""
    order = torch.sort((~flag).to(torch.int8), stable=True).indices
    return [mw.take(p, order, k) if p.dim() > 1 else p[order]
            for p in payloads]


def merge_many(keys_list, counts_list, k: int):
    """Merge any number of sorted unique sentinel-padded runs (count 0
    marks padding) into one compacted run of their total length: concat
    + sort, then per-run count sums from prefix-sum differences.  Sums
    wrap modulo 2^32, as the reference's uint32 counts do.
    -> (unique keys, counts, n_unique)."""
    key = torch.cat(list(keys_list))
    w = torch.cat(list(counts_list))
    L = w.shape[0]
    dev = w.device
    skey, (w,) = mw.sort(key, k, (w,))
    start = mw.run_starts(skey, k)
    end = torch.cat([start[1:], torch.ones(1, dtype=torch.bool,
                                           device=dev)])
    pre_inc = torch.cumsum(w, 0)
    sum_before, ckey = _compact_by_flag(start, (pre_inc - w, skey), k)
    (sum_through,) = _compact_by_flag(end, (pre_inc,))
    counts = (sum_through - sum_before) & 0xFFFFFFFF
    keep = (torch.arange(L, device=dev) < start.sum()) & (counts > 0)
    return (mw.where(keep, ckey, mw.sentinel(k, dev), k),
            torch.where(keep, counts, 0), keep.sum())


def merge_counted(key_a, counts_a, key_b, counts_b, k: int):
    """merge_many of two runs."""
    return merge_many([key_a, key_b], [counts_a, counts_b], k)


def value_histogram(counts: torch.Tensor, num_values: int) -> torch.Tensor:
    """h[v] = number of entries with count v; counts >= num_values fall
    into the last bin; h[0] is forced to 0, so zero-count padding is
    ignored.  One torch.bincount (the reference's blocked
    compare-and-reduce scan avoids a scatter that is slow on its
    device; the result is the same)."""
    h = torch.bincount(torch.clamp(counts.to(torch.int64),
                                   max=num_values - 1),
                       minlength=num_values)
    h[0] = 0
    return h
