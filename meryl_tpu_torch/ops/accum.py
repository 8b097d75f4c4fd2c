"""Device-accumulator counting: routing and merging (counterpart of
meryl_tpu/ops/accum.py).

Per chunk the device extracts windows, sorts each routing row by key,
maps keys to equal-mass bucket rows and places each bucket's first c
windows in a (B, R0*c) cell grid; overflow windows go to a capture
region (route_chunk_packed).  Every M chunks the staged cells fold into
the sorted (B, La) accumulator (merge_cells).  The host downloads only
the final unique set.

The all-ones k-mer (a real key when 2k % 32 == 0) is excluded on device
and counted by a scalar, so the sentinel never aliases a real key in
the accumulator.  Invalid windows route past the last bucket and drop.

The route and the merge are plain torch: they were XLA programs in the
reference, not Pallas kernels.  The row map is the exact integer map
only: a float map's monotonicity (which the key-sorted routing relies
on) depends on how the compiler rounds x*(2-x).
"""

from __future__ import annotations

import os

import torch

from . import extract_cuda
from . import multiword as mw

# per-routing-row capture capacity for cell-overflow windows: the
# 3-sigma cell slack leaves a thin Poisson tail that the host counts
# exactly from this region instead of recounting the whole chunk
OVF_CAP = 256

_S32 = 0xFFFFFFFF        # route sort key: pads and invalid windows
_OVFK = 0xFFFFFFFE       # route sort key: captured overflow windows


def _pow2_divisor(n: int, cap: int) -> int:
    """Largest power of two that divides n and is <= cap (>= 1)."""
    d = n & -n if n > 0 else 1
    while d > max(1, cap):
        d >>= 1
    return d


def plan_route(chunk_len: int, k: int, expected_uniques: int) -> dict:
    """Static routing/accumulator geometry for one chunk size — the
    reference's plan (meryl_tpu/ops/accum.py plan_route): routing rows
    of L0 = 2^18, B <= 1024 bucket rows, 3-sigma cell slack c, merges
    every M = 8 chunks, and an accumulator row capacity La0 from a
    discounted unique estimate.  L0 always divides chunk_len: the
    MERYL_TPU_ACC_L0 knob clamps to a power-of-two divisor, and so does
    the default when min(2^18, chunk_len) does not divide it."""
    L0 = min(1 << 18, chunk_len)
    if os.environ.get("MERYL_TPU_ACC_L0"):
        L0 = _pow2_divisor(chunk_len, int(os.environ["MERYL_TPU_ACC_L0"]))
    elif chunk_len % L0:
        L0 = _pow2_divisor(chunk_len, L0)
    R0 = max(1, chunk_len // L0)
    M = 8
    vol = max(int(expected_uniques), M * chunk_len)
    B = max(8, min(1 << 10, vol >> 14))
    B = 1 << (B - 1).bit_length()
    if os.environ.get("MERYL_TPU_ACC_B"):
        B = int(os.environ["MERYL_TPU_ACC_B"])
        B = 1 << max(3, min(12, (max(B, 1) - 1).bit_length()))
    mean = max(1.0, L0 / B)
    c = max(8, int(mean + 3.0 * mean ** 0.5 + 4))
    bits = min(2 * k, 16, (B - 1).bit_length() + 6)
    La0 = max(2048, _eighth_round(
        int(expected_uniques * 0.35 // B) + 1))
    return {"B": B, "R0": R0, "L0": L0, "c": c, "bits": bits,
            "M": M, "La0": La0}


def _eighth_round(n: int) -> int:
    q = max(64, 1 << max(0, int(n).bit_length() - 4))
    return ((n + q - 1) // q) * q


def row_from_prefix_int(pref: torch.Tensor, bits: int, B: int,
                        canonical: bool) -> torch.Tensor:
    """Equal-mass prefix -> bucket row map in exact integer arithmetic
    (int64): row = floor(B * F(p / 2^bits)), F(x) = 2x - x^2 for
    canonical keys (min of two uniform draws), F(x) = x otherwise.
    Bit-identical to meryl_tpu's row_from_prefix_int; monotone
    non-decreasing in pref.  Requires bits <= 16."""
    if bits > 16:
        raise ValueError(f"bits must be <= 16, got {bits}")
    if B == 1:
        return torch.zeros_like(pref)
    if canonical:
        d = (1 << bits) - pref
        num32 = ((1 << (2 * bits)) - d * d) << (32 - 2 * bits)
    else:
        num32 = pref << (32 - bits)
    return torch.clamp((num32 * B) >> 32, max=B - 1)


def _top_bits(key: torch.Tensor, k: int, b: int) -> torch.Tensor:
    """Top b bits (b <= 2k) of each k-mer, as int64."""
    words = [w ^ mw.FLIP for w in mw.split(key, k)]  # unsigned bits
    used = 2 * k if len(words) == 1 else 2 * k - 64
    top = words[0]
    if used >= b:
        return (top >> (used - b)) & ((1 << b) - 1)
    need = b - used
    hi = top & ((1 << used) - 1)
    lo = (words[1] >> (64 - need)) & ((1 << need) - 1)
    return (hi << need) | lo


def route_chunk_packed(packed2, exc, n_real, cfg):
    """Packed wire -> ((B, R0*c) cell keys, (R0, OVF_CAP) captured
    overflow keys, n_ovf_row (R0,), n_allones scalar).

    cfg = (k, P, mode, B, R0, L0, c, bits), the reference's tuple (a
    9th row-map element is ignored: the port's map is always "int").
    Cells hold raw windows grouped by bucket row (unsorted within; each
    counts 1), sentinel-padded.  A row whose overflow passes OVF_CAP
    tells the driver to recount the whole chunk on the host path."""
    k, _, mode = cfg[:3]
    key, valid = extract_cuda.extract_kmers_packed(packed2, exc, n_real,
                                                   k, mode)
    return _route_core(key, valid, cfg)


def _route_core(key, valid, cfg):
    k, _, mode, B, R0, L0, c, bits = cfg[:8]
    D = B * c
    dev = key.device
    sent = mw.sentinel(k, dev)
    tail = key.shape[1:]  # () or (2,)

    allones = mw.is_sentinel(key, k) & valid
    n_allones = allones.sum()
    valid = valid & ~allones

    # sort each routing row by the key itself: the row map is monotone
    # in the key, so the key sort groups buckets; invalid windows are
    # masked to the sentinel and order past every real key
    rows = mw.where(valid, key, sent, k).reshape((R0, L0) + tail)
    srt, _ = mw.sort(rows, k)
    inval1 = mw.is_sentinel(srt, k)
    row1 = row_from_prefix_int(_top_bits(srt, k, bits), bits, B,
                               mode == "canonical")
    row1 = torch.where(inval1, B, row1)

    # rank within bucket segment via cummax; kept = first c per bucket
    seg_start = torch.ones((R0, L0), dtype=torch.bool, device=dev)
    seg_start[:, 1:] = row1[:, 1:] != row1[:, :-1]
    iot = torch.arange(L0, device=dev).expand(R0, L0)
    seg_base = torch.cummax(torch.where(seg_start, iot, -1), dim=1).values
    in_range = row1 < B
    kept_q = ((iot - seg_base) < c) & in_range
    is_ovf = ~kept_q & in_range
    n_ovf_row = is_ovf.sum(dim=1)

    # per-(row, bucket) counts: lower bounds of each bucket id in the
    # sorted row (exact, including a row with no invalid windows)
    tgt = torch.arange(B + 1, device=dev).expand(R0, B + 1).contiguous()
    lo_b = torch.searchsorted(row1.contiguous(), tgt)
    n_bucket = lo_b[:, 1:] - lo_b[:, :-1]
    pad_rank = torch.arange(c, device=dev).repeat(B)
    n_slot = n_bucket.repeat_interleave(c, dim=1)
    kept_p = pad_rank[None, :] >= torch.clamp(n_slot, max=c)
    pad_row = torch.arange(B, device=dev).repeat_interleave(c)

    # non-kept real windows key just below the pad key, so they sort
    # into a contiguous capture slice right after the cells
    key2 = torch.cat(
        [torch.where(kept_q, row1, torch.where(is_ovf, _OVFK, _S32)),
         torch.where(kept_p, pad_row[None, :], _S32)], dim=1)
    keys_cat = torch.cat([srt, sent.expand((R0, D) + tail)], dim=1)
    order = torch.sort(key2, dim=1, stable=True).indices
    s = mw.take(keys_cat, order, k)
    cells = s[:, :D].transpose(0, 1).reshape((B, R0 * c) + tail)
    ovf = s[:, D:D + OVF_CAP]
    return cells, ovf, n_ovf_row, n_allones


def merge_cells(acc_key, acc_counts, staged, k: int, La_out: int,
                vmax: int):
    """Fold staged cell groups into the accumulator.

    acc_key: (B, La) sorted unique keys (sentinel padded); acc_counts:
    (B, La) int64 (0 marks padding); staged: cell key tensors, each
    (B, W), raw windows (count 1 each) grouped by bucket row.
    -> (keys (B, La_out), counts (B, La_out), n_runs (B,)).

    The accumulator comes first, so after the stable row sort its entry
    (unique per key) leads its run: count = run length - 1 + leading
    count.  Counts saturate at vmax.  Entries past a row's n_runs are
    sentinel / 0, so no stale key survives into the next merge."""
    B = acc_counts.shape[0]
    dev = acc_counts.device
    keys = torch.cat([acc_key] + list(staged), dim=1)
    W = acc_counts.shape[1] + sum(s.shape[1] for s in staged)
    counts = torch.cat([acc_counts,
                        torch.ones((B, W - acc_counts.shape[1]),
                                   dtype=torch.int64, device=dev)], dim=1)
    skey, (scounts,) = mw.sort(keys, k, (counts,), stable=True)
    start = mw.run_starts(skey, k)

    # run length at starts: next start position via reversed cummin
    iot = torch.arange(W, device=dev).expand(B, W)
    sp = torch.where(start, iot, W)
    suffix_min = torch.flip(torch.cummin(torch.flip(sp, [1]), dim=1)
                            .values, [1])
    nxt = torch.cat([suffix_min[:, 1:],
                     torch.full((B, 1), W, dtype=torch.int64, device=dev)],
                    dim=1)
    total = torch.clamp(nxt - iot - 1 + scounts, max=vmax)
    keep = start & ~mw.is_sentinel(skey, k) & (scounts > 0)
    n_runs = keep.sum(dim=1)

    # compaction: kept entries scatter to their rank, the rest to a
    # dump column past La_out
    dest = torch.cumsum(keep, dim=1) - 1
    dest = torch.where(keep & (dest < La_out), dest, La_out)
    tail = skey.shape[2:]
    new_key = mw.sentinel(k, dev).expand((B, La_out + 1) + tail).clone()
    if tail:
        new_key.scatter_(1, dest.unsqueeze(-1).expand(B, W, 2), skey)
    else:
        new_key.scatter_(1, dest, skey)
    new_counts = torch.zeros((B, La_out + 1), dtype=torch.int64,
                             device=dev)
    new_counts.scatter_(1, dest, torch.where(keep, total, 0))
    return new_key[:, :La_out], new_counts[:, :La_out], n_runs

