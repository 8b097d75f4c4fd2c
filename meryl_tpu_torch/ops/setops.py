"""Set, filter and arithmetic operations over concatenated input buckets
(counterpart of meryl_tpu/ops/setops.py, whose docstring gives each
operation's value rule and its source in the original meryl).

Layout: keys are the port's int64 words (ops/multiword.py), flat
(L,) / (L, 2) or row-batched (R, L) / (R, L, 2).  Values are uint32 in
the reference; torch has no uint32 arithmetic on the CPU, so they are
held as int64 in [0, 2^32) and masked to 32 bits after every add,
subtract and multiply where the reference wraps.  Comparisons of those
masked values are unsigned by construction.  Input ids are int32.

The row-batched sort goes through the bitonic row-sort kernel
(ops/rowsort.py); the flat and multiset stages sort with plain torch
multi-pass stable sorts, where the reference calls lax.sort outside any
Pallas kernel.
"""

from __future__ import annotations

import torch

from . import multiword as mw
from . import rowsort, segscan

MASK = 0xFFFFFFFF
SENT = 0xFFFFFFFF       # min identity of a uint32 value
BIG_ID = 0x7FFFFFFF     # min identity of an input id / rank

MERGE_OPS = frozenset([
    "union", "union-min", "union-max", "union-sum",
    "intersect", "intersect-min", "intersect-max", "intersect-sum",
    "subtract", "difference", "symmetric-difference", "passthrough",
])
FILTER_OPS = frozenset([
    "less-than", "greater-than", "at-least", "at-most",
    "equal-to", "not-equal-to",
])
MATH_OPS = frozenset([
    "increase", "decrease", "multiply", "divide", "divide-round", "modulo",
])


def _mul_u32(v: torch.Tensor, t: int) -> torch.Tensor:
    """(v * t) mod 2^32 for v in [0, 2^32) and 0 <= t < 2^32, in two
    16-bit halves of t so that no int64 product overflows."""
    lo = v * (t & 0xFFFF)
    hi = ((v * (t >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _apply_value_rule(op: str, m: int, act_len, v_first, first_idx,
                      v_min, v_max, v_sum, threshold):
    """Per-unique-kmer output value (int64 in [0, 2^32)); 0 = suppress."""
    t = int(threshold) & MASK
    zero = torch.zeros_like(v_sum)
    if op == "union":
        return act_len.to(torch.int64)
    if op == "union-min":
        return v_min
    if op == "union-max":
        return v_max
    if op == "union-sum":
        return v_sum
    if op == "passthrough":
        return v_first
    if op.startswith("intersect") and op in MERGE_OPS:
        allin = act_len == m
        base = {"intersect": v_first, "intersect-min": v_min,
                "intersect-max": v_max, "intersect-sum": v_sum}[op]
        return torch.where(allin, base, zero)
    if op == "subtract":
        rest = (v_sum - v_first) & MASK
        ok = (first_idx == 0) & (v_first > rest)
        return torch.where(ok, v_first - rest, zero)
    if op == "difference":
        return torch.where((act_len == 1) & (first_idx == 0), v_first, zero)
    if op == "symmetric-difference":
        return torch.where(act_len == 1, v_first, zero)
    # single-input value filters / arithmetic (applied to v_first)
    v = v_first
    if op == "less-than":
        return torch.where(v < t, v, zero)
    if op == "greater-than":
        return torch.where(v > t, v, zero)
    if op == "at-least":
        return torch.where(v >= t, v, zero)
    if op == "at-most":
        return torch.where(v <= t, v, zero)
    if op == "equal-to":
        return torch.where(v == t, v, zero)
    if op == "not-equal-to":
        return torch.where(v != t, v, zero)
    if op == "increase":
        return (v + t) & MASK
    if op == "decrease":
        return torch.where(v < t, zero, v - t)
    if op == "multiply":
        return _mul_u32(v, t)
    if op == "divide":
        return zero if t == 0 else v // t
    if op == "divide-round":
        if t == 0:
            return zero
        q = v // t
        r = v - q * t
        half = (t >> 1) + (t & 1)   # ceil(t/2): round half up
        q = q + (r >= half).to(torch.int64)
        return torch.where(v < t, torch.ones_like(q), q)
    if op == "modulo":
        return zero if t == 0 else v % t
    raise ValueError(f"unknown operation {op!r}")


def _position_ndim(key: torch.Tensor, k: int) -> int:
    return key.dim() - (mw.num_words(k) == 2)


def _merge_sort_stage(key, values, input_ids, k: int):
    """Stable multiword sort with payloads.

    Accepts flat (L,) or row-batched (R, L) positions.  Rows are sorted
    INDEPENDENTLY (the bitonic row-sort kernel on the GPU) and returned
    flattened: callers split sorted inputs at shared key boundaries into
    rows (optree._pack_rows), so every instance of a key lands in one
    row and the flattened result is globally ordered."""
    if _position_ndim(key, k) == 2:
        skey, val, ids = rowsort.sort_rows(key, values, input_ids, k)
        n = val.numel()
        skey = skey.reshape(n) if mw.num_words(k) == 1 else \
            skey.reshape(n, 2)
        return skey, val.reshape(n), ids.reshape(n)
    skey, (val, ids) = mw.sort(key, k, (values, input_ids), stable=True)
    return skey, val, ids


def merge_op(key, values, input_ids, op: str, m: int, threshold, k: int):
    """Evaluate one set operation over concatenated input buckets.

    key:       int64 key words, all inputs concatenated (padding entries
               carry the sentinel key and value 0); flat or row-batched
               with rows split at key boundaries (no key spans two rows)
    values:    int64 in [0, 2^32) (0 marks padding)
    input_ids: int32 input index per entry (0-based)
    op, m:     operation name and number of inputs
    threshold: the threshold or math constant (an int in [0, 2^32))

    Returns (sorted key, out_values, keep_mask), flat: entries where
    keep_mask is True are the surviving kmers, ascending, value > 0."""
    rowlen = values.shape[-1] if values.dim() == 2 else None
    skey, val, ids = _merge_sort_stage(key, values, input_ids, k)
    return _merge_compute_stage(skey, val, ids, op, m, threshold, k,
                                rowlen)


# ---- multiset (per-instance) evaluation: semantics in the reference's
# comment block above its MS_SIMPLE_OPS (meryl_tpu/ops/setops.py) ----

MS_SIMPLE_OPS = frozenset([
    "union", "union-min", "union-max", "union-sum", "passthrough",
]) | FILTER_OPS | MATH_OPS
MS_MATCH_OPS = frozenset([
    "intersect", "intersect-min", "intersect-max", "intersect-sum",
    "subtract", "difference", "symmetric-difference",
])


def _lexsort(cols) -> torch.Tensor:
    """Permutation that sorts 1-d columns lexicographically, most
    significant first, stably: one stable sort per column from the
    least significant up."""
    order = torch.sort(cols[-1], stable=True).indices
    for c in reversed(cols[:-1]):
        order = order[torch.sort(c[order], stable=True).indices]
    return order


def merge_op_multiset(key, values, input_ids, op: str, m: int,
                      threshold, ms_mask: tuple, k: int):
    """merge_op for multiset inputs (flat only): one output entry per
    instance.  ms_mask: m bools, which inputs are multisets.  Kept
    entries are ascending by kmer (ties by value for union-family
    ops)."""
    if op in MS_SIMPLE_OPS:
        return _ms_simple_stage(key, values, input_ids, op, m, threshold, k)
    if op not in MS_MATCH_OPS:
        raise ValueError(f"operation {op!r} not supported on multisets")
    return _ms_match_stage(key, values, input_ids, op, m, threshold,
                           tuple(bool(b) for b in ms_mask), k)


def _ms_simple_stage(key, values, input_ids, op, m, threshold, k):
    """Sort instances by (kmer, value), the reference's pick order, and
    apply the value rule elementwise (each instance is its own active
    set of 1)."""
    order = _lexsort(mw.split(key, k) + [values])
    skey, val = key[order], values[order]
    present = val > 0
    ones = present.to(torch.int32)
    out = _apply_value_rule(op, m, ones, val, torch.zeros_like(ones),
                            val, val, val, threshold)
    keep = present & (out > 0)
    return skey, out, keep


def _ms_match_stage(key, values, input_ids, op, m, threshold, ms_mask, k):
    L = values.shape[0]
    dev = values.device

    # sort 1: (kmer, input, value) -> per-(kmer, input) instance rank
    o1 = _lexsort(mw.split(key, k) + [input_ids, values])
    s1, ids1, val1 = key[o1], input_ids[o1], values[o1]
    kstart1 = mw.run_starts(s1, k)
    idneq = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       ids1[1:] != ids1[:-1]]) if L else kstart1
    gstart1 = kstart1 | idneq
    ones = torch.ones(L, dtype=torch.int32, device=dev)
    rank = segscan.seg_scan(torch.add, ones, gstart1) - 1

    # sort 2: (kmer, rank, input) -> contiguous (kmer, rank) groups
    o2 = _lexsort(mw.split(s1, k) + [rank, ids1])
    s2, rank2, ids2, val2 = s1[o2], rank[o2], ids1[o2], val1[o2]
    kstart = mw.run_starts(s2, k)
    rneq = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      rank2[1:] != rank2[:-1]]) if L else kstart
    gstart = kstart | rneq

    present = val2 > 0
    ms_any = torch.zeros(L, dtype=torch.bool, device=dev)
    for i in range(m):
        if ms_mask[i]:
            ms_any = ms_any | (ids2 == i)
    pm = present & ms_any    # multiset instances: act at (kmer, rank)
    pn = present & ~ms_any   # non-multiset: wildcard at kmer level

    def group(mask, start):
        ones_g = mask.to(torch.int32)
        act, vsum = segscan.seg_sum_all(
            (ones_g, torch.where(mask, val2, 0)), start)
        prefix = torch.cumsum(ones_g, 0) - ones_g
        vmin, fidx, rbase = segscan.seg_min_all(
            (torch.where(mask, val2, SENT), torch.where(mask, ids2, BIG_ID),
             torch.where(mask, prefix, BIG_ID)), start)
        first_mask = mask & (prefix == rbase)
        vmax, vfirst = segscan.seg_max_all(
            (torch.where(mask, val2, 0), torch.where(first_mask, val2, 0)),
            start)
        return act, vsum & MASK, vmin, fidx, vmax, vfirst

    # group-level reductions over multiset entries, kmer-level ones over
    # non-multiset (wildcard) entries
    g_act, g_sum, g_min, g_fidx, g_max, g_first = group(pm, gstart)
    k_act, k_sum, k_min, k_fidx, k_max, k_first = group(pn, kstart)

    # combined active set per (kmer, rank) group
    act_len = g_act + k_act
    v_sum = (g_sum + k_sum) & MASK
    v_min = torch.minimum(g_min, k_min)
    v_max = torch.maximum(g_max, k_max)
    first_idx = torch.minimum(g_fidx, k_fidx)
    v_first = torch.where(k_fidx < g_fidx, k_first, g_first)

    # per-kmer distinct-input presence (difference / symmetric-difference)
    pres_others = torch.zeros(L, dtype=torch.int32, device=dev)
    distinct = torch.zeros(L, dtype=torch.int32, device=dev)
    for i in range(m):
        pres_i = segscan.seg_max_all(
            (present & (ids2 == i)).to(torch.int32), kstart)
        distinct = distinct + pres_i
        if i > 0:
            pres_others = pres_others + pres_i

    zero = torch.zeros(L, dtype=torch.int64, device=dev)
    if op.startswith("intersect"):
        base = {"intersect": v_first, "intersect-min": v_min,
                "intersect-max": v_max, "intersect-sum": v_sum}[op]
        out = torch.where(act_len == m, base, zero)
    elif op == "subtract":
        rest = (v_sum - v_first) & MASK
        ok = (first_idx == 0) & (v_first > rest)
        out = torch.where(ok, v_first - rest, zero)
    elif op == "difference":
        out = torch.where((first_idx == 0) & (pres_others == 0), v_first,
                          zero)
    else:  # symmetric-difference
        out = torch.where(distinct == 1, v_first, zero)

    keep = gstart & (act_len > 0) & (out > 0)
    return s2, out, keep


# Above this input count the windowed reduction's m-1 shifted passes
# give way to the segmented reductions (the reference's bound, kept for
# parity; not re-measured on the GPU).
_WINDOW_MAX = 16


def _merge_compute_stage(skey, val, ids, op: str, m: int, threshold,
                         k: int, rowlen: int | None = None):
    start = mw.run_starts(skey, k)
    if rowlen is not None:
        # rows were sorted independently: force a run start at every
        # row boundary so no reduction crosses rows (keys never span
        # rows by construction; this only separates each row's
        # sentinel-padding tail from the next row cleanly)
        start = start.view(-1, rowlen).clone()
        start[:, 0] = True
        start = start.view(-1)

    present = val > 0
    if m <= _WINDOW_MAX:
        act_len, v_first, first_idx, v_min, v_max, v_sum = \
            _windowed_reductions(start, present, val, ids, m)
    else:
        act_len, v_first, first_idx, v_min, v_max, v_sum = \
            _scan_reductions(start, present, val, ids)

    out = _apply_value_rule(op, m, act_len, v_first, first_idx,
                            v_min, v_max, v_sum, threshold)
    keep = start & (out > 0) & (act_len > 0)
    return skey, out, keep


def _windowed_reductions(start, present, val, ids, m: int):
    """Per-run reductions evaluated AT RUN START positions by looking
    ahead at most m-1 entries (garbage elsewhere; callers mask by
    `start`).  Valid because each input holds unique keys, so a run has
    <= m present entries, and the stable sort keeps them contiguous at
    the run head."""
    def shift(x, o, fill):
        return torch.cat([x[o:], torch.full((o,), fill, dtype=x.dtype,
                                            device=x.device)])

    # offset 0 = the run-start entry itself; the stable sort puts the
    # lowest-indexed input first, so first value/id come from offset 0
    act = present.to(torch.int32)
    v_sum = torch.where(present, val, 0)
    v_min = torch.where(present, val, SENT)
    v_max = v_sum
    same = torch.ones_like(present)
    for o in range(1, m):
        same = same & ~shift(start, o, True)
        p_o = shift(present, o, False) & same
        v_o = shift(val, o, 0)
        act = act + p_o.to(torch.int32)
        v_sum = (v_sum + torch.where(p_o, v_o, 0)) & MASK
        v_min = torch.minimum(v_min, torch.where(p_o, v_o, SENT))
        v_max = torch.maximum(v_max, torch.where(p_o, v_o, 0))
    return act, val, ids, v_min, v_max, v_sum


def _scan_reductions(start, present, val, ids):
    """Segmented per-run reductions (any run length; used above
    _WINDOW_MAX inputs)."""
    ones = present.to(torch.int32)
    act_len, v_sum = segscan.seg_sum_all(
        (ones, torch.where(present, val, 0)), start)
    # rank within run among present entries (the stable sort preserves
    # the input-then-position order, so rank 0 is the first instance of
    # the lowest-indexed present input)
    prefix = torch.cumsum(ones, 0) - ones
    v_min, first_idx, rank_base = segscan.seg_min_all(
        (torch.where(present, val, SENT), torch.where(present, ids, BIG_ID),
         prefix), start)
    is_first = present & (prefix == rank_base)
    v_max, v_first = segscan.seg_max_all(
        (torch.where(present, val, 0), torch.where(is_first, val, 0)), start)
    return act_len, v_first, first_idx, v_min, v_max, v_sum & MASK
