"""Device engine for meryl2 actions: (value, label) assigns + selectors
(counterpart of meryl_tpu/v2/engine.py, whose docstring and comments
give each rule's source in the original meryl2).

Per unique kmer the engine computes

  * per-input presence, values and 64-bit labels
  * the assigned output value (14 value rules) and label (18 rules)
  * a selector sum-of-products over value/label/bases/input quantities

`@n` in selectors/assigns refers to the n-th PRESENT input in input
order, not the n-th listed input.

Layout (as ops/setops.py holds v1's): keys are the port's int64 words
(ops/multiword.py), row-packed (R, L) / (R, L, 2) or flat (N,) /
(N, 2); values are int64 in [0, 2^32); a label is two int64 halves in
[0, 2^32), `lab_lo` and `lab_hi`, like the reference's two uint32
planes (`>>` on an int64 is arithmetic, so one int64 bit pattern would
not do); input ids are int32, m the padding id.  Where the reference
wraps a uint32, the port masks to 32 bits.

The row-packed sort is the bitonic row-sort kernel (ops/rowsort.py),
whose `values` payload carries each entry's flat position; the value
and both label halves then follow by a gather.  The flat sort is a
stable torch sort, where the reference calls lax.sort outside any
Pallas kernel.

Column 0 of a row, and the first entry of a flat dispatch, always
starts a run (multiword.run_starts).  The reference instead compares
it with an all-ones prefix, so it drops the all-ones k-mer (which
aliases the padding sentinel at k = 16 and 32) when that k-mer opens a
dispatch row; the port keeps it.  Everywhere else the results are the
reference's, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kmer as km
from ..ops import multiword as mw
from ..ops import rowsort, segscan

MASK = 0xFFFFFFFF
SENT = 0xFFFFFFFF

VALUE_ASSIGNS = ("nop", "set", "first", "selected", "atindex", "min", "max",
                 "add", "sub", "mul", "div", "divzero", "mod", "count")
LABEL_ASSIGNS = ("nop", "set", "first", "selected", "atindex", "min", "max",
                 "and", "or", "xor", "difference", "lightest", "heaviest",
                 "invert", "shift-left", "shift-right", "rotate-left",
                 "rotate-right")
RELATIONS = ("eq", "ne", "le", "ge", "lt", "gt")


@dataclass(frozen=True)
class Assign:
    """One assignment rule.  op from VALUE_ASSIGNS / LABEL_ASSIGNS;
    constant participates where the rule accepts (#X); index for @X."""
    op: str
    constant: int = 0
    has_constant: bool = False
    index: int = 0  # 1-based, for 'atindex' (@X)


@dataclass(frozen=True)
class SelectorTerm:
    """One term: quantity(arg1) relation quantity(arg2).

    quantity: 'value' | 'label' | 'bases' | 'input'
    arg spec: ('out', 0) output value/label; ('input', n) @n (1-based);
              ('const', c) constant.
    For 'bases', arg1 is ('letters', 'ACGT...') — the summed count of
    those letters in the kmer (v2/parser.py emits this shape).
    For 'input', the term is count-style: arg1 ('count',0) = number of
    present inputs, or ('present', n) truth of input n present (then
    relation/arg2 ignored, use rel='eq' const 1).
    """
    quantity: str
    rel: str
    arg1: tuple
    arg2: tuple
    negate: bool = False


@dataclass(frozen=True)
class Selector:
    """Sum of products: OR over groups, AND within group."""
    products: tuple = ()  # tuple[tuple[SelectorTerm, ...], ...]


def _sat_add(a, b):
    """uint32 add saturating at 2^32 - 1 (no int64 sum of two values
    below 2^32 overflows)."""
    return torch.clamp(a + b, max=SENT)


def _sat_mul(a, b):
    """uint32 multiply saturating at 2^32 - 1: overflow iff
    (2^32 - 1) // a < b; the product is taken only where it fits."""
    lim = SENT // torch.clamp(a, min=1)
    ov = (a > 0) & (b > lim)
    return torch.where(ov, SENT, a * torch.where(ov, 0, b))


def _rel(rel: str, a, b):
    return {"eq": a == b, "ne": a != b, "le": a <= b,
            "ge": a >= b, "lt": a < b, "gt": a > b}[rel]


def _rel64(rel: str, a, b):
    """Relation over (lo, hi) 32-bit-half pairs of 64-bit quantities."""
    alo, ahi = a
    blo, bhi = b
    if rel == "eq":
        return (alo == blo) & (ahi == bhi)
    if rel == "ne":
        return (alo != blo) | (ahi != bhi)
    lt = (ahi < bhi) | ((ahi == bhi) & (alo < blo))
    eq = (alo == blo) & (ahi == bhi)
    return {"lt": lt, "le": lt | eq, "gt": ~(lt | eq), "ge": ~lt}[rel]


def _popcount32(x):
    """SWAR popcount of values in [0, 2^32) held as int64 (torch has no
    popcount); the byte sum's multiply wraps at 32 bits as a uint32's
    does."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK) >> 24


def _key_planes(skey, k: int):
    """The reference's uint32 planes of the int64 key words, least
    significant first: each word, bit 63 unflipped, is two planes."""
    planes = []
    for w in reversed(mw.split(skey, k)):
        planes.append(w & MASK)
        planes.append(((w >> 32) & MASK) ^ 0x80000000)
    return planes[:km.num_planes(k)]


def _count_base(skey, k: int, code: int):
    """Number of bases equal to `code` in each kmer (the reference's
    countNonZeroBases xor trick over its 32-bit planes)."""
    planes = _key_planes(skey, k)
    total = torch.zeros_like(planes[0])
    remaining = 2 * k
    cvt = code * 0x55555555 & MASK
    for p, pl in enumerate(planes):
        bits_here = min(32, remaining - 32 * p) if remaining - 32 * p > 0 else 0
        if bits_here <= 0:
            break
        x = pl ^ cvt  # base==code -> bits 00
        # squash pairs: bit set if either bit of the pair is set
        sq = (x | (x >> 1)) & 0x55555555
        if bits_here < 32:
            sq = sq & ((1 << bits_here) - 1)
        total = total + (bits_here // 2 - _popcount32(sq))
    return total


def _label_popcount(lab):
    lo, hi = lab
    return _popcount32(lo) + _popcount32(hi)


def _action_sort_stage(key, values, lab_lo, lab_hi, input_ids, k: int):
    """Stable sort with payloads along the last position axis.

    Row-packed (values (R, L)): one launch of the bitonic row-sort
    kernel, whose int64 payload is each entry's flat position; ties keep
    their column order, so the order is the reference's stable one.
    Flat: a stable multiword torch sort."""
    if values.dim() == 2:
        pos = torch.arange(values.numel(), dtype=torch.int64,
                           device=values.device).view(values.shape)
        skey, spos, ids = rowsort.sort_rows(key, pos, input_ids, k)
        flat = spos.reshape(-1)

        def take(x):
            return x.reshape(-1)[flat].view(values.shape)
        return skey, take(values), take(lab_lo), take(lab_hi), ids
    skey, (val, llo, lhi, ids) = mw.sort(
        key, k, (values, lab_lo, lab_hi, input_ids), stable=True)
    return skey, val, llo, lhi, ids


def merge_action(key, values, lab_lo, lab_hi, input_ids,
                 m: int, k: int, vassign: Assign, lassign: Assign,
                 sel: Selector, vconst, lconst_lo, lconst_hi,
                 unique_inputs: bool = True):
    """Evaluate one meryl2 action over concatenated input buckets.

    key: int64 key words; values: int64 in [0, 2^32) (0 = padding);
    lab_lo/lab_hi: label halves; input_ids: int32 (m = padding id);
    vconst, lconst_lo, lconst_hi: ints (or 0-d tensors) in [0, 2^32).
    Returns (sorted key, out_values, out_lab_lo, out_lab_hi, keep),
    each shaped like the input positions ((R, L) stays (R, L)).

    The sort stage, then the compute stage."""
    skey, val, llo, lhi, ids = _action_sort_stage(
        key, values, lab_lo, lab_hi, input_ids, k)
    return _action_compute_stage(skey, val, llo, lhi, ids, m, k,
                                 vassign, lassign, sel, vconst,
                                 lconst_lo, lconst_hi, unique_inputs)


def _action_compute_stage(skey, val, llo, lhi, ids,
                          m: int, k: int, vassign: Assign, lassign: Assign,
                          sel: Selector, vconst, lconst_lo, lconst_hi,
                          unique_inputs: bool = True):
    N = val.shape  # full shape: (N,) flat or (R, L) row-packed
    dev = val.device

    def full(c, dtype=torch.int64):
        return torch.full(N, c, dtype=dtype, device=dev)

    # run-start mask along the last axis; rows never split a run
    # (optree._pack_rows cuts at shared key boundaries)
    start = mw.run_starts(skey, k)

    present = val > 0
    pres1 = present.to(torch.int32)
    words = mw.split(skey, k)

    # per-run reductions broadcast to every element.  Runs of
    # unique-keyed inputs hold at most m entries, so for small m they are
    # 2(m-1) shifted elementwise passes sharing one set of same-run
    # masks, along the last axis (so per row of (R, L)); otherwise
    # segmented reductions over the flat dispatch.
    if unique_inputs and m <= 6:  # m == 1 -> identity reductions
        same_f = []  # same_f[d-1][i]: key[i] == key[i-d]
        same_b = []  # same_b[d-1][i]: key[i] == key[i+d]
        for d in range(1, m):
            eq = None
            for p in words:
                e = p[..., d:] == p[..., :-d]
                eq = e if eq is None else (eq & e)
            pad = torch.zeros(N[:-1] + (d,), dtype=torch.bool, device=dev)
            same_f.append(torch.cat([pad, eq], dim=-1))
            same_b.append(torch.cat([eq, pad], dim=-1))

        def _win(x, neutral, op):
            acc = x
            for d in range(1, m):
                padv = torch.full(x.shape[:-1] + (d,), neutral,
                                  dtype=x.dtype, device=dev)
                f = torch.cat([padv, x[..., :-d]], dim=-1)
                b = torch.cat([x[..., d:], padv], dim=-1)
                acc = op(acc, torch.where(same_f[d - 1], f, neutral))
                acc = op(acc, torch.where(same_b[d - 1], b, neutral))
            return acc

        def ssum(x):
            return _win(x, 0, torch.add)

        def smin(x):
            # int64 holds uint32 quantities, int32 the ranks
            neutral = SENT if x.dtype == torch.int64 else 2**31 - 1
            return _win(x, neutral, torch.minimum)

        def smax(x):
            return _win(x, 0, torch.maximum)
    else:
        if val.dim() != 1:
            raise ValueError("segmented reductions need a flat dispatch: "
                             "row-pack only unique inputs with m <= 6")

        def ssum(x):
            return segscan.seg_sum_all(x, start)

        def smin(x):
            return segscan.seg_min_all(x, start)

        def smax(x):
            return segscan.seg_max_all(x, start)

    act_len = ssum(pres1)

    # rank of each present entry among present entries of its run
    prefix = torch.cumsum(pres1, dim=-1, dtype=torch.int32) - pres1
    rank = prefix - smin(prefix)  # 0-based among present (stable order)

    at_rank = {}

    def _at_rank(r):
        """(value, label lo, label hi) of the 1-based @r present input,
        computed once a rank."""
        if r not in at_rank:
            mask = present & (rank == r - 1)
            at_rank[r] = tuple(ssum(torch.where(mask, x, 0))
                               for x in (val, llo, lhi))
        return at_rank[r]

    def value_at_rank(r):  # 1-based @r
        return _at_rank(r)[0]

    def label_at_rank(r):
        return _at_rank(r)[1:]

    v_first = value_at_rank(1)
    l_first = label_at_rank(1)
    v_min = smin(torch.where(present, val, SENT))
    v_max = smax(torch.where(present, val, 0))

    # ---- value=selected / label=selected: the documented intent (the
    # value of the first present input whose label passes the
    # label-restricted selector terms, and vice versa), with the first
    # input as the fallback (see the reference's comment) ----
    def _rank_passes(prods, quantity, r):
        cand_v = value_at_rank(r)
        cand_l = label_at_rank(r)
        any_ok = None
        for product in prods:
            p_ok = None
            for t in product:
                if quantity == "value":
                    def q(which):
                        kind, x = which
                        if kind == "out":
                            return cand_v
                        if kind == "input":
                            return value_at_rank(x)
                        return full(x & MASK)
                    tm = _rel(t.rel, q(t.arg1), q(t.arg2))
                else:
                    def q(which):
                        kind, x = which
                        if kind == "out":
                            return cand_l
                        if kind == "input":
                            return label_at_rank(x)
                        return (full(x & MASK), full((x >> 32) & MASK))
                    tm = _rel64(t.rel, q(t.arg1), q(t.arg2))
                if t.negate:
                    tm = ~tm
                p_ok = tm if p_ok is None else (p_ok & tm)
            any_ok = p_ok if any_ok is None else (any_ok | p_ok)
        return any_ok

    def _selected_rank(quantity):
        """Chosen 1-based rank per element, 0 = no input passes; None
        when the selector has no terms of this quantity."""
        prods = [[t for t in product if t.quantity == quantity]
                 for product in sel.products]
        prods = [p for p in prods if p]
        if not prods:
            return None
        chosen = full(0, torch.int32)
        for r in range(m, 0, -1):
            ok = _rank_passes(prods, quantity, r) & (act_len >= r)
            chosen = torch.where(ok, r, chosen)
        return chosen

    # ---- output value ----
    vc = int(vconst) & MASK
    op = vassign.op
    if op in ("nop", "first"):
        out_v = v_first
    elif op == "selected":
        chosen = _selected_rank("label")
        out_v = v_first
        if chosen is not None:
            for r in range(1, m + 1):
                out_v = torch.where(chosen == r, value_at_rank(r), out_v)
    elif op == "set":
        out_v = full(vc)
    elif op == "atindex":
        out_v = value_at_rank(vassign.index)
    elif op == "min":
        out_v = torch.clamp(v_min, max=vc) if vassign.has_constant else v_min
    elif op == "max":
        out_v = torch.clamp(v_max, min=vc) if vassign.has_constant else v_max
    elif op in ("add", "sum"):
        # saturating sum over present inputs + constant (default 0)
        acc = full(vc if vassign.has_constant else 0)
        for r in range(1, m + 1):
            acc = _sat_add(acc, value_at_rank(r))  # absent rank -> +0
        out_v = acc
    elif op in ("sub", "dif"):
        # sequential clamped subtraction == one clamp against the
        # SATURATING sum of the other inputs + constant
        rest = full(0)
        for r in range(2, m + 1):
            rest = _sat_add(rest, value_at_rank(r))
        if vassign.has_constant:
            rest = _sat_add(rest, full(vc))
        out_v = torch.where(v_first > rest, v_first - rest, 0)
    elif op == "mul":
        # saturating product; constant default 1
        acc = full(vc if vassign.has_constant else 1)
        for r in range(1, m + 1):
            has = act_len >= r
            acc = torch.where(has, _sat_mul(acc, value_at_rank(r)), acc)
        out_v = acc
    elif op == "div":
        # SEQUENTIAL division by each present input then the constant
        # (default 1), divide-by-zero -> 0
        acc = v_first
        for r in range(2, m + 1):
            has = act_len >= r
            acc = torch.where(
                has, acc // torch.clamp(value_at_rank(r), min=1), acc)
        if vassign.has_constant:
            acc = acc // max(vc, 1) if vc > 0 else torch.zeros_like(acc)
        out_v = acc
    elif op == "divzero":
        # sequential rounding division; 0 <= acc < divisor rounds up to
        # 1, divide-by-zero -> 0; constant default 1 applies the same
        # rule (0 -> 1)
        def _divz_step(acc, d):
            d1 = torch.clamp(d, min=1)
            qt = acc // d1
            rem = acc - qt * d1
            up = rem >= (d - rem)  # 2*rem >= d, overflow-free
            rounded = qt + up.to(torch.int64)
            return torch.where(d == 0, 0, torch.where(acc < d, 1, rounded))
        acc = v_first
        for r in range(2, m + 1):
            has = act_len >= r
            acc = torch.where(has, _divz_step(acc, value_at_rank(r)), acc)
        out_v = _divz_step(acc, full(vc if vassign.has_constant else 1))
    elif op in ("mod", "rem"):
        # sequential quotient/remainder accumulation: q walks the
        # division chain, the remainders sum (wrapping at 32 bits); a
        # zero divisor dumps q into the remainder.  Constant default 0
        # -> the leftover quotient joins the remainder at the end.
        q = v_first
        racc = full(0)
        for r in range(2, m + 1):
            has = act_len >= r
            d = torch.clamp(value_at_rank(r), min=1)  # present => >0
            qt = q // d
            racc = torch.where(has, (racc + (q - qt * d)) & MASK, racc)
            q = torch.where(has, qt, q)
        c = vc if vassign.has_constant else 0
        rem = q - (q // c) * c if c > 0 else q
        out_v = (racc + rem) & MASK
    elif op == "count":
        out_v = act_len.to(torch.int64)
    else:
        raise ValueError(f"value assign {op!r}")

    # ---- output label ----
    lo_c, hi_c = int(lconst_lo) & MASK, int(lconst_hi) & MASK
    lop = lassign.op

    # bitwise AND/OR/XOR across the run: fold per-rank contributions
    def fold_labels(fold, init_lo, init_hi, with_const):
        alo, ahi = full(init_lo), full(init_hi)
        for r in range(1, m + 1):
            rl, rh = label_at_rank(r)
            has = act_len >= r
            alo = torch.where(has, fold(alo, rl), alo)
            ahi = torch.where(has, fold(ahi, rh), ahi)
        if with_const and lassign.has_constant:
            alo, ahi = fold(alo, lo_c), fold(ahi, hi_c)
        return alo, ahi

    if lop in ("nop", "first"):
        out_llo, out_lhi = l_first
    elif lop == "selected":
        chosen = _selected_rank("value")
        out_llo, out_lhi = l_first
        if chosen is not None:
            for r in range(1, m + 1):
                rl, rh = label_at_rank(r)
                out_llo = torch.where(chosen == r, rl, out_llo)
                out_lhi = torch.where(chosen == r, rh, out_lhi)
    elif lop == "set":
        out_llo, out_lhi = full(lo_c), full(hi_c)
    elif lop == "atindex":
        out_llo, out_lhi = label_at_rank(lassign.index)
    elif lop == "and":
        out_llo, out_lhi = fold_labels(torch.bitwise_and, MASK, MASK, True)
    elif lop == "or":
        out_llo, out_lhi = fold_labels(torch.bitwise_or, 0, 0, True)
    elif lop == "xor":
        out_llo, out_lhi = fold_labels(torch.bitwise_xor, 0, 0, True)
    elif lop == "difference":
        alo, ahi = l_first
        for r in range(2, m + 1):
            rl, rh = label_at_rank(r)
            alo = alo & ~rl
            ahi = ahi & ~rh
        out_llo, out_lhi = alo, ahi
    elif lop in ("min", "max"):
        # label of the kmer with the min/max value
        tgt = v_min if lop == "min" else v_max
        hit = present & (val == tgt)
        mask = hit & (rank == smin(torch.where(hit, rank, 1 << 30)))
        out_llo = ssum(torch.where(mask, llo, 0))
        out_lhi = ssum(torch.where(mask, lhi, 0))
    elif lop in ("lightest", "heaviest"):
        w = _label_popcount((llo, lhi)).to(torch.int32)
        tgt = (smin(torch.where(present, w, 1 << 30)) if lop == "lightest"
               else smax(torch.where(present, w, -1)))
        mask = present & (w == tgt)
        first_mask = mask & (rank == smin(torch.where(mask, rank, 1 << 30)))
        out_llo = ssum(torch.where(first_mask, llo, 0))
        out_lhi = ssum(torch.where(first_mask, lhi, 0))
    elif lop == "invert":
        out_llo, out_lhi = ~l_first[0] & MASK, ~l_first[1] & MASK
    elif lop in ("shift-left", "shift-right", "rotate-left", "rotate-right"):
        s = int(lassign.constant) % 64
        # shifts of the 64-bit label as two 32-bit halves
        lo0, hi0 = l_first

        def shl(lo, hi, s):
            if s == 0:
                return lo, hi
            if s >= 32:
                return (torch.zeros_like(lo),
                        (lo << (s - 32)) & MASK if s > 32 else lo)
            return (lo << s) & MASK, ((hi << s) | (lo >> (32 - s))) & MASK

        def shr(lo, hi, s):
            if s == 0:
                return lo, hi
            if s >= 32:
                return hi >> (s - 32) if s > 32 else hi, torch.zeros_like(hi)
            return (lo >> s) | ((hi << (32 - s)) & MASK), hi >> s
        if lop == "shift-left":
            out_llo, out_lhi = shl(lo0, hi0, s)
        elif lop == "shift-right":
            out_llo, out_lhi = shr(lo0, hi0, s)
        elif s == 0:
            out_llo, out_lhi = lo0, hi0
        else:
            a, b = (shl, shr) if lop == "rotate-left" else (shr, shl)
            l1, h1 = a(lo0, hi0, s)
            l2, h2 = b(lo0, hi0, 64 - s)
            out_llo, out_lhi = l1 | l2, h1 | h2
    else:
        raise ValueError(f"label assign {lop!r}")

    # ---- selector ----
    def present_in_listed(x):
        """Truth that the 1-based LISTED input x holds the kmer."""
        return ssum((present & (ids == x - 1)).to(torch.int32)) > 0

    def term_quantity(t: SelectorTerm, which):
        kind, x = which
        if t.quantity == "value":
            if kind == "out":
                return out_v
            if kind == "input":
                return value_at_rank(x)
            return full(x & MASK)
        if t.quantity == "label":
            if kind == "out":
                return (out_llo, out_lhi)
            if kind == "input":
                return label_at_rank(x)
            return (full(x & MASK), full((x >> 32) & MASK))
        if t.quantity == "bases":
            if kind == "letters":
                total = None
                for ch in x:
                    code = {"A": 0, "C": 1, "T": 2, "G": 3}[ch]
                    c = _count_base(skey, k, code)
                    total = c if total is None else total + c
                return total
            return full(x & MASK)
        raise ValueError(t.quantity)

    def eval_term(t: SelectorTerm):
        if t.quantity == "input":
            flags, idx, nums = t.arg1[1]
            ok = None
            cnt_ok = None
            if "any" in flags:
                cnt_ok = act_len >= 1
            if "all" in flags:
                c = act_len == m
                cnt_ok = c if cnt_ok is None else (cnt_ok | c)
            for kind2, n in nums:
                c = (act_len >= n) if kind2 == "atleast" else (act_len == n)
                cnt_ok = c if cnt_ok is None else (cnt_ok | c)
            idx_ok = None
            for x in idx:
                c = present_in_listed(x)
                idx_ok = c if idx_ok is None else (idx_ok & c)
            for part in (cnt_ok, idx_ok):
                if part is not None:
                    ok = part if ok is None else (ok & part)
            if ok is None:
                ok = act_len >= 1
            return ~ok if t.negate else ok
        a = term_quantity(t, t.arg1)
        b = term_quantity(t, t.arg2)
        tm = _rel64(t.rel, a, b) if t.quantity == "label" else _rel(t.rel, a, b)
        return ~tm if t.negate else tm

    if sel.products:
        selected = None
        for product in sel.products:
            pmask = None
            for t in product:
                tm = eval_term(t)
                pmask = tm if pmask is None else (pmask & tm)
            selected = pmask if selected is None else (selected | pmask)
    else:
        selected = full(True, torch.bool)

    keep = start & selected & (act_len > 0) & (out_v > 0)
    return skey, out_v, out_llo, out_lhi, keep
