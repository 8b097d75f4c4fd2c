"""meryl_tpu_torch.v2.engine against meryl_tpu.v2.engine on the CPU:
the same packed inputs (made from a seed with numpy) through both
`merge_action`s give equal sorted keys, output values, label halves and
keep masks, exactly, at every position.

Inputs are packed as the port's CLI packs them (optree.BucketEvaluator
_pack_flat, or _pack_rows with the label halves as extras), then handed
to the reference as its uint32 planes.  Every value assign, every label
assign (shifts and rotates at 0, 1, 31, 32, 33 and 63), every selector
quantity with not / and / or, k in {9, 16, 21, 32, 33}, m in 1..7 (7
takes the segmented-scan path) and a multiset input; flat and
row-packed layouts."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meryl_tpu.v2 import engine as ref_engine
from meryl_tpu_torch.ops import multiword as mw
from meryl_tpu_torch.optree import BucketEvaluator
from meryl_tpu_torch.v2 import engine

MASK = 0xFFFFFFFF
NEAR = 0xFFFFFFF0   # a constant near 2^32


@functools.lru_cache(maxsize=None)
def _inputs(k, m, multiset=False, n=300, seed=0):
    """m sorted inputs of (hi, lo, counts, labels), drawn from one key
    pool so that most keys sit in several inputs.  Counts mix small
    values and values near 2^32; labels are any 64 bits.  At k = 16 and
    32 the pool holds the all-ones k-mer (the padding sentinel's image),
    which sorts last, so it never opens a row."""
    rng = np.random.default_rng(seed + 100 * k + m)
    bits = 2 * k
    lo = rng.integers(0, 1 << min(bits, 63), size=2 * n, dtype=np.uint64)
    hi = rng.integers(0, 1 << (bits - 64), size=2 * n, dtype=np.uint64) \
        if bits > 64 else np.zeros(2 * n, np.uint64)
    if bits % 32 == 0 and bits <= 64:
        lo[0] = np.uint64((1 << bits) - 1)
    pool = np.unique(np.stack([hi, lo], axis=1), axis=0)
    ins = []
    for _ in range(m):
        pick = np.sort(rng.choice(len(pool), size=min(n, len(pool) - 1),
                                  replace=False))
        if multiset:
            pick = np.sort(np.concatenate([pick, pick[::5]]))
        c = rng.integers(1, 30, size=len(pick), dtype=np.uint64)
        big = rng.random(len(pick)) < 0.3
        c[big] = MASK - rng.integers(0, 40, size=int(big.sum()),
                                     dtype=np.uint64)
        lab = rng.integers(0, 1 << 63, size=len(pick), dtype=np.uint64) * \
            np.uint64(2) + rng.integers(0, 2, size=len(pick), dtype=np.uint64)
        ins.append((pool[pick, 0].copy(), pool[pick, 1].copy(),
                    c.astype(np.uint32), lab))
    return ins


def _pack(k, ins, layout):
    """-> int64 keys, values, label halves, int32 ids, as the port's CLI
    packs them (rows: split at shared key boundaries)."""
    ev = BucketEvaluator(k, "cpu")
    m = len(ins)
    triples = [(hi, lo, c) for hi, lo, c, _ in ins]
    halves = [[(lab & np.uint64(MASK)).astype(np.int64),
               (lab >> np.uint64(32)).astype(np.int64)]
              for _, _, _, lab in ins]
    pack = ev._pack_rows if layout == "rows" else ev._pack_flat
    keys, values, ids, (llo, lhi) = pack(triples, m, extras=halves)
    return keys, values, llo, lhi, ids


def _terms(mod, specs):
    return mod.Selector(tuple(tuple(mod.SelectorTerm(*t) for t in p)
                              for p in specs))


def _run_both(k, ins, va, la, specs=(), layout="flat", unique=True):
    """merge_action of both packages on the same packed inputs; assert
    every output equal.  va, la: (op, constant, has_constant, index)."""
    m = len(ins)
    keys, values, llo, lhi, ids = _pack(k, ins, layout)
    shape = values.shape
    vc = va[1] & MASK
    lc = la[1]
    planes = [p.reshape(shape) for p in mw.to_planes(
        keys.reshape((-1,) + keys.shape[values.ndim:]), k)]
    ref = ref_engine.merge_action(
        [jnp.asarray(p) for p in planes], jnp.asarray(values.astype(np.uint32)),
        jnp.asarray(llo.astype(np.uint32)), jnp.asarray(lhi.astype(np.uint32)),
        jnp.asarray(ids), m, k, ref_engine.Assign(*va),
        ref_engine.Assign(*la), _terms(ref_engine, specs), jnp.uint32(vc),
        jnp.uint32(lc & MASK), jnp.uint32((lc >> 32) & MASK),
        unique_inputs=unique)
    got = engine.merge_action(
        *(torch.from_numpy(x) for x in (keys, values, llo, lhi, ids)),
        m, k, engine.Assign(*va), engine.Assign(*la),
        _terms(engine, specs), vc, lc & MASK, (lc >> 32) & MASK,
        unique_inputs=unique)
    skey = mw.from_planes([np.asarray(p).reshape(-1) for p in ref[0]], k)
    np.testing.assert_array_equal(got[0].numpy().reshape(skey.shape), skey)
    for name, r, g in zip(("value", "label lo", "label hi", "keep"),
                          ref[1:], got[1:]):
        g = g.numpy()
        assert g.shape == shape, name
        np.testing.assert_array_equal(g, np.asarray(r).astype(g.dtype),
                                      err_msg=name)
    return int(got[4].sum())


LABEL_CYCLE = ["or", "and", "xor", "min", "max", "lightest", "heaviest",
               "first", "difference"]

VALUE_CASES = [("nop", None), ("first", None), ("count", None),
               ("selected", None), ("atindex", 2), ("atindex", 5),
               ("set", 7), ("set", NEAR)]
VALUE_CASES += [(op, c) for op in ("min", "max", "add", "sub")
                for c in (None, 7, NEAR)]
VALUE_CASES += [(op, c) for op in ("mul", "div", "divzero", "mod")
                for c in (None, 0, 3, NEAR)]


@pytest.mark.parametrize("i", range(len(VALUE_CASES)),
                         ids=lambda i: "{}-{}".format(*VALUE_CASES[i]))
def test_value_assigns_match_reference(i):
    """Every value assign, with its constant absent, zero (a zero
    divisor), small and near 2^32, against values near 2^32; each with a
    label assign from a cycle, flat and row-packed by turns."""
    op, c = VALUE_CASES[i]
    va = (op, c or 0, c is not None, c if op == "atindex" else 0)
    la = (LABEL_CYCLE[i % len(LABEL_CYCLE)], 0x00FF00FF00FF00FF, i % 2 == 0,
          0)
    _run_both(21, _inputs(21, 3), va, la, layout=("flat", "rows")[i % 2])


SHIFTS = (0, 1, 31, 32, 33, 63)
LABEL_CASES = [("nop", None), ("first", None), ("selected", None),
               ("atindex", 2), ("set", 0x123456789ABCDEF0), ("min", None),
               ("max", None), ("lightest", None), ("heaviest", None),
               ("invert", None), ("difference", None)]
LABEL_CASES += [(op, c) for op in ("and", "or", "xor")
                for c in (None, 0xF0F0F0F00F0F0F0F)]
LABEL_CASES += [(op, s) for op in ("shift-left", "shift-right",
                                   "rotate-left", "rotate-right")
                for s in SHIFTS]


@pytest.mark.parametrize("i", range(len(LABEL_CASES)),
                         ids=lambda i: "{}-{}".format(*LABEL_CASES[i]))
def test_label_assigns_match_reference(i):
    op, c = LABEL_CASES[i]
    la = (op, c or 0, c is not None, c if op == "atindex" else 0)
    _run_both(33 if i % 3 == 0 else 21, _inputs(33 if i % 3 == 0 else 21, 3),
              ("add", 0, False, 0), la, layout=("rows", "flat")[i % 2])


def _v(rel, a1, a2, neg=False):
    return ("value", rel, a1, a2, neg)


def _l(rel, a1, a2, neg=False):
    return ("label", rel, a1, a2, neg)


def _b(rel, letters, n, neg=False):
    return ("bases", rel, ("letters", letters), ("const", n), neg)


def _in(flags=(), idx=(), nums=(), neg=False):
    return ("input", "nop", ("spec", (tuple(flags), tuple(idx), tuple(nums))),
            ("const", 0), neg)


OUT, C = ("out", 0), ("const", 20)
SELECTOR_CASES = [
    # (k, value assign, label assign, sum of products)
    (21, "add", "or", [[_v("ge", OUT, C)]]),
    (21, "max", "or", [[_v("gt", ("input", 1), ("input", 2), True)]]),
    (21, "min", "xor", [[_v("lt", OUT, ("input", 1))],
                        [_l("eq", OUT, ("const", 0), True)]]),
    (21, "add", "and", [[_l("gt", OUT, ("const", 1 << 62)),
                         _v("le", OUT, ("const", MASK - 5))]]),
    (21, "first", "or", [[_l("ne", ("input", 1), ("input", 2))]]),
    (21, "count", "or", [[_l("le", ("input", 2), ("const", 0x7FFFFFFF00000000),
                             True)]]),
    (21, "add", "or", [[_b("ge", "GC", 11)], [_b("lt", "A", 3, True)]]),
    (33, "add", "or", [[_b("ge", "CG", 16)], [_b("eq", "T", 8)]]),
    (33, "first", "first", [[_b("le", "ACGT", 33), _in(idx=(2,))]]),
    (21, "add", "or", [[_in(flags=("all",))]]),
    (21, "add", "or", [[_in(flags=("any",), neg=True)], [_in(idx=(3,))]]),
    (21, "add", "or", [[_in(idx=(1,))], [_in(nums=(("exact", 2),))]]),
    (21, "add", "or", [[_in(idx=(2, 3), neg=True)]]),
    (21, "min", "min", [[_in(nums=(("atleast", 2),)),
                         _v("gt", OUT, ("const", 3))]]),
    (21, "add", "or", [[_in(nums=(("exact", 1), ("exact", 3)))]]),
    # selected: the value chosen by the label terms, the label by the
    # value terms, with and without such terms
    (21, "selected", "first", [[_l("gt", OUT, ("const", 1 << 62))]]),
    (21, "selected", "selected", [[_l("lt", OUT, ("input", 2))],
                                  [_v("ge", OUT, ("const", 10))]]),
    (21, "first", "selected", [[_v("gt", ("input", 2), ("const", 15))]]),
    (21, "selected", "selected", [[_in(flags=("all",))]]),
    (21, "selected", "selected", []),
]


@pytest.mark.parametrize("i", range(len(SELECTOR_CASES)))
def test_selectors_match_reference(i):
    k, vop, lop, specs = SELECTOR_CASES[i]
    kept = _run_both(k, _inputs(k, 3), (vop, 0, False, 0), (lop, 0, False, 0),
                     specs, layout=("flat", "rows")[i % 2])
    assert kept > 0


KM_CASES = [(9, 1, "flat"), (9, 1, "rows"), (16, 2, "flat"), (16, 2, "rows"),
            (21, 3, "flat"), (32, 6, "flat"), (32, 6, "rows"),
            (33, 6, "flat"), (33, 6, "rows"), (16, 7, "flat"),
            (33, 7, "flat")]


@pytest.mark.parametrize("k,m,layout", KM_CASES)
def test_k_and_m_match_reference(k, m, layout):
    """m <= 6 takes the windowed reductions (per row when row-packed),
    m = 7 the segmented scans over the flat dispatch."""
    ins = _inputs(k, m)
    specs = [[_in(nums=(("atleast", min(2, m)),))]] if m > 1 else []
    assert _run_both(k, ins, ("add", 0, False, 0), ("heaviest", 0, False, 0),
                     specs, layout=layout) > 0


def test_multiset_input_matches_reference():
    """A multiset input repeats keys within one input: the scan path."""
    ins = _inputs(21, 3, multiset=True)
    assert _run_both(21, ins, ("add", 0, False, 0), ("lightest", 0, False, 0),
                     [[_in(idx=(1,))]], unique=False) > 0


def test_row_packed_segmented_path_is_refused():
    ins = _inputs(21, 3)
    keys, values, llo, lhi, ids = _pack(21, ins, "rows")
    with pytest.raises(ValueError, match="flat dispatch"):
        engine.merge_action(
            *(torch.from_numpy(x) for x in (keys, values, llo, lhi, ids)),
            3, 21, engine.Assign("add"), engine.Assign("or"),
            engine.Selector(), 0, 0, 0, unique_inputs=False)


@pytest.mark.parametrize("k", [16, 21, 32, 33])
def test_count_base_reads_the_reference_planes(k):
    """_count_base on the port's words equals the reference's on its
    planes, for each letter, over random k-mers and the all-ones one."""
    ins = _inputs(k, 1)
    hi, lo = ins[0][0], ins[0][1]
    key = torch.from_numpy(mw.from_hilo(hi, lo, k))
    planes = mw.to_planes(mw.from_hilo(hi, lo, k), k)
    for code in range(4):
        want = np.asarray(ref_engine._count_base(
            [jnp.asarray(p) for p in planes], k, code))
        np.testing.assert_array_equal(
            engine._count_base(key, k, code).numpy(), want.astype(np.int64))


def test_popcount_and_saturation_helpers():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64)
    x[:4] = [0, 1, MASK, 1 << 31]
    y = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64)
    y[:4] = [MASK, 0, MASK, 2]
    xt, yt = (torch.from_numpy(a.astype(np.int64)) for a in (x, y))
    xj, yj = (jnp.asarray(a.astype(np.uint32)) for a in (x, y))
    for got, want in ((engine._popcount32(xt), ref_engine._popcount32(xj)),
                      (engine._sat_add(xt, yt), ref_engine._sat_add(xj, yj)),
                      (engine._sat_mul(xt, yt), ref_engine._sat_mul(xj, yj)),
                      (engine._sat_mul(xt & 0xFFFF, yt & 0x1FFFF),
                       ref_engine._sat_mul(xj & 0xFFFF, yj & 0x1FFFF))):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))
