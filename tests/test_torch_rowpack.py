"""The set-op evaluator's row packing in one native pass
(csrc/rowpack_host.cpp through BucketEvaluator._pack_rows / _pack_flat)
against the numpy packing it replaces: the same inputs packed by both
paths must give the same keys, values and ids bit for bit, shapes (R, L)
and dtypes included, at one and several threads; MERYL_TPU_NO_NATIVE
selects numpy, and optree.STATS counts each path."""

import numpy as np
import pytest

from meryl_tpu_torch import optree
from meryl_tpu_torch.db import MerylDB
from meryl_tpu_torch.ops import multiword as mw
from meryl_tpu_torch.ops import rowsort

KS = (16, 21, 32, 33, 64)
MS = (1, 2, 3, 7)
THREADS = (1, 2, 3, 8, None)


def _pool(rng, n, k):
    """-> sorted distinct unsigned (hi, lo) of about n k-mers."""
    bits = 2 * k
    lo = rng.integers(0, 1 << min(bits, 63), size=n, dtype=np.uint64)
    if bits >= 64:
        lo = (lo << np.uint64(1)) | rng.integers(0, 2, size=n,
                                                 dtype=np.uint64)
    hi = rng.integers(0, 1 << (bits - 64), size=n, dtype=np.uint64) \
        if bits > 64 else np.zeros(n, np.uint64)
    return _sorted_unique(hi, lo)


def _sorted_unique(hi, lo):
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    new = np.ones(len(lo), bool)
    new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    return hi[new], lo[new]


def _with_edges(hi, lo, k):
    """The pool with the all-ones k-mer and the sentinel's (hi, lo)
    added (one key where 2k % 32 == 0)."""
    ones = (1 << (2 * k)) - 1
    s_hi, s_lo = mw.sentinel_hilo(k)
    hi = np.append(hi, np.array([ones >> 64, s_hi], np.uint64))
    lo = np.append(lo, np.array([ones & ((1 << 64) - 1), s_lo], np.uint64))
    return _sorted_unique(hi, lo)


def _counts(rng, n, dtype=np.uint32):
    c = rng.integers(1, 40, size=n).astype(np.uint64)
    big = rng.random(n) < 0.2
    top = 1 << (32 if np.dtype(dtype).itemsize == 4 else 40)
    c[big] = rng.integers(top - 64, top, size=int(big.sum()),
                          dtype=np.uint64)
    return c.astype(dtype)


def _inputs(rng, k, m, n_pool, edges=False, empty=(), dtype=np.uint32,
            repeats=False):
    """m sorted inputs drawn from one pool, so keys overlap; inputs in
    `empty` hold nothing; `repeats` repeats some keys (a multiset)."""
    hi, lo = _pool(rng, n_pool, k)
    if edges:
        hi, lo = _with_edges(hi, lo, k)
    ins = []
    for i in range(m):
        if i in empty:
            pick = np.zeros(0, np.int64)
        else:
            pick = np.sort(rng.choice(len(lo), size=int(rng.integers(
                len(lo) // 4, len(lo))), replace=False))
            if edges:
                pick = np.unique(np.append(pick, [len(lo) - 2, len(lo) - 1]))
            if repeats:
                pick = np.sort(np.concatenate(
                    [pick, rng.choice(pick, size=len(pick) // 3)]))
        ins.append((hi[pick], lo[pick], _counts(rng, len(pick), dtype)))
    return ins


def _skewed(rng, k, m):
    """Input 0 spread over the key space; the others packed into one
    narrow range, so some rows hold keys of one input alone and others
    of the narrow inputs only."""
    ins = []
    for i in range(m):
        if i == 0:
            hi, lo = _pool(rng, 6000, k)
        else:
            lo = np.unique(rng.integers(1 << 20, (1 << 20) + (1 << 13),
                                        size=3000, dtype=np.uint64))
            hi = np.zeros(len(lo), np.uint64)
        ins.append((hi, lo, _counts(rng, len(lo))))
    return ins


# name -> (k, m, layout, inputs); layout "rows" (ROW_TARGET 64),
# "maxrow" (MAX_ROW 512 and ROW_TARGET 2^15, so R doubles), "flat"
def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    kind, rest = name.split("-", 1)
    if kind in ("rows", "flat") and rest[0] == "k":
        k, m = (int(x[1:]) for x in rest.split("-"))
        return k, m, kind, _inputs(rng, k, m, 2000 if kind == "rows" else 80)
    cases = {
        "empty-input-k21": (21, 3, "rows", dict(empty=(1,))),
        "empty-input-k64": (64, 3, "rows", dict(empty=(0,))),
        "empty-input-flat-k33": (33, 2, "flat", dict(empty=(1,))),
        "all-empty-flat-k21": (21, 2, "flat", dict(empty=(0, 1))),
        "edges-k16": (16, 2, "rows", dict(edges=True)),
        "edges-k21": (21, 3, "rows", dict(edges=True)),
        "edges-k32": (32, 2, "rows", dict(edges=True)),
        "edges-k33": (33, 2, "rows", dict(edges=True)),
        "edges-k64": (64, 3, "rows", dict(edges=True)),
        "edges-flat-k32": (32, 2, "flat", dict(edges=True)),
        "u64-counts-k21": (21, 2, "rows", dict(dtype=np.uint64)),
        "i64-counts-k33": (33, 2, "rows", dict(dtype=np.int64)),
        "i32-counts-flat-k21": (21, 3, "flat", dict(dtype=np.int32)),
        "multiset-flat-k21": (21, 2, "flat", dict(repeats=True)),
        "multiset-flat-k64": (64, 3, "flat", dict(repeats=True)),
    }
    if name in cases:
        k, m, layout, kw = cases[name]
        n_pool = 2000 if layout == "rows" else 80
        return k, m, layout, _inputs(rng, k, m, n_pool, **kw)
    k, m, layout = {"one-input-rows-k21": (21, 2, "rows"),
                    "one-input-rows-k21-m3": (21, 3, "rows"),
                    "maxrow-k21": (21, 2, "maxrow"),
                    "maxrow-k33-m3": (33, 3, "maxrow")}[name]
    return k, m, layout, _skewed(rng, k, m)


CASES = ([f"rows-k{k}-m{m}" for k in KS for m in MS]
         + [f"flat-k{k}-m{m}" for k in (16, 21, 33, 64) for m in (1, 3)]
         + ["empty-input-k21", "empty-input-k64", "empty-input-flat-k33",
            "all-empty-flat-k21", "edges-k16", "edges-k21", "edges-k32",
            "edges-k33", "edges-k64", "edges-flat-k32", "u64-counts-k21",
            "i64-counts-k33", "i32-counts-flat-k21", "multiset-flat-k21",
            "multiset-flat-k64", "one-input-rows-k21",
            "one-input-rows-k21-m3", "maxrow-k21", "maxrow-k33-m3"])


def _pack(ev, layout, ins, m):
    if layout == "flat":
        return ev._pack_flat(ins, m)
    return ev._pack_rows(ins, m)


@pytest.mark.parametrize("name", CASES)
def test_native_pack_is_the_numpy_pack(name, monkeypatch):
    """The native pass (1, 2, 3 and 8 threads, and the default) writes
    numpy's keys, values and ids bit for bit, with the same shape and
    dtype; each pack counts its path."""
    k, m, layout, ins = _case(name)
    ev = optree.BucketEvaluator(k, "cpu")
    if layout == "rows":
        ev.ROW_TARGET = 64
    if layout == "maxrow":
        monkeypatch.setattr(rowsort, "MAX_ROW", 512)
        ev.ROW_TARGET = 1 << 15
    monkeypatch.setenv("MERYL_TPU_NO_NATIVE", "1")
    before = dict(optree.STATS)
    want = _pack(ev, layout, ins, m)
    assert optree.STATS["packs_numpy"] == before["packs_numpy"] + 1
    if layout == "maxrow":   # the first packing's rows were too long
        assert want[1].shape[0] > 2
        assert want[1].shape[1] <= rowsort.MAX_ROW
    monkeypatch.delenv("MERYL_TPU_NO_NATIVE")
    assert optree._native_rowpack() is not None
    default = optree.pack_threads
    for threads in THREADS:
        monkeypatch.setattr(optree, "pack_threads",
                            default if threads is None
                            else lambda slots, t=threads: t)
        before = dict(optree.STATS)
        got = _pack(ev, layout, ins, m)
        assert optree.STATS["packs_native"] == before["packs_native"] + 1
        assert optree.STATS["packs_numpy"] == before["packs_numpy"]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.flags.c_contiguous
            np.testing.assert_array_equal(a, b)


def test_no_native_selects_numpy_and_stats_count_each_path(tmp_path,
                                                           monkeypatch):
    """MERYL_TPU_NO_NATIVE and extras (meryl2's labels) take numpy, the
    default the native pass; reset_stats zeroes both counters; a set-op
    dispatch through eval_buckets counts one pack, and both paths give
    the same merged output."""
    rng = np.random.default_rng(7)
    ins = _inputs(rng, 21, 2, 3000)
    ev = optree.BucketEvaluator(21, "cpu")
    ev.ROW_TARGET = 64
    optree.reset_stats()
    assert optree.STATS["packs_native"] == optree.STATS["packs_numpy"] == 0
    assert optree._native_rowpack() is not None
    rows = ev._pack_rows(ins, 2)
    flat = ev._pack_flat(ins, 2)
    assert (optree.STATS["packs_native"], optree.STATS["packs_numpy"]) \
        == (2, 0)
    extras = [[c.astype(np.int64)] for _, _, c in ins]
    got = ev._pack_rows(ins, 2, extras=extras)
    assert (optree.STATS["packs_native"], optree.STATS["packs_numpy"]) \
        == (2, 1)
    for a, b in zip(got[:3], rows):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("MERYL_TPU_NO_NATIVE", "1")
    assert optree._native_rowpack() is None
    for a, b in zip(ev._pack_flat(ins, 2), flat):
        np.testing.assert_array_equal(a, b)
    assert (optree.STATS["packs_native"], optree.STATS["packs_numpy"]) \
        == (2, 2)
    monkeypatch.delenv("MERYL_TPU_NO_NATIVE")
    optree.reset_stats()
    assert optree.STATS["packs_native"] == optree.STATS["packs_numpy"] == 0

    paths = []
    for i, (hi, lo, c) in enumerate(ins):
        paths.append(str(tmp_path / f"in{i}.meryl"))
        MerylDB.write(paths[-1], 21, hi, lo, c)
    node = optree.OpNode(op="union-sum",
                         inputs=[optree.DBInput(p) for p in paths])
    got = ev.eval_buckets(node, tuple(range(64)))
    assert (optree.STATS["packs_native"], optree.STATS["packs_numpy"]) \
        == (1, 0)
    assert optree.STATS["dispatches"] == 1
    monkeypatch.setenv("MERYL_TPU_NO_NATIVE", "1")
    want = ev.eval_buckets(node, tuple(range(64)))
    assert (optree.STATS["packs_native"], optree.STATS["packs_numpy"]) \
        == (1, 1)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
