"""meryl_tpu_torch's action-tree evaluator against meryl_tpu's, exactly:
BucketEvaluator.eval_buckets, execute_root (DB and printed text) and
execute_compare on the same real DBs, over random nested trees, with
ROW_SPLIT_MIN / ROW_TARGET set small on both evaluators so that the
row-batched path runs at test size; and the port's re-split of rows
longer than the row-sort kernel's MAX_ROW."""

import io

import numpy as np
import pytest

from meryl_tpu import oracle
from meryl_tpu import optree as ref
from meryl_tpu.db import MerylDB
from meryl_tpu_torch import optree
from meryl_tpu_torch.ops import rowsort

K = 9
MERGE = ["union", "union-min", "union-max", "union-sum", "intersect",
         "intersect-min", "intersect-max", "intersect-sum", "subtract",
         "difference", "symmetric-difference"]
UNARY = [("less-than", 3), ("greater-than", 1), ("at-least", 2),
         ("at-most", 2), ("equal-to", 2), ("not-equal-to", 1),
         ("increase", 2), ("decrease", 1), ("multiply", 3), ("divide", 2),
         ("divide-round", 2), ("modulo", 2), ("passthrough", None)]


def _seq(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Three counted DBs over overlapping sequence, and a multiset DB
    holding two instances of some of their k-mers."""
    root = tmp_path_factory.mktemp("torch_optree")
    rng = np.random.default_rng(202)
    shared = _seq(rng, 3000)
    paths = []
    for i in range(3):
        seqs = [shared[i * 500:i * 500 + 2000], _seq(rng, 1500)]
        hi, lo, c = oracle.count_kmers(seqs, K)
        p = str(root / f"d{i}.meryl")
        MerylDB.write(p, K, hi, lo, c)
        paths.append(p)
    hi, lo, c = MerylDB.open(paths[0]).load_all()
    dup = rng.random(len(c)) < 0.3
    order = np.lexsort((np.concatenate([c, c[dup] + 5]),
                        np.concatenate([lo, lo[dup]]),
                        np.concatenate([hi, hi[dup]])))
    ms = str(root / "ms.meryl")
    MerylDB.write(ms, K, np.concatenate([hi, hi[dup]])[order],
                  np.concatenate([lo, lo[dup]])[order],
                  np.concatenate([c, c[dup] + 5])[order], multiset=True)
    return paths, ms


def _tree(seed, paths, mod, depth=2):
    """A random tree of `mod`'s OpNode / DBInput; the same seed gives
    the same tree in both packages."""
    rng = np.random.default_rng(seed)

    def leaf():
        return mod.DBInput(str(paths[rng.integers(0, len(paths))]))

    def build(d):
        if d == 0 or rng.random() < 0.3:
            op, t = UNARY[rng.integers(0, len(UNARY))]
            inner = leaf() if d == 0 else build(d - 1)
            return mod.OpNode(op=op, inputs=[inner], threshold=t)
        op = MERGE[rng.integers(0, len(MERGE))]
        kids = [build(d - 1) if d > 0 and rng.random() < 0.4 else leaf()
                for _ in range(int(rng.integers(2, 4)))]
        return mod.OpNode(op=op, inputs=kids)
    return build(depth)


@pytest.fixture
def small_rows(monkeypatch):
    for cls in (ref.BucketEvaluator, optree.BucketEvaluator):
        monkeypatch.setattr(cls, "ROW_SPLIT_MIN", 256)
        monkeypatch.setattr(cls, "ROW_TARGET", 64)


GROUPS = [tuple(range(g, g + 16)) for g in range(0, 64, 16)]


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("seed", range(10))
def test_eval_buckets_random_trees(dbs, small_rows, seed):
    paths, ms = dbs
    leaves = paths + ([ms] if seed % 3 == 0 else [])
    want_ev = ref.BucketEvaluator(K)
    got_ev = optree.BucketEvaluator(K, "cpu")
    optree.reset_stats()
    for group in GROUPS:
        want = want_ev.eval_buckets(_tree(seed, leaves, ref), group)
        got = got_ev.eval_buckets(_tree(seed, leaves, optree), group)
        _same(got, want)
        assert got[2].dtype == np.uint32
    if seed % 3:                         # no multiset leaf: rows ran
        assert optree.STATS["row_dispatches"] > 0


@pytest.mark.parametrize("seed", [3, 7])
def test_execute_root_db_and_print(dbs, small_rows, tmp_path, seed):
    paths, ms = dbs
    outs = {}
    for name, mod in (("ref", ref), ("port", optree)):
        node = _tree(seed, paths + [ms], mod)
        node.output_path = str(tmp_path / f"{name}.meryl")
        node.print_path = str(tmp_path / f"{name}.txt")
        kw = {} if mod is ref else {"device": "cpu"}
        db = mod.execute_root(node, K, **kw)
        with open(node.print_path, "rb") as f:
            outs[name] = (db.load_all(), db.multiset, db.stats(), f.read())
    _same(outs["port"][0], outs["ref"][0])
    assert outs["port"][1:] == outs["ref"][1:]
    assert len(outs["ref"][3]) > 0


@pytest.mark.parametrize("pair", [(0, 1), (0, 0), ("ms", 0)])
def test_execute_compare(dbs, small_rows, pair):
    paths, ms = dbs
    names = [ms if p == "ms" else paths[p] for p in pair]
    text, same = {}, {}
    for name, mod in (("ref", ref), ("port", optree)):
        node = mod.OpNode(op="compare", inputs=[
            mod.DBInput(names[0]),
            mod.OpNode(op="union-max", inputs=[mod.DBInput(names[1])])])
        out = io.StringIO()
        kw = {} if mod is ref else {"device": "cpu"}
        same[name] = mod.execute_compare(node, K, out=out, **kw)
        text[name] = out.getvalue()
    assert text["port"] == text["ref"]
    assert same["port"] == same["ref"] == (pair == (0, 0))


def _skewed(rng, k):
    """Two sorted-unique inputs, one spread over the key space, one
    packed into a narrow key range."""
    lo_a = np.unique(rng.integers(0, 1 << (2 * k), size=30000,
                                  dtype=np.uint64))
    lo_b = np.unique(rng.integers(1 << 20, (1 << 20) + (1 << 15),
                                  size=12000, dtype=np.uint64))
    return [(np.zeros(len(lo), np.uint64), lo,
             rng.integers(1, 9, size=len(lo)).astype(np.uint32))
            for lo in (lo_a, lo_b)]


@pytest.mark.parametrize("max_row", [rowsort.MAX_ROW, 1024])
def test_rows_longer_than_max_row_are_split(tmp_path, monkeypatch,
                                            max_row):
    """The reference packs two rows of ~21k entries; the port doubles R
    until every row fits MAX_ROW, and the merged output is the same."""
    k = 21
    monkeypatch.setattr(rowsort, "MAX_ROW", max_row)
    ins = _skewed(np.random.default_rng(max_row), k)
    paths = []
    for i, (hi, lo, c) in enumerate(ins):
        paths.append(str(tmp_path / f"s{i}.meryl"))
        MerylDB.write(paths[-1], k, hi, lo, c)
    for cls in (ref.BucketEvaluator, optree.BucketEvaluator):
        monkeypatch.setattr(cls, "ROW_TARGET", 1 << 15)
    want_ev = ref.BucketEvaluator(k)
    got_ev = optree.BucketEvaluator(k, "cpu")
    ref_planes, _, _ = want_ev._pack_rows(ins, 2)
    keys, values, _ = got_ev._pack_rows(ins, 2)
    assert ref_planes[0].shape[1] > max_row          # the first packing
    assert values.shape[1] <= max_row < ref_planes[0].shape[1]
    assert values.shape[0] > ref_planes[0].shape[0]
    group = tuple(range(64))
    for op in ("union-sum", "intersect", "subtract"):
        want = want_ev.eval_buckets(ref.OpNode(
            op=op, inputs=[ref.DBInput(p) for p in paths]), group)
        got = got_ev.eval_buckets(optree.OpNode(
            op=op, inputs=[optree.DBInput(p) for p in paths]), group)
        _same(got, want)


def test_bucket_groups_match_reference(dbs, monkeypatch):
    paths, ms = dbs
    monkeypatch.setenv("MERYL_TPU_SETOP_BATCH", "3000")
    want = ref.bucket_groups(ref.OpNode(
        op="union", inputs=[ref.DBInput(p) for p in paths]))
    got = optree.bucket_groups(optree.OpNode(
        op="union", inputs=[optree.DBInput(p) for p in paths]))
    assert got == want and len(got) > 1
