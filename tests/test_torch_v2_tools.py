"""meryl2's host pieces in the port against the reference: the parser
copy (meryl_tpu_torch/v2/parser.py is meryl_tpu/v2/parser.py but for its
docstrings, and parses every word alike) and the row packer's `extras`
(the label halves packed beside the values)."""

import ast
import os

import numpy as np
import pytest

from meryl_tpu import optree as ref_optree
from meryl_tpu.v2 import parser as ref_parser
from meryl_tpu_torch.ops import multiword as mw
from meryl_tpu_torch.optree import BucketEvaluator
from meryl_tpu_torch.v2 import parser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _code(path):
    """The module's AST dump with every docstring removed."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_parser_is_the_reference_code():
    assert _code(os.path.join(ROOT, "meryl_tpu_torch", "v2", "parser.py")) == \
        _code(os.path.join(ROOT, "meryl_tpu", "v2", "parser.py"))


def _same(a, b):
    """Equal fields, the port's dataclasses against the reference's."""
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(_same(x, y) for x, y in zip(a, b))
    if hasattr(a, "__dataclass_fields__"):
        return type(a).__name__ == type(b).__name__ and \
            a.__dict__.keys() == b.__dict__.keys() and \
            all(_same(getattr(a, f), getattr(b, f)) for f in a.__dict__)
    return a == b


WORDS = [
    ("parse_constant", ("123",)), ("parse_constant", ("123d",)),
    ("parse_constant", ("abch",)), ("parse_constant", ("147o",)),
    ("parse_constant", ("0101b",)), ("parse_constant", ("2k",)),
    ("parse_constant", ("1mi",)), ("parse_constant", ("0x1F",)),
    ("parse_constant", ("5Ti",)), ("parse_constant", ("zz",)),
    ("parse_assign", ("#7", False)), ("parse_assign", ("@2", True)),
    ("parse_assign", ("min#4", False)), ("parse_assign", ("sum", False)),
    ("parse_assign", ("rem#3", False)), ("parse_assign", ("0b001", True)),
    ("parse_assign", ("shift-left#33", True)), ("parse_assign", ("or", True)),
    ("parse_assign", ("bogus", True)),
    ("parse_selector_term", ("value", ">=5", False)),
    ("parse_selector_term", ("value", "@1<@2", True)),
    ("parse_selector_term", ("label", "==ffh", False)),
    ("parse_selector_term", ("value", ">=distinct=0.9", False)),
    ("parse_selector_term", ("value", "<word-frequency=0.01", False)),
    ("parse_selector_term", ("bases", "gc:>=10", False)),
    ("parse_selector_term", ("bases", "acgt,lt4", True)),
    ("parse_selector_term", ("input", "all", False)),
    ("parse_selector_term", ("input", "first:1", False)),
    ("parse_selector_term", ("input", "@1-@3:2-all", True)),
    ("parse_selector_term", ("input", "1-2,any", False)),
    ("parse_selector_term", ("value", "5", False)),
    ("split_class_name", ("o:d=x.meryl",)), ("split_class_name", ("out:sh",)),
    ("split_class_name", ("a:v=min#4",)), ("split_class_name", ("set:l=or",)),
    ("split_class_name", ("s:v:>5",)), ("split_class_name", ("get:i:all",)),
    ("split_class_name", ("o:st=f",)), ("split_class_name", ("o:s",)),
    ("split_class_name", ("i:p=x",)), ("split_class_name", ("random:word=x",)),
]


@pytest.mark.parametrize("fn,args", WORDS, ids=lambda x: str(x))
def test_parser_parses_like_the_reference(fn, args):
    def call(mod):
        try:
            return "ok", getattr(mod, fn)(*args)
        except ValueError as e:
            return "error", str(e)
    got, want = call(parser), call(ref_parser)
    assert got[0] == want[0] and _same(got[1], want[1])


def test_program_text_loads_like_the_reference(tmp_path):
    f = tmp_path / "prog.txt"
    f.write_text("# full-line comment\nunion-sum o:show  # trailing\n"
                 "'one word' \"it's here\"\ntwo\\ words plain a#b\n"
                 "\t\"x 'y' z\"  \n")
    assert parser.load_program_text(str(f)) == \
        ref_parser.load_program_text(str(f))


def _inputs(rng, k, m, n):
    bits = 2 * k
    out = []
    for _ in range(m):
        lo = rng.integers(0, 1 << min(bits, 63), size=n, dtype=np.uint64)
        hi = rng.integers(0, 1 << (bits - 64), size=n, dtype=np.uint64) \
            if bits > 64 else np.zeros(n, np.uint64)
        pair = np.unique(np.stack([hi, lo], axis=1), axis=0)
        c = rng.integers(1, 1 << 32, size=len(pair), dtype=np.uint64)
        out.append((pair[:, 0].copy(), pair[:, 1].copy(), c.astype(np.uint32)))
    return out


@pytest.mark.parametrize("k,m,n", [(21, 2, 20000), (33, 3, 9000),
                                   (16, 5, 3000)])
def test_pack_rows_extras_match_reference(k, m, n):
    """_pack_rows(..., extras=) packs each input's extra arrays as the
    reference's packer does; without extras it returns the three arrays
    it returned before, unchanged."""
    rng = np.random.default_rng(k + m)
    ins = _inputs(rng, k, m, n)
    labs = [rng.integers(0, 1 << 63, size=len(c), dtype=np.uint64)
            for _, _, c in ins]
    ref_extras = [[(lab & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                   (lab >> np.uint64(32)).astype(np.uint32)] for lab in labs]
    extras = [[x.astype(np.int64) for x in e] for e in ref_extras]
    planes, values, ids, ref_packed = \
        ref_optree.BucketEvaluator(k)._pack_rows(ins, m, extras=ref_extras)
    ev = BucketEvaluator(k, "cpu")
    keys, got_values, got_ids, packed = ev._pack_rows(ins, m, extras=extras)
    shape = values.shape
    got_planes = mw.to_planes(keys.reshape((-1,) + keys.shape[2:]), k)
    for g, w in zip(got_planes, planes):
        np.testing.assert_array_equal(g.reshape(shape), w)
    np.testing.assert_array_equal(got_values, values.astype(np.int64))
    np.testing.assert_array_equal(got_ids, ids)
    assert len(packed) == len(ref_packed) == 2
    for g, w in zip(packed, ref_packed):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w.astype(np.int64))
    plain = ev._pack_rows(ins, m)
    assert len(plain) == 3
    for a, b in zip(plain, (keys, got_values, got_ids)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,m,n", [(21, 2, 20000), (33, 3, 9000),
                                   (16, 5, 3000)])
def test_pack_flat_extras_follow_the_values(k, m, n):
    """_pack_flat(..., extras=) lays each input's extra arrays out as the
    reference's flat meryl2 layout (meryl_tpu/v2/cli.py eval_buckets):
    the inputs in turn, beside their values, zero padding after them;
    without extras it returns the three arrays it returned before."""
    rng = np.random.default_rng(k * m)
    ins = _inputs(rng, k, m, n)
    extras = [[rng.integers(0, 1 << 32, size=len(c), dtype=np.int64)
               for _ in range(2)] for _, _, c in ins]
    ev = BucketEvaluator(k, "cpu")
    keys, values, ids, packed = ev._pack_flat(ins, m, extras=extras)
    total = sum(len(c) for _, _, c in ins)
    assert len(packed) == 2
    for j, got in enumerate(packed):
        assert got.dtype == np.int64 and got.shape == values.shape
        np.testing.assert_array_equal(
            got[:total], np.concatenate([e[j] for e in extras]))
        assert not got[total:].any()
    np.testing.assert_array_equal(
        values[:total], np.concatenate([c for _, _, c in ins]))
    plain = ev._pack_flat(ins, m)
    assert len(plain) == 3
    for a, b in zip(plain, (keys, values, ids)):
        np.testing.assert_array_equal(a, b)
