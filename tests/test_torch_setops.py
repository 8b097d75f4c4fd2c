"""meryl_tpu_torch set operations against meryl_tpu's, exactly.

Every op of MERGE_OPS | FILTER_OPS | MATH_OPS goes through merge_op,
flat and row-batched, for m in {1, 2, 3, 17} inputs (17 takes the
segmented-reduction path above _WINDOW_MAX), on the same packed inputs
made from a seed with numpy (tests/torch_setops_data.py; the multiset
merge is in test_torch_setops_multiset.py).  Values reach
2^32 - 1 so that sums and products wrap; thresholds include 0; the
all-ones k-mer is a real key at k = 16 and 32, where the padding
sentinel aliases it.  segscan is held against meryl_tpu.ops.segscan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meryl_tpu.ops import segscan as ref_segscan
from meryl_tpu.ops import setops as ref_setops
from meryl_tpu_torch.ops import multiword as mw
from meryl_tpu_torch.ops import segscan, setops
from tests import torch_setops_data as D
from tests.torch_setops_data import CASES, THRESHOLDS


def _ref_merge(planes, values, ids, op, m, t):
    return ref_setops.merge_op([jnp.asarray(p) for p in planes],
                               jnp.asarray(values), jnp.asarray(ids), op, m,
                               jnp.asarray(np.uint32(t)))


@pytest.mark.parametrize("op,m", CASES)
def test_merge_op_flat_matches_reference(op, m):
    k = D.case_k(op, m)
    ins = D.inputs(m * 31 + len(op), m, k)
    planes, values, ids = D.flat(ins, m, k)
    for t in THRESHOLDS:
        want = _ref_merge(planes, values, ids, op, m, t)
        got = setops.merge_op(*D.port_args(planes, values, ids, k), op, m, t,
                              k)
        D.assert_same(want, got, k)


@pytest.mark.parametrize("op,m", CASES)
def test_merge_op_rows_matches_reference(op, m):
    k = D.case_k(op, m)
    ins = D.inputs(m * 37 + len(op), m, k, n_pool=400)
    planes, values, ids = D.rows(ins, m, k)
    assert planes[0].shape[0] > 1            # several rows
    for t in THRESHOLDS:
        want = _ref_merge(planes, values, ids, op, m, t)
        got = setops.merge_op(*D.port_args(planes, values, ids, k), op, m, t,
                              k)
        D.assert_same(want, got, k)


def test_unknown_op_raises():
    planes, values, ids = D.flat(D.inputs(1, 1, 21), 1, 21)
    with pytest.raises(ValueError):
        setops.merge_op(*D.port_args(planes, values, ids, 21), "no-such-op",
                        1, 0, 21)
    with pytest.raises(ValueError):
        setops.merge_op_multiset(*D.port_args(planes, values, ids, 21),
                                 "no-such-op", 1, 0, (True,), 21)


@pytest.mark.parametrize("k", [16, 32])
def test_allones_kmer_survives_padding(k):
    """The all-ones k-mer is a real key whose words equal the padding
    sentinel's at k = 16 and 32: the stable sort keeps it ahead of the
    padding, and it survives a union-sum on both paths."""
    ins = D.inputs(k, 2, k, n_pool=400)
    assert all(lo[-1] == (1 << (2 * k)) - 1 for _, lo, _ in ins)
    for planes, values, ids in (D.flat(ins, 2, k), D.rows(ins, 2, k)):
        skey, vals, keep = setops.merge_op(
            *D.port_args(planes, values, ids, k), "union-sum", 2, 0, k)
        hi, lo = mw.to_hilo(skey[keep].numpy(), k)
        assert lo[-1] == (1 << (2 * k)) - 1
        want = (int(ins[0][2][-1]) + int(ins[1][2][-1])) & 0xFFFFFFFF
        assert int(vals[keep][-1]) == want


# ---------------------------------------------------------------- segscan

_SEG_OPS = [(torch.add, jnp.add), (torch.minimum, jnp.minimum),
            (torch.maximum, jnp.maximum)]


def _seg_inputs(seed, n=300):
    rng = np.random.default_rng(seed)
    start = rng.random(n) < 0.2
    start[0] = rng.random() < 0.5        # a run may open without a flag
    a = rng.integers(-1000, 1000, size=n).astype(np.int32)
    u = D.values(rng, n)
    return start, a, u


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("i", range(3))
@pytest.mark.parametrize("reverse", [False, True])
def test_seg_scan_matches_reference(i, reverse):
    start, a, u = _seg_inputs(i + 10 * reverse)
    top, jop = _SEG_OPS[i]
    want = ref_segscan.seg_scan(jop, (jnp.asarray(a), jnp.asarray(u)),
                                jnp.asarray(start), reverse=reverse)
    got = segscan.seg_scan(top, (torch.from_numpy(a),
                                 torch.from_numpy(u.astype(np.int64))),
                           torch.from_numpy(start), reverse=reverse)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(_u32(got[1].numpy()), _u32(want[1]))


@pytest.mark.parametrize("name", ["seg_sum_all", "seg_min_all",
                                  "seg_max_all"])
def test_seg_all_matches_reference(name):
    start, a, u = _seg_inputs(len(name))
    want = getattr(ref_segscan, name)((jnp.asarray(a), jnp.asarray(u)),
                                      jnp.asarray(start))
    got = getattr(segscan, name)((torch.from_numpy(a),
                                  torch.from_numpy(u.astype(np.int64))),
                                 torch.from_numpy(start))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(_u32(got[1].numpy()), _u32(want[1]))
    single = getattr(segscan, name)(torch.from_numpy(a),
                                    torch.from_numpy(start))
    assert torch.equal(single, got[0])
