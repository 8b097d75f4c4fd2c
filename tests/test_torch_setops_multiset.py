"""meryl_tpu_torch multiset merge (one output entry per instance)
against meryl_tpu's, exactly: every op of MERGE_OPS | FILTER_OPS |
MATH_OPS through merge_op_multiset, for m in {1, 2, 3, 17} inputs of
which every other one is a multiset, on inputs made from a seed with
numpy (tests/torch_setops_data.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from meryl_tpu.ops import setops as ref_setops
from meryl_tpu_torch.ops import setops
from tests import torch_setops_data as D
from tests.torch_setops_data import CASES, THRESHOLDS


@pytest.mark.parametrize("op,m", CASES)
def test_merge_op_multiset_matches_reference(op, m):
    k = D.case_k(op, m)
    ms_mask = tuple(bool(i % 2 == 0) for i in range(m))
    ins = D.inputs(m * 41 + len(op), m, k, n_pool=60, multiset=ms_mask)
    planes, values, ids = D.flat(ins, m, k)
    for t in THRESHOLDS:
        want = ref_setops.merge_op_multiset(
            [jnp.asarray(p) for p in planes], jnp.asarray(values),
            jnp.asarray(ids), op, m, jnp.asarray(np.uint32(t)), ms_mask)
        got = setops.merge_op_multiset(*D.port_args(planes, values, ids, k),
                                       op, m, t, ms_mask, k)
        D.assert_same(want, got, k)
