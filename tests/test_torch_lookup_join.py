"""The routed-join bulk lookup (meryl_tpu_torch/lookup.py
_route_join_kernel / _values_bulk_join) against the reference's
(meryl_tpu/lookup.py), both forced into the regime through the same
class attributes: duplicate queries (forward fill), cell overflow (the
binary-search fallback), invalid masks, exists mode, the -min filter
and the all-ones key.  Equal bit for bit."""

import numpy as np
import pytest

from meryl_tpu import kmer as km
from meryl_tpu import lookup as ref_lk
from meryl_tpu_torch import lookup as lk
from meryl_tpu_torch.ops import multiword as mw

from test_torch_lookup import _FakeDB, table_arrays, want_values

SMALL_JOIN = dict(JOIN_SLAB=1 << 14, JOIN_R0=4, JOIN_MIN_Q=1 << 8,
                  JOIN_MIN_N=1 << 8, _LDB_TARGET=1 << 11, BACJ_MIN_N=1 << 40)


def _pair(k, hi, lo, c, min_value=0):
    tabs = []
    for mod, kw in ((lk, dict(device="cpu")), (ref_lk, {})):
        t = mod.ExactLookup(_FakeDB(k, hi, lo, c), min_value, **kw)
        for a, v in SMALL_JOIN.items():
            setattr(t, a, v)
        tabs.append(t)
    return tabs


@pytest.fixture(scope="module", params=[16, 21, 33])
def joined(request):
    k = request.param
    rng = np.random.default_rng(40 + k)
    hi, lo, c = table_arrays(rng, 20000, k)
    port, ref = _pair(k, hi, lo, c)
    return dict(k=k, hi=hi, lo=lo, c=c, rng=rng, port=port, ref=ref)


def _run(t, qhi, qlo, valid, exists_only=False):
    P = km.num_planes(t["k"])
    planes = km.planes_from_hilo(qhi, qlo, P)
    got = t["port"].values_bulk(mw.from_planes(planes, t["k"]), valid,
                                exists_only)
    want = t["ref"].values_bulk(planes, valid, exists_only)
    assert isinstance(t["port"]._grouped, dict), "routed join did not run"
    assert t["port"]._grouped["cfg"] == t["ref"]._grouped["cfg"]
    return got, want


def test_join_matches_reference(joined):
    t = joined
    rng = t["rng"]
    take = rng.integers(0, len(t["lo"]), size=3000)
    from test_torch_lookup import _keys
    mhi, mlo = _keys(rng, 3000, t["k"])
    dup = rng.integers(0, len(t["lo"]), size=5)
    qhi = np.concatenate([t["hi"][take], mhi, np.repeat(t["hi"][dup], 200),
                          np.repeat(mhi[:5], 150), t["hi"][-1:].repeat(300)])
    qlo = np.concatenate([t["lo"][take], mlo, np.repeat(t["lo"][dup], 200),
                          np.repeat(mlo[:5], 150), t["lo"][-1:].repeat(300)])
    order = rng.permutation(len(qlo))
    qhi, qlo = qhi[order], qlo[order]
    valid = rng.random(len(qlo)) < 0.9
    lk.reset_stats()
    got, want = _run(t, qhi, qlo, valid)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, want_values(t["hi"], t["lo"], t["c"], qhi, qlo, valid))
    assert lk.STATS["join_slabs"] >= 1
    # exists mode on the same queries
    ex, ex_ref = _run(t, qhi, qlo, valid, exists_only=True)
    np.testing.assert_array_equal(ex, ex_ref)
    np.testing.assert_array_equal(ex, (want > 0).astype(np.uint32))


def test_join_overflow_fallback_matches_reference(joined):
    """Thousands of copies of a few keys overflow their cells; the
    fallback answers every query exactly."""
    t = joined
    rng = t["rng"]
    from test_torch_lookup import _keys
    mhi, mlo = _keys(rng, 1, t["k"])
    qhi = np.concatenate([np.repeat(t["hi"][7], 2000), np.repeat(mhi, 2000),
                          t["hi"][rng.integers(0, len(t["lo"]), 1000)]])
    qlo = np.concatenate([np.repeat(t["lo"][7], 2000), np.repeat(mlo, 2000),
                          t["lo"][rng.integers(0, len(t["lo"]), 1000)]])
    valid = np.ones(len(qlo), bool)
    lk.reset_stats()
    got, want = _run(t, qhi, qlo, valid)
    np.testing.assert_array_equal(got, want)
    assert lk.STATS["join_overflow"] > 0


def test_join_min_filter_matches_reference():
    k = 21
    rng = np.random.default_rng(5)
    hi, lo, c = table_arrays(rng, 20000, k)
    c = (c % 10).astype(np.uint32) + 1
    port, ref = _pair(k, hi, lo, c, min_value=5)
    take = rng.integers(0, len(lo), size=4000)
    planes = km.planes_from_hilo(hi[take], lo[take], km.num_planes(k))
    valid = np.ones(len(take), bool)
    got = port.values_bulk(mw.from_planes(planes, k), valid)
    np.testing.assert_array_equal(got, ref.values_bulk(planes, valid))
    assert isinstance(port._grouped, dict)
    np.testing.assert_array_equal(got, np.where(c[take] >= 5, c[take], 0))


def test_join_slab_assert():
    """The query id packs into 22 bits: a JOIN_SLAB past 2^21 is
    refused when the layout is built."""
    rng = np.random.default_rng(6)
    hi, lo, c = table_arrays(rng, 5000, 21)
    t = lk.ExactLookup(_FakeDB(21, hi, lo, c), device="cpu")
    t.JOIN_SLAB = 1 << 22
    with pytest.raises(AssertionError):
        t._build_grouped()
