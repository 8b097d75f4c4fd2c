"""The grid compare-join (meryl_tpu_torch/ops/bacjoin.py and the
ExactLookup regime that drives it) against the reference's
(meryl_tpu/ops/bacjoin.py, meryl_tpu/lookup.py) on the CPU: the
planners, the grid builder and the router give equal arrays; the kernel
resolves every query to the reference's value with the same per-row
overflow counts; values_bulk forced into the regime (one grid or
segmented, with each of its three exact hatches) equals the reference
bit for bit."""

import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meryl_tpu import kmer as km
from meryl_tpu import lookup as ref_lk
from meryl_tpu.ops import bacjoin as ref_bj
from meryl_tpu_torch import lookup as lk
from meryl_tpu_torch.ops import bacjoin as bj
from meryl_tpu_torch.ops import multiword as mw

from test_torch_lookup import _FakeDB, _keys, table_arrays, want_values

SENT = 0xFFFFFFFF


def _bucket_max(hi, lo, k, bm):
    cM = np.bincount(ref_bj._top_bits_np(hi, lo, k, bm), minlength=1 << bm)
    return lambda b: int(cM.reshape(1 << b, -1).sum(axis=1).max())


@pytest.mark.parametrize("k,n,q_slab,cap", [(21, 1 << 15, 1 << 13, 1e9),
                                            (21, 1 << 15, 1 << 13, 2e5),
                                            (33, 1 << 14, 1 << 14, 1e9),
                                            (64, 1 << 14, 1 << 12, 5e5)])
def test_planners_match_reference(k, n, q_slab, cap):
    rng = np.random.default_rng(k + n)
    hi, lo, _ = table_arrays(rng, n, k, allones=False)
    bm = min(26, 2 * k - 1, len(lo).bit_length() + 3)
    bmax = _bucket_max(hi, lo, k, bm)
    for fn in ("plan_bacjoin", "plan_bacjoin_segmented"):
        assert getattr(bj, fn)(len(lo), k, bmax, q_slab, cap, b_hi=bm) == \
            getattr(ref_bj, fn)(len(lo), k, bmax, q_slab, cap, b_hi=bm)
    for lam in (0.1, 3.0, 40.0, 700.0):
        assert bj._cap_for_overflow(lam, 0.01) == \
            ref_bj._cap_for_overflow(lam, 0.01)


def _cfg(k, b, b1, c, s_cap, capA, ovfcap=16):
    return {"b": b, "B": 1 << b, "b1": b1, "c": c, "s_cap": s_cap,
            "capA": capA, "ps": max(1, -(-(2 * k - b) // 32)),
            "ovfcap": ovfcap}


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("k,b,b1", [(9, 10, 4), (21, 12, 5), (33, 10, 4),
                                    (48, 9, 4), (64, 12, 5)])
def test_grid_and_router_match_reference(monkeypatch, native, k, b, b1):
    monkeypatch.setenv("MERYL_TPU_NATIVE_ROUTE", native)
    rng = np.random.default_rng(b + k)
    hi, lo, c = table_arrays(rng, 3000, k, allones=False)
    top = ref_bj._top_bits_np(hi, lo, k, b)
    cfg = _cfg(k, b, b1, 8, int(np.bincount(top).max()), capA=4096)
    for a, w in zip(bj.build_db_grid(hi, lo, c, k, cfg),
                    ref_bj.build_db_grid(hi, lo, c, k, cfg)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w))
    qhi, qlo = _keys(rng, 2048, k)
    got = bj.route_queries_host(qhi, qlo, k, cfg)
    want = ref_bj.route_queries_host(qhi, qlo, k, cfg)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w))
    small = dict(cfg, capA=8)                 # a coarse row overflows
    assert bj.route_queries_host(qhi, qlo, k, small) is None
    with pytest.raises(ValueError):
        bj.route_queries_host(qhi, qlo, k, cfg, row_base=1, n_rows=2)


def _decode(vals, pos, perm, capA, Q):
    """-> (value per query, whether the kernel resolved it)."""
    out = np.zeros(Q, np.int64)
    ok = np.zeros(Q, bool)
    rows, cols = np.nonzero(pos != SENT)
    at = perm[rows * capA + pos[rows, cols].astype(np.int64)]
    out[at] = vals[rows, cols]
    ok[at] = True
    return out, ok


@pytest.mark.parametrize("k,b,b1,c", [(9, 10, 4, 8), (21, 12, 5, 8),
                                      (33, 10, 4, 8), (48, 9, 4, 8),
                                      (21, 8, 4, 3)])
def test_kernel_matches_reference(k, b, b1, c):
    """Every query the kernel resolves gets the reference's value; the
    captured overflow (which queries, when a bucket holds more than c,
    depends on sort order) is recoverable by position and has the
    reference's count on every row."""
    rng = np.random.default_rng(3 + k + c)
    hi, lo, cnt = table_arrays(rng, 3000, k, allones=False)
    d = {(int(h) << 64) | int(x): int(v) for h, x, v in zip(hi, lo, cnt)}
    Q = 2048
    take = rng.integers(0, len(lo), size=Q // 2)
    mhi, mlo = _keys(rng, Q // 2, k)
    qhi = np.concatenate([hi[take], mhi])
    qlo = np.concatenate([lo[take], mlo])
    qlo[:100], qhi[:100] = lo[42], hi[42]          # a duplicate flood
    top = ref_bj._top_bits_np(hi, lo, k, b)
    cfg = _cfg(k, b, b1, c, int(np.bincount(top).max()), capA=Q, ovfcap=Q)
    kcfg = (k, b, b1, c, cfg["capA"], cfg["s_cap"], cfg["ovfcap"])
    dbd, dbv = ref_bj.build_db_grid(hi, lo, cnt, k, cfg)
    qlow, n_row, perm = ref_bj.route_queries_host(qhi, qlo, k, cfg)
    want = [np.asarray(x) for x in ref_bj.bacjoin_kernel(
        tuple(jnp.asarray(x) for x in dbd), jnp.asarray(dbv),
        tuple(jnp.asarray(x) for x in qlow), jnp.asarray(n_row), kcfg)]
    got = [bj.download_u32(x) for x in bj.bacjoin_kernel(
        tuple(bj.to_device_u32(x, "cpu") for x in dbd),
        bj.to_device_u32(dbv, "cpu"),
        tuple(bj.to_device_u32(x, "cpu") for x in qlow),
        torch.from_numpy(n_row), kcfg)]
    truth = np.array([d.get((int(h) << 64) | int(x), 0)
                      for h, x in zip(qhi, qlo)], np.int64)
    for (vals, pos, ovf_pos, n_ovf) in (got, want):
        res, ok = _decode(vals, pos, perm, cfg["capA"], Q)
        np.testing.assert_array_equal(res[ok], truth[ok])
        rows, cols = np.nonzero(ovf_pos != SENT)
        lost = perm[rows * cfg["capA"] + ovf_pos[rows, cols].astype(np.int64)]
        assert sorted(lost.tolist()) == np.flatnonzero(~ok).tolist()
    np.testing.assert_array_equal(got[3].astype(np.int64),
                                  want[3].astype(np.int64))
    # exists mode: the found bit 31 on the same packed slots
    pk = bj.download_u32(bj.bacjoin_kernel(
        tuple(bj.to_device_u32(x, "cpu") for x in dbd),
        bj.to_device_u32(dbv, "cpu"),
        tuple(bj.to_device_u32(x, "cpu") for x in qlow),
        torch.from_numpy(n_row), kcfg, exists_only=True)[0])
    vals, pos = got[0], got[1]
    np.testing.assert_array_equal(pk == SENT, pos == SENT)
    m = pos != SENT
    np.testing.assert_array_equal(pk[m] & 0x7FFFFFFF, pos[m])
    np.testing.assert_array_equal(pk[m] >> 31, (vals[m] > 0).astype(np.uint32))


# ---- the regime through ExactLookup.values_bulk, both packages

def _pair(k, hi, lo, c, slab):
    """The port's table past its device budget (so its bulk batches take
    the grid join) and the reference's forced into the grid join by its
    own table-size threshold."""
    with mock.patch.dict(os.environ, MERYL_TPU_LOOKUP_DEVICE_GB="1e-6"):
        port = lk.ExactLookup(_FakeDB(k, hi, lo, c), device="cpu")
    assert not port._device_resident
    ref = ref_lk.ExactLookup(_FakeDB(k, hi, lo, c))
    ref.BACJ_MIN_N = 1 << 10
    for t in (port, ref):
        t.BACJ_SLAB = slab
        t.JOIN_MIN_Q = 1 << 10
    return port, ref


def _bulk(tabs, k, qhi, qlo, valid=None, exists_only=False):
    valid = np.ones(len(qlo), bool) if valid is None else valid
    planes = km.planes_from_hilo(qhi, qlo, km.num_planes(k))
    got = tabs[0].values_bulk(mw.from_planes(planes, k), valid, exists_only)
    want = tabs[1].values_bulk(planes, valid, exists_only)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.fixture(scope="module", params=[21, 33, 64])
def grid(request):
    k = request.param
    rng = np.random.default_rng(11 + k)
    hi, lo, c = table_arrays(rng, 1 << 15, k)
    tabs = _pair(k, hi, lo, c, 1 << 13)
    return dict(k=k, hi=hi, lo=lo, c=c, rng=rng, tabs=tabs)


def test_grid_join_matches_reference(grid):
    g = grid
    k, rng = g["k"], g["rng"]
    Q = (1 << 14) + 777                  # two slabs and a ragged tail
    take = rng.integers(0, len(g["lo"]), size=Q // 2)
    mhi, mlo = _keys(rng, Q - Q // 2, k)
    qhi = np.concatenate([g["hi"][take], mhi, np.full(30, g["hi"][123])])
    qlo = np.concatenate([g["lo"][take], mlo, np.full(30, g["lo"][123])])
    valid = rng.random(len(qlo)) < 0.95
    lk.reset_stats()
    got = _bulk(g["tabs"], k, qhi, qlo, valid)
    assert isinstance(g["tabs"][0]._bacj, dict), "grid join did not engage"
    assert g["tabs"][0]._bacj["cfg"] == g["tabs"][1]._bacj["cfg"]
    assert lk.STATS["bacj_slabs"] + lk.STATS["bacj_rejected_slabs"] >= 2
    np.testing.assert_array_equal(
        got, want_values(g["hi"], g["lo"], g["c"], qhi, qlo, valid))
    ex = _bulk(g["tabs"], k, qhi, qlo, valid, exists_only=True)
    np.testing.assert_array_equal(ex, (got > 0).astype(np.uint32))


@pytest.mark.parametrize("k", [21, 33])
def test_grid_join_row_and_slab_hatches(k):
    """A capture window past ovfcap falls back for its whole row; a slab
    whose coarse row overflows capA falls back whole."""
    rng = np.random.default_rng(13 + k)
    hi, lo, c = table_arrays(rng, 1 << 17, k)
    port, ref = tabs = _pair(k, hi, lo, c, 1 << 14)
    for t in tabs:
        t._bacj = t._build_bacj()
        cfg = dict(t._bacj["cfg"], ovfcap=8)
        t._bacj = dict(t._bacj, cfg=cfg, kcfg=(
            k, cfg["b"], cfg["b1"], cfg["c"], cfg["capA"], cfg["s_cap"], 8))
    qhi, qlo = _keys(rng, 1 << 12, k)
    qhi[:40], qlo[:40] = hi[7], lo[7]          # 40 dups, c << 40 > ovfcap
    lk.reset_stats()
    _bulk(tabs, k, qhi, qlo)
    assert lk.STATS["bacj_lost_rows"] >= 1
    qhi = np.full(1 << 12, hi[5], np.uint64)   # one coarse row > capA
    qlo = np.full(1 << 12, lo[5], np.uint64)
    lk.reset_stats()
    got = _bulk(tabs, k, qhi, qlo)
    assert lk.STATS["bacj_rejected_slabs"] >= 1
    assert (got == c[5]).all()


@pytest.mark.parametrize("native", ["1", "0"])
def test_segmented_grid_matches_reference(monkeypatch, native):
    """A table past the device budget with a grid past its cap: the grid
    splits into key-range segments streamed one at a time."""
    monkeypatch.setenv("MERYL_TPU_NATIVE_ROUTE", native)
    monkeypatch.setenv("MERYL_TPU_LOOKUP_DEVICE_GB", "1e-6")
    monkeypatch.setenv("MERYL_TPU_BACJ_CAP_GB", "2e-4")
    k = 21
    rng = np.random.default_rng(1)
    hi, lo, c = table_arrays(rng, 1 << 15, k)
    tabs = _pair(k, hi, lo, c, 1 << 13)
    assert not tabs[0]._device_resident
    Q = (1 << 14) + 333
    take = rng.integers(0, len(lo), size=Q // 2)
    mhi, mlo = _keys(rng, Q - Q // 2, k)
    qhi = np.concatenate([hi[take], mhi])
    qlo = np.concatenate([lo[take], mlo])
    qhi[::17], qlo[::17] = qhi[0], qlo[0]             # duplicate sprinkles
    lk.reset_stats()
    got = _bulk(tabs, k, qhi, qlo)
    assert tabs[0]._bacj["segments"] >= 2
    assert lk.STATS["bacj_segments"] >= 2
    np.testing.assert_array_equal(
        got, want_values(hi, lo, c, qhi, qlo, np.ones(len(qlo), bool)))
    _bulk(tabs, k, qhi, qlo, exists_only=True)
