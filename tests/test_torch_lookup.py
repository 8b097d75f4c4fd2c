"""The port's ExactLookup (meryl_tpu_torch/lookup.py) against the
reference's (meryl_tpu/lookup.py) on the CPU: the binary search (point
batches and bulk batches with duplicates, hot keys and a -min filter),
the host-resident table, the point probes and the regime choice, on the
same seeded tables and queries.  Integer results are equal bit for bit
(no tolerance)."""

import numpy as np
import pytest

from meryl_tpu import kmer as km
from meryl_tpu import lookup as ref_lk
from meryl_tpu_torch import lookup as lk
from meryl_tpu_torch.ops import multiword as mw

KS = [16, 21, 32, 33, 64]


class _FakeDB:
    def __init__(self, k, hi, lo, counts, mode="canonical"):
        self.k, self.mode = k, mode
        self._t = (hi, lo, counts)

    def load_all(self):
        return self._t


def _keys(rng, n, k):
    """n random 2k-bit keys -> (hi, lo) uint64 arrays."""
    bits = 2 * k
    lo = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, size=n, dtype=np.uint64)
    if bits < 64:
        lo &= np.uint64((1 << bits) - 1)
    hi = np.zeros(n, np.uint64)
    if bits > 64:
        hi = rng.integers(0, 1 << (bits - 64), size=n, dtype=np.uint64)
    return hi, lo


def table_arrays(rng, n, k, allones=True):
    """Sorted unique keys with counts, the all-ones k-mer included (the
    sentinel's image at k = 16 and 32) and some counts at 2^32 - 1."""
    hi, lo = _keys(rng, n, k)
    if allones:
        ones = (1 << (2 * k)) - 1
        hi = np.append(hi, np.uint64(ones >> 64))
        lo = np.append(lo, np.uint64(ones & ((1 << 64) - 1)))
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    keep = np.ones(len(lo), bool)
    keep[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    hi, lo = hi[keep], lo[keep]
    c = rng.integers(1, 1000, size=len(lo)).astype(np.uint32)
    c[::37] = np.uint32(km.VALUE_MAX)
    c[-1] = 7                      # the all-ones k-mer's value
    return hi, lo, c


def queries(rng, hi, lo, k, n):
    """Half hits, half random, a duplicate run, and the all-ones k-mer
    -> (qhi, qlo, valid)."""
    take = rng.integers(0, len(lo), size=n // 2)
    mhi, mlo = _keys(rng, n - n // 2, k)
    qhi = np.concatenate([hi[take], mhi, np.repeat(hi[3], 50), hi[-1:]])
    qlo = np.concatenate([lo[take], mlo, np.repeat(lo[3], 50), lo[-1:]])
    valid = rng.random(len(qlo)) < 0.9
    valid[-1] = True
    return qhi, qlo, valid


def want_values(hi, lo, c, qhi, qlo, valid):
    d = {(int(h) << 64) | int(x): int(v) for h, x, v in zip(hi, lo, c)}
    return np.array([d.get((int(a) << 64) | int(b), 0) if v else 0
                     for a, b, v in zip(qhi, qlo, valid)], np.uint32)


@pytest.fixture(scope="module", params=KS)
def tables(request):
    k = request.param
    rng = np.random.default_rng(100 + k)
    hi, lo, c = table_arrays(rng, 3000, k)
    qhi, qlo, valid = queries(rng, hi, lo, k, 2000)
    return dict(k=k, hi=hi, lo=lo, c=c, qhi=qhi, qlo=qlo, valid=valid,
                port=lk.ExactLookup(_FakeDB(k, hi, lo, c), device="cpu"),
                ref=ref_lk.ExactLookup(_FakeDB(k, hi, lo, c)))


def test_binary_search_matches_reference(tables):
    t = tables
    P = km.num_planes(t["k"])
    planes = km.planes_from_hilo(t["qhi"], t["qlo"], P)
    want = np.asarray(t["ref"].values_batch(
        [np.asarray(p) for p in planes], t["valid"]))
    key = mw.from_planes(planes, t["k"])
    got = t["port"].values_batch(key, t["valid"])
    assert got.dtype.is_floating_point is False
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(
        want, want_values(t["hi"], t["lo"], t["c"], t["qhi"], t["qlo"],
                          t["valid"]))
    # the all-ones k-mer returns its own value, not a pad's 0
    assert int(got[-1]) == 7
    assert (got == km.VALUE_MAX).any()


def test_bulk_bsearch_and_sort_join_match_reference(tables):
    t = tables
    P = km.num_planes(t["k"])
    planes = km.planes_from_hilo(t["qhi"], t["qlo"], P)
    key = mw.from_planes(planes, t["k"])
    want = t["ref"]._values_bulk_bsearch(planes, t["valid"])
    np.testing.assert_array_equal(
        t["port"]._values_bulk_bsearch(key, t["valid"]), want)
    ex = t["port"].values_bulk(key, t["valid"], exists_only=True)
    np.testing.assert_array_equal(ex, (want > 0).astype(np.uint32))


def test_point_probes_match_reference(tables):
    t = tables
    got = t["port"].values_np(t["qhi"], t["qlo"])
    np.testing.assert_array_equal(got,
                                  t["ref"].values_np(t["qhi"], t["qlo"]))
    for i in (0, 5, len(t["qlo"]) - 1):
        v = (int(t["qhi"][i]) << 64) | int(t["qlo"][i])
        assert t["port"].value(v) == t["ref"].value(v)
        assert t["port"].exists(v) == t["ref"].exists(v)
    assert t["port"].n_kmers() == t["ref"].n_kmers() == len(t["lo"])


@pytest.mark.parametrize("k", [21, 40])
def test_host_resident_table_matches_reference(monkeypatch, k):
    """A table past MERYL_TPU_LOOKUP_DEVICE_GB stays on the host: point
    probes and the binary-search path run the host search."""
    monkeypatch.setenv("MERYL_TPU_LOOKUP_DEVICE_GB", "1e-6")
    rng = np.random.default_rng(k)
    hi, lo, c = table_arrays(rng, 4096, k)
    port = lk.ExactLookup(_FakeDB(k, hi, lo, c), device="cpu")
    ref = ref_lk.ExactLookup(_FakeDB(k, hi, lo, c))
    assert not port._device_resident and not ref._device_resident
    qhi, qlo, valid = queries(rng, hi, lo, k, 600)
    np.testing.assert_array_equal(port.values_host(qhi, qlo),
                                  ref.values_host(qhi, qlo))
    np.testing.assert_array_equal(port.values_np(qhi, qlo),
                                  ref.values_np(qhi, qlo))
    key = mw.from_hilo(qhi, qlo, k)
    np.testing.assert_array_equal(
        port.values_bulk(key, valid),
        want_values(hi, lo, c, qhi, qlo, valid))


@pytest.mark.parametrize("k,lo_v,hi_v", [(21, 5, km.VALUE_MAX), (33, 0, 500),
                                         (16, 2, 900)])
def test_min_max_filter_matches_reference(k, lo_v, hi_v):
    rng = np.random.default_rng(7 + k)
    hi, lo, c = table_arrays(rng, 3000, k)
    port = lk.ExactLookup(_FakeDB(k, hi, lo, c), lo_v, hi_v, device="cpu")
    ref = ref_lk.ExactLookup(_FakeDB(k, hi, lo, c), lo_v, hi_v)
    assert port.n_kmers() == ref.n_kmers() < len(lo)
    qhi, qlo, _ = queries(rng, hi, lo, k, 800)
    np.testing.assert_array_equal(port.values_np(qhi, qlo),
                                  ref.values_np(qhi, qlo))


def test_empty_table_finds_nothing():
    z = np.zeros(0, np.uint64)
    for k in (16, 33):
        t = lk.ExactLookup(_FakeDB(k, z, z, np.zeros(0, np.uint32)),
                           device="cpu")
        ref = ref_lk.ExactLookup(_FakeDB(k, z, z, np.zeros(0, np.uint32)))
        q = np.array([0, 1, 5], np.uint64)
        np.testing.assert_array_equal(t.values_np(np.zeros(3, np.uint64), q),
                                      ref.values_np(np.zeros(3, np.uint64),
                                                    q))
        assert t.n_kmers() == 0


@pytest.mark.parametrize("k", [21, 33])
def test_estimate_memory_is_the_ports_layout(k):
    """8 bytes a key word and 4 a value an entry, plus the offsets."""
    rng = np.random.default_rng(3)
    hi, lo, c = table_arrays(rng, 5000, k)
    t = lk.ExactLookup(_FakeDB(k, hi, lo, c), device="cpu")
    W = 1 if k <= 32 else 2
    assert t.estimate_memory_bytes() == (8 * W + 4) * len(lo) \
        + 4 * ((1 << t.B) + 1)
    got = sum(x.numel() * x.element_size()
              for x in (t._key, t._values, t._offsets))
    assert got == t.estimate_memory_bytes()


def test_top_bits_match_reference_planes():
    """The prefix of the port's words equals the reference's prefix of
    the planes, the sentinel included."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(9)
    for k in (5, 16, 21, 32, 33, 48, 64):
        hi, lo = _keys(rng, 500, k)
        P = km.num_planes(k)
        planes = km.planes_from_hilo(hi, lo, P)
        planes = [np.append(p, np.uint32(0xFFFFFFFF)) for p in planes]
        key = torch.from_numpy(mw.from_planes(planes, k))
        for b in sorted({1, 9, min(22, 2 * k), min(26, 2 * k)}):
            want = np.asarray(ref_lk._top_bits_planes(
                [jnp.asarray(p) for p in planes], k, b)).astype(np.int64)
            np.testing.assert_array_equal(
                lk._top_bits_t(key, k, b).numpy(), want & ((1 << b) - 1))


def test_cuda_device_without_cuda_fails_clearly(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(1)
    hi, lo, c = table_arrays(rng, 100, 21)
    with pytest.raises(RuntimeError, match="is_available"):
        lk.ExactLookup(_FakeDB(21, hi, lo, c))


def test_regime_choice(monkeypatch):
    """A device-resident table answers a bulk batch by binary search at
    any size; a table past the device budget takes the grid join from
    JOIN_MIN_Q valid queries."""
    k = 21
    rng = np.random.default_rng(12)
    hi, lo, c = table_arrays(rng, 1 << 15, k)
    qhi, qlo, valid = queries(rng, hi, lo, k, 1 << 14)
    key = mw.from_hilo(qhi, qlo, k)
    want = want_values(hi, lo, c, qhi, qlo, valid)
    t = lk.ExactLookup(_FakeDB(k, hi, lo, c), device="cpu")
    t.JOIN_MIN_Q = 1 << 10
    lk.reset_stats()
    np.testing.assert_array_equal(t.values_bulk(key, valid), want)
    assert lk.STATS["bsearch_calls"] >= 1 and t._bacj is None
    monkeypatch.setenv("MERYL_TPU_LOOKUP_DEVICE_GB", "1e-6")
    t = lk.ExactLookup(_FakeDB(k, hi, lo, c), device="cpu")
    t.JOIN_MIN_Q, t.BACJ_SLAB = 1 << 10, 1 << 13
    lk.reset_stats()
    np.testing.assert_array_equal(t.values_bulk(key, valid), want)
    assert isinstance(t._bacj, dict)
    assert lk.STATS["bacj_slabs"] + lk.STATS["bacj_rejected_slabs"] >= 1


# ---- bulk batches on a device-resident table: the binary search

def _bulk_pair(k, hi, lo, c, qhi, qlo, valid, min_value=0):
    """values_bulk of both packages (the port's a binary search, also
    in exists mode) -> the port's values."""
    port = lk.ExactLookup(_FakeDB(k, hi, lo, c), min_value, device="cpu")
    ref = ref_lk.ExactLookup(_FakeDB(k, hi, lo, c), min_value)
    planes = km.planes_from_hilo(qhi, qlo, km.num_planes(k))
    key = mw.from_planes(planes, k)
    lk.reset_stats()
    got = port.values_bulk(key, valid)
    assert lk.STATS["bsearch_calls"] >= 1 and port._bacj is None
    np.testing.assert_array_equal(got, ref.values_bulk(planes, valid))
    np.testing.assert_array_equal(port.values_bulk(key, valid, True),
                                  (got > 0).astype(np.uint32))
    return got


@pytest.mark.parametrize("k", [16, 21, 33])
def test_bulk_bsearch_duplicates_match_reference(k):
    """Hits, misses, runs of duplicate hits and misses, the all-ones
    k-mer 300 times, 10 % invalid."""
    rng = np.random.default_rng(40 + k)
    hi, lo, c = table_arrays(rng, 20000, k)
    take = rng.integers(0, len(lo), size=3000)
    mhi, mlo = _keys(rng, 3000, k)
    dup = rng.integers(0, len(lo), size=5)
    qhi = np.concatenate([hi[take], mhi, np.repeat(hi[dup], 200),
                          np.repeat(mhi[:5], 150), hi[-1:].repeat(300)])
    qlo = np.concatenate([lo[take], mlo, np.repeat(lo[dup], 200),
                          np.repeat(mlo[:5], 150), lo[-1:].repeat(300)])
    order = rng.permutation(len(qlo))
    qhi, qlo = qhi[order], qlo[order]
    valid = rng.random(len(qlo)) < 0.9
    got = _bulk_pair(k, hi, lo, c, qhi, qlo, valid)
    np.testing.assert_array_equal(
        got, want_values(hi, lo, c, qhi, qlo, valid))


@pytest.mark.parametrize("k", [16, 21, 33])
def test_bulk_bsearch_hot_keys_match_reference(k):
    """Thousands of copies of one hit and one miss among random hits."""
    rng = np.random.default_rng(40 + k)
    hi, lo, c = table_arrays(rng, 20000, k)
    mhi, mlo = _keys(rng, 1, k)
    some = rng.integers(0, len(lo), 1000)
    qhi = np.concatenate([np.repeat(hi[7], 2000), np.repeat(mhi, 2000),
                          hi[some]])
    qlo = np.concatenate([np.repeat(lo[7], 2000), np.repeat(mlo, 2000),
                          lo[some]])
    valid = np.ones(len(qlo), bool)
    got = _bulk_pair(k, hi, lo, c, qhi, qlo, valid)
    np.testing.assert_array_equal(
        got, want_values(hi, lo, c, qhi, qlo, valid))


def test_bulk_bsearch_min_filter_matches_reference():
    k = 21
    rng = np.random.default_rng(5)
    hi, lo, c = table_arrays(rng, 20000, k)
    c = (c % 10).astype(np.uint32) + 1
    take = rng.integers(0, len(lo), size=4000)
    got = _bulk_pair(k, hi, lo, c, hi[take], lo[take],
                     np.ones(len(take), bool), min_value=5)
    np.testing.assert_array_equal(got, np.where(c[take] >= 5, c[take], 0))
