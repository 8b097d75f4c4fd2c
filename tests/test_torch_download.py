"""The accumulator downloads of meryl_tpu_torch against meryl_tpu's:
the gap-packed format (ops/accum.pack_for_download, its fused blob and
DeviceAccCounter._download_packed with the numpy decode) and the dense
one (32-bit counts, one buffer).  The same seeded numpy codes feed both
packages' DeviceAccCounter; the device-side pack is compared bit for
bit on the same accumulator, the decoded arrays exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meryl_tpu import counter as ref_ctr
from meryl_tpu import kmer as km
from meryl_tpu.ops import accum as ref_accum
from meryl_tpu_torch import counter as ctr
from meryl_tpu_torch.ops import accum
from meryl_tpu_torch.ops import multiword as mw


def _counters(k=21, chunk=1 << 12, exp=1 << 12, mode="forward"):
    return (ctr.DeviceAccCounter(k, mode, chunk, exp, device="cpu"),
            ref_ctr.DeviceAccCounter(k, mode, chunk, exp))


def _feed(c, codes):
    """Chunk-wise feed without halo: the brute model counts per chunk
    too."""
    for s in range(0, len(codes), c.chunk_len):
        c.add_codes(codes[s:s + c.chunk_len])


def _brute(codes, k, chunk_len):
    counts = {}
    mask = (1 << (2 * k)) - 1
    for s in range(0, len(codes), chunk_len):
        run, v = 0, 0
        for x in codes[s:s + chunk_len]:
            if x > 3:
                run, v = 0, 0
                continue
            v = ((v << 2) | int(x)) & mask
            run += 1
            if run >= k:
                counts[v] = counts.get(v, 0) + 1
    return counts


def _as_dict(hi, lo, c):
    return {(int(h) << 64) | int(v): int(n)
            for h, v, n in zip(hi.tolist(), lo.tolist(), c.tolist())}


def _spy_packed(monkeypatch):
    """Record whether the port's packed download engaged (True), bowed
    out (False) or never ran."""
    engaged = []
    orig = ctr.DeviceAccCounter._download_packed

    def spy(self, lmax):
        out = orig(self, lmax)
        engaged.append(out is not None)
        return out

    monkeypatch.setattr(ctr.DeviceAccCounter, "_download_packed", spy)
    return engaged


def _check_both(codes, k, monkeypatch, want_engaged, **kw):
    """Feed both packages, finalize, compare with each other and the
    brute force -> the port's counter."""
    c, r = _counters(k=k, **kw)
    _feed(c, codes)
    _feed(r, codes)
    engaged = _spy_packed(monkeypatch)
    got = c.finalize()
    ref = r.finalize()
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert _as_dict(*got) == _brute(codes, k, c.chunk_len)
    assert engaged == want_engaged
    return c, r


@pytest.fixture(autouse=True)
def packed_on(monkeypatch):
    """These tests run the packed path whatever the default is."""
    monkeypatch.setenv("MERYL_TPU_PACK_D2H", "1")


@pytest.fixture
def exc_row_cap(monkeypatch):
    """Set EXC_ROW_CAP in both packages.  The reference's pack is
    jitted and reads the constant while tracing, so its compiled
    programs are dropped before and after."""
    def set_cap(n):
        jax.clear_caches()
        monkeypatch.setattr(accum, "EXC_ROW_CAP", n)
        monkeypatch.setattr(ref_accum, "EXC_ROW_CAP", n)
    yield set_cap
    jax.clear_caches()


def test_packed_path_engages_and_matches(monkeypatch):
    """Dense keyspace occupancy (k=10: ~16K uniques over 2^20 keys, the
    gaps fit the field): the packed download runs, not the fallback,
    and ships fewer bytes than the dense one would."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=1 << 14).astype(np.uint8)
    c, r = _check_both(codes, 10, monkeypatch, [True])
    got_c = _brute(codes, 10, c.chunk_len)
    assert c.wire_d2h_bytes == r.wire_d2h_bytes - 4  # no unique-count word
    assert c.wire_d2h_bytes < len(got_c) * 12


def test_hot_count_exceptions(monkeypatch):
    """A few k-mers repeated far past the count field ride the
    exception arrays and decode exactly."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, 4, size=1 << 13).astype(np.uint8)
    hot = np.tile(base[:21], 400)
    codes = np.concatenate([base, hot, base[::-1]])
    ref_engaged = []
    orig = ref_ctr.DeviceAccCounter._download_packed
    monkeypatch.setattr(
        ref_ctr.DeviceAccCounter, "_download_packed",
        lambda self, lmax: (ref_engaged.append(orig(self, lmax))
                            or ref_engaged[-1]))
    c, r = _counters()
    _feed(c, codes)
    _feed(r, codes)
    engaged = _spy_packed(monkeypatch)
    got, ref = c.finalize(), r.finalize()
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert _as_dict(*got) == _brute(codes, 21, c.chunk_len)
    # both packages decide alike whether the packed path holds
    assert engaged == [x is not None for x in ref_engaged]


@pytest.mark.parametrize("k", [10, 21])
def test_knob_off_matches(monkeypatch, k):
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, size=1 << 14).astype(np.uint8)
    c1, _ = _counters(k=k)
    _feed(c1, codes)
    r1 = c1.finalize()
    monkeypatch.setenv("MERYL_TPU_PACK_D2H", "0")
    engaged = _spy_packed(monkeypatch)
    c2, _ = _counters(k=k)
    _feed(c2, codes)
    r2 = c2.finalize()
    assert engaged == []
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(a, b)
    # dense: 8 B a key word and 4 B a count of each unique, one fetch
    assert c2.wire_d2h_bytes == len(r2[2]) * 12


@pytest.mark.parametrize("default", [True, False])
def test_unset_knob_takes_the_default(monkeypatch, default):
    monkeypatch.delenv("MERYL_TPU_PACK_D2H")
    monkeypatch.setattr(ctr, "PACK_D2H_DEFAULT", default)
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, size=1 << 13).astype(np.uint8)
    engaged = _spy_packed(monkeypatch)
    c, _ = _counters(k=10)
    _feed(c, codes)
    assert _as_dict(*c.finalize()) == _brute(codes, 10, c.chunk_len)
    assert engaged == ([True] if default else [])


def test_exc_cap_overflow_falls_back_dense(monkeypatch, exc_row_cap):
    """More exceptions in a row than EXC_ROW_CAP, in more rows than the
    dense-row hatch takes: the packed path returns None (dense
    download), never a wrong decode."""
    exc_row_cap(1)
    rng = np.random.default_rng(3)
    parts = []
    for i in range(40):
        kmer = rng.integers(0, 4, size=21).astype(np.uint8)
        parts.append(np.tile(kmer, 300))
        parts.append(np.array([9], np.uint8))  # breaker
    codes = np.concatenate(parts)
    _check_both(codes, 21, monkeypatch, [False])


def test_k32_boundary_uses_packed(monkeypatch):
    """2k = 64 is the widest packable key (one 64-bit host cumsum);
    random 32-mers are gap-sparse, so both packages bow out alike."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, size=1 << 14).astype(np.uint8)
    c, r = _counters(k=32)
    _feed(c, codes)
    _feed(r, codes)
    engaged = _spy_packed(monkeypatch)
    got, ref = c.finalize(), r.finalize()
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert _as_dict(*got) == _brute(codes, 32, c.chunk_len)
    assert len(engaged) == 1


def test_k33_gated_to_dense(monkeypatch):
    """k > 32 cannot pack (128-bit host cumsum): the dense download."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=1 << 13).astype(np.uint8)
    c, _ = _check_both(codes, 33, monkeypatch, [])
    assert c.wire_d2h_bytes == len(_brute(codes, 33, c.chunk_len)) * 20


@pytest.mark.parametrize("k", [16, 32])
def test_allones_kmer_with_packed_download(monkeypatch, k):
    """The all-ones k-mer (poly-G) is counted by the scalar, outside the
    accumulator, whichever download runs."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=1 << 13).astype(np.uint8)
    codes[500:500 + 3 * k] = 3
    codes[499] = codes[500 + 3 * k] = 9
    c, _ = _counters(k=k)
    _feed(c, codes)
    got = _as_dict(*c.finalize())
    assert got == _brute(codes, k, c.chunk_len)
    assert got[(1 << (2 * k)) - 1] == 2 * k + 1


# ---------------------------------------- the device-side pack, direct

def _acc_rows(k, B=8, La=256, seed=6, count_exc_rows=range(8)):
    """Random sorted accumulator rows in the reference's format (P
    planes), with an empty row, a dense and a sparse row, gap
    exceptions, and in `count_exc_rows` two count exceptions (counts
    past 2^31) -> (planes, counts, want list)."""
    rng = np.random.default_rng(seed)
    P = km.num_planes(k)
    span = (1 << (2 * k)) // B
    planes = [np.full((B, La), 0xFFFFFFFF, np.uint32) for _ in range(P)]
    counts = np.zeros((B, La), np.uint32)
    want = []
    big = min(25, 2 * k - 4)
    for r in range(B):
        if r == 3:
            continue  # empty row
        n = int(rng.integers(5, La))
        hi_g = 1 << min(10 if r == 5 else 18, 2 * k - 12)
        gaps = rng.integers(1, hi_g, size=n).astype(np.uint64)
        if r != 5:  # row 5 stays narrow: its field must track density
            gaps[n // 2] = np.uint64(1) << np.uint64(big)   # gap exception
        if r == 6 and P == 2:
            gaps[n // 3] = np.uint64(1) << np.uint64(35)    # past 32 bits
        keys = np.cumsum(gaps) + np.uint64(r * span)
        cts = rng.integers(1, 1 << 9, size=n).astype(np.uint32)
        if r in count_exc_rows:
            cts[1] = np.uint32((1 << 31) + 7)   # count exception
            cts[2] = np.uint32(0xFFFFFFFF)      # saturated count
        planes[0][r, :n] = keys & np.uint64(0xFFFFFFFF)
        if P == 2:
            planes[1][r, :n] = keys >> np.uint64(32)
        counts[r, :n] = cts
        want += [(int(a), int(b)) for a, b in zip(keys, cts)]
    return planes, counts, want


def _port_acc(planes, counts, k):
    shape = counts.shape
    key = mw.from_planes([p.reshape(-1) for p in planes], k).reshape(shape)
    return torch.from_numpy(key), torch.from_numpy(counts.astype(np.int64))


@pytest.mark.parametrize("k,cbits_min", [(21, 10), (16, 10), (32, 6),
                                         (12, 8), (21, 24)])
def test_pack_for_download_matches_reference(k, cbits_min):
    """Bit for bit: packed words, per-row gap widths, exception columns,
    keys, counts and per-row exception counts."""
    planes, counts, _ = _acc_rows(k)
    P = km.num_planes(k)
    ref = ref_accum.pack_for_download(
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(counts), P,
        cbits_min)
    key, cnt = _port_acc(planes, counts, k)
    got = accum.pack_for_download(key, cnt, k, cbits_min)
    packed, gbits, exc_col, exc_planes, exc_cnt, n_exc = got
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(gbits.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(exc_col.numpy(), np.asarray(ref[2]))
    assert len(exc_planes) == P
    for a, b in zip(exc_planes, ref[3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(exc_cnt.numpy(), np.asarray(ref[4]))
    np.testing.assert_array_equal(n_exc.numpy(), np.asarray(ref[5]))
    assert int(n_exc.max()) >= 2 and (gbits <= 32 - cbits_min).all()
    if cbits_min == 10:
        assert gbits[5] < gbits[6]  # the field tracks the row's density


@pytest.mark.parametrize("k,bases", [(21, 40_000), (16, 3_000_000),
                                     (32, 1), (12, 10 ** 9)])
def test_pack_fused_blob_matches_reference(k, bases):
    """The one-blob form, with the count field's floor derived on the
    device from bases / uniques: equal 32-bit patterns."""
    planes, counts, _ = _acc_rows(k, seed=11)
    P = km.num_planes(k)
    lmax = 192
    ref = np.asarray(ref_accum.pack_for_download_fused(
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(counts), P,
        jnp.float32(bases), lmax))
    key, cnt = _port_acc(planes, counts, k)
    got = accum.pack_for_download_fused(key, cnt, k, bases, lmax)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


def test_pack_needs_one_word():
    planes, counts, _ = _acc_rows(21)
    key, cnt = _port_acc(planes, counts, 21)
    with pytest.raises(ValueError, match="2k <= 64"):
        accum.pack_for_download(torch.stack([key, key], -1), cnt, 33, 10)


@pytest.mark.parametrize("k", [12, 21, 32])
@pytest.mark.parametrize("packed", [True, False])
def test_download_roundtrip_direct(monkeypatch, k, packed):
    """An accumulator planted in a counter decodes to what was planted,
    through the packed and the dense download (exceptions by gap and by
    count, a saturated count, an empty row)."""
    planes, counts, want = _acc_rows(k, B=8)
    c = ctr.DeviceAccCounter(k, "forward", 1 << 12, 1, device="cpu")
    assert c.B == 8
    c._acc = _port_acc(planes, counts, k)
    c.La = counts.shape[1]
    c._max_run = int((counts > 0).sum(axis=1).max())
    c._bases_seen = 40_000
    monkeypatch.setenv("MERYL_TPU_PACK_D2H", "1" if packed else "0")
    engaged = _spy_packed(monkeypatch)
    hi, lo, cts = c.download()
    assert engaged == ([True] if packed else [])
    assert cts.dtype == np.uint64 and not hi.any()
    assert list(zip(lo.tolist(), cts.tolist())) == want


@pytest.mark.parametrize("k", [21, 32])
def test_dense_row_hybrid(monkeypatch, exc_row_cap, k):
    """Rows with more exceptions than EXC_ROW_CAP download dense while
    the rest stay packed; with more such rows than the hatch takes, the
    whole download is dense.  Both packages decide and decode alike."""
    exc_row_cap(2)
    for rows, want_engaged in (((0, 1), True), (range(8), False)):
        planes, counts, want = _acc_rows(k, count_exc_rows=rows)
        c, r = _counters(k=k, exp=1)
        c._acc = _port_acc(planes, counts, k)
        r._acc = (tuple(jnp.asarray(p) for p in planes), jnp.asarray(counts))
        for x in (c, r):
            x.La = counts.shape[1]
            x._max_run = int((counts > 0).sum(axis=1).max())
            x._bases_seen = 400_000   # a 10-bit count field at least
        fetched = []
        real = torch.index_select
        monkeypatch.setattr(torch, "index_select", lambda *a: (
            fetched.append(a[2].tolist()) or real(*a)))
        lmax = c.download_lmax()
        got = c._download_packed(lmax)
        ref = r._download_packed(lmax)
        monkeypatch.setattr(torch, "index_select", real)
        assert (got is not None) == (ref is not None) == want_engaged
        if want_engaged:
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)
            assert fetched == [[0, 1], [0, 1]]   # keys, then counts
            assert c.wire_d2h_bytes == r.wire_d2h_bytes - 4
        else:
            assert not fetched and c.wire_d2h_bytes == 0
        hi, lo, cts = c.download()
        assert list(zip(lo.tolist(), cts.tolist())) == want
