"""meryl_tpu_torch's count functions against meryl_tpu's: the host sort
path (sort_starts, then host_rle_finish, for one chunk and for a whole
count) against the reference's device-compacted count, the compacted
merges, the histogram and the count-suffix filter.  The same seeded
numpy inputs go to both, and every output is an integer array that must
be equal bit for bit (tolerance zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meryl_tpu import counter as ref_counter
from meryl_tpu import kmer as km
from meryl_tpu.ops import count as ref_count
from meryl_tpu.ops import extract as ref_ext
from meryl_tpu_torch import counter
from meryl_tpu_torch.ops import count as cnt
from meryl_tpu_torch.ops import extract as text
from meryl_tpu_torch.ops import multiword as mw

COMP = {"A": "T", "C": "G", "T": "A", "G": "C"}
KS = [16, 21, 32, 33, 64]


def _codes(k, L=1 << 11, seed=0):
    """Random codes with breakers, a poly-G stretch (the all-ones k-mer,
    which aliases the sentinel when 2k % 32 == 0) and repeats."""
    rng = np.random.default_rng(1000 * seed + k)
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    codes[: L // 4] = np.tile(codes[: L // 16], 4)        # duplicates
    codes[rng.integers(0, L, size=L // 100)] = 255
    codes[L // 2: L // 2 + 2 * k + 40] = 3                # poly-G
    return codes


def _both_extract(codes, k, mode="forward"):
    planes, valid = ref_ext.extract_kmers(jnp.asarray(codes), k, mode)
    key, tvalid = text.extract_kmers(torch.from_numpy(codes), k, mode)
    return planes, valid, key, tvalid


def _assert_keys(tkey, planes, k):
    for a, b in zip(mw.to_planes(tkey.numpy(), k), planes):
        np.testing.assert_array_equal(a, np.asarray(b))


def _port_key(planes, k):
    return torch.from_numpy(mw.from_planes(
        [np.asarray(p) for p in planes], k))


def _port_counts(c):
    return torch.from_numpy(np.asarray(c).astype(np.int64))


def _host_sort(key, valid, k):
    """One chunk's keys through the host sort path: the device sort and
    run starts, then the host's run lengths -> (hi, lo, counts)."""
    (run,) = counter._finish_chunk(cnt.sort_starts(key, valid, k), None, k)
    return run


def _assert_ref_compacted(got, up, c, n, k):
    """(hi, lo, counts) equal to the first n entries of the reference's
    sort_count_compacted output."""
    n = int(n)
    hi, lo = mw.to_hilo(_port_key([np.asarray(p)[:n] for p in up], k)
                        .numpy(), k)
    np.testing.assert_array_equal(got[0], hi)
    np.testing.assert_array_equal(got[1], lo)
    np.testing.assert_array_equal(got[2], np.asarray(c)[:n])
    assert not np.asarray(c)[n:].any()


@pytest.mark.parametrize("k", KS)
def test_sort_starts_matches_reference_compacted(k):
    """A chunk's codes through the host sort path's _count_chunk and
    _finish_chunk."""
    codes = _codes(k)
    planes, valid = ref_ext.extract_kmers(jnp.asarray(codes), k, "forward")
    up, c, n = ref_count.sort_count_compacted(planes, valid)
    got = counter._finish_chunk(*counter._count_chunk(codes, k, "forward",
                                                      "cpu"))
    assert len(got) == 1 and len(got[0][2]) == int(n) > 0
    _assert_ref_compacted(got[0], up, c, n, k)
    if 2 * k % 32 == 0:  # the all-ones k-mer survives as the last unique
        s_hi, s_lo = mw.sentinel_hilo(k)
        assert (int(got[0][0][-1]), int(got[0][1][-1])) == (s_hi, s_lo)
        assert int(got[0][2][-1]) == 2 * k + 40 - k + 1


@pytest.mark.parametrize("k", KS)
def test_sort_starts_all_invalid(k):
    """An input with no valid window: nothing counted."""
    codes = np.full(256, 255, np.uint8)
    planes, valid, key, tvalid = _both_extract(codes, k)
    up, c, n = ref_count.sort_count_compacted(planes, valid)
    got = _host_sort(key, tvalid, k)
    assert int(n) == 0 and len(got[2]) == 0
    _assert_ref_compacted(got, up, c, n, k)


@pytest.mark.parametrize("keys,valid,want_k,want_c", [
    ([5, 3, 5, 3, 3, 7, 9, 9], [1, 1, 1, 1, 1, 1, 1, 0],
     [3, 5, 7, 9], [3, 2, 1, 1]),
    ([0xFFFFFFFF, 1, 0xFFFFFFFF, 2], [1, 1, 0, 1],
     [1, 2, 0xFFFFFFFF], [1, 1, 1]),
    ([0] * 16, [0] * 16, [], []),
])
def test_sort_starts_small_cases(keys, valid, want_k, want_c):
    """The cases of tests/test_kernels.py (basic, sentinel collision,
    all invalid), one 32-bit plane (k = 16)."""
    k = 16
    planes = [np.array(keys, np.uint32)]
    v = np.array(valid, bool)
    up, c, n = ref_count.sort_count_compacted(
        [jnp.asarray(planes[0])], jnp.asarray(v))
    got = _host_sort(_port_key(planes, k), torch.from_numpy(v), k)
    assert int(n) == len(want_k)
    _assert_ref_compacted(got, up, c, n, k)
    assert got[1].tolist() == want_k and got[2].tolist() == want_c


def _runs(k, n_runs, seed):
    """Sorted unique sentinel-padded runs in the reference's format,
    from sort_count_compacted of different chunks (they share k-mers)."""
    out = []
    for i in range(n_runs):
        codes = _codes(k, 1 << 10, seed=seed + i)
        if i:  # overlap with run 0
            codes[:300] = _codes(k, 1 << 10, seed=seed)[:300]
        planes, valid = ref_ext.extract_kmers(jnp.asarray(codes), k,
                                              "forward")
        up, c, _ = ref_count.sort_count_compacted(planes, valid)
        out.append((up, c))
    return out


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n_runs", [2, 3])
def test_merge_many_matches_reference(k, n_runs):
    runs = _runs(k, n_runs, seed=7)
    up, c, n = ref_count.merge_many([r[0] for r in runs],
                                    [r[1] for r in runs])
    tk, tc, tn = cnt.merge_many([_port_key(r[0], k) for r in runs],
                                [_port_counts(r[1]) for r in runs], k)
    assert int(tn) == int(n) > 0
    np.testing.assert_array_equal(tc.numpy(), np.asarray(c))
    _assert_keys(tk, up, k)
    if n_runs == 2:
        tk2, tc2, tn2 = cnt.merge_counted(
            _port_key(runs[0][0], k), _port_counts(runs[0][1]),
            _port_key(runs[1][0], k), _port_counts(runs[1][1]), k)
        assert torch.equal(tk2, tk) and torch.equal(tc2, tc)
        assert int(tn2) == int(tn)


def test_merge_many_counts_wrap_like_uint32():
    """Sums wrap modulo 2^32 as the reference's uint32 counts do: a key
    whose counts add to exactly 2^32 drops out, leaving a hole."""
    k = 16
    a = [np.array([2, 5, 0xFFFFFFFF, 0xFFFFFFFF], np.uint32)]
    b = [np.array([2, 5, 9, 0xFFFFFFFF], np.uint32)]
    ca = np.array([1 << 31, 0xFFFFFFF0, 0, 0], np.uint32)
    cb = np.array([1 << 31, 0x20, 4, 0], np.uint32)
    up, c, n = ref_count.merge_many(
        [[jnp.asarray(a[0])], [jnp.asarray(b[0])]],
        [jnp.asarray(ca), jnp.asarray(cb)])
    tk, tc, tn = cnt.merge_many([_port_key(a, k), _port_key(b, k)],
                                [_port_counts(ca), _port_counts(cb)], k)
    assert int(tn) == int(n) == 2
    np.testing.assert_array_equal(tc.numpy(), np.asarray(c))
    _assert_keys(tk, up, k)
    assert tc[:3].tolist() == [0, 0x10, 4]


@pytest.mark.parametrize("runs,want_k,want_c", [
    ([([2, 5], [1, 2]), ([2, 9], [7, 4])], [2, 5, 9], [8, 2, 4]),
    ([([1, 4], [2, 3]), ([1, 9], [5, 1]), ([4], [7])], [1, 4, 9],
     [7, 10, 1]),
    ([([], []), ([], [])], [], []),
])
def test_merge_many_small_cases(runs, want_k, want_c):
    """tests/test_kernels.py's merge_counted and merge_many cases, and
    runs that are all padding."""
    k = 16
    planes, counts = [], []
    for vals, cs in runs:
        pad = 4 - len(vals)
        planes.append([np.array(vals + [0xFFFFFFFF] * pad, np.uint32)])
        counts.append(np.array(cs + [0] * pad, np.uint32))
    up, c, n = ref_count.merge_many(
        [[jnp.asarray(p[0])] for p in planes],
        [jnp.asarray(x) for x in counts])
    tk, tc, tn = cnt.merge_many([_port_key(p, k) for p in planes],
                                [_port_counts(x) for x in counts], k)
    n = int(tn)
    assert n == len(want_k)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(c))
    _assert_keys(tk, up, k)
    assert mw.to_planes(tk.numpy(), k)[0][:n].tolist() == want_k
    assert tc[:n].tolist() == want_c


@pytest.mark.parametrize("num_values", [8, 256, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_value_histogram_matches_reference(num_values, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 40, size=5000).astype(np.uint32)
    counts[rng.integers(0, 5000, size=50)] = \
        rng.integers(1000, 1 << 32, size=50).astype(np.uint32)
    counts[:100] = 0  # padding
    want = np.asarray(ref_count.value_histogram(jnp.asarray(counts),
                                                num_values, block=1 << 10))
    got = cnt.value_histogram(_port_counts(counts), num_values).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got.sum() == (counts > 0).sum()


def test_value_histogram_small_case():
    counts = np.array([1, 1, 2, 5, 0, 0, 100], np.uint32)
    h = cnt.value_histogram(_port_counts(counts), 8).numpy()
    np.testing.assert_array_equal(
        h, np.asarray(ref_count.value_histogram(jnp.asarray(counts), 8)))
    assert h.tolist() == [0, 2, 1, 0, 0, 1, 0, 1]


# ------------------------------------------------------- count-suffix

def _suffix_cases():
    for k in (16, 17, 32, 33, 64):
        for slen in (1, k - 1, k):
            yield k, slen


@pytest.mark.parametrize("k,slen", list(_suffix_cases()))
@pytest.mark.parametrize("mode", ["canonical", "forward"])
def test_suffix_filter_matches_reference(k, slen, mode):
    """The suffix mask on the port's one or two int64 words against the
    reference's on 32-bit planes.  The suffix is taken from a window
    that occurs several times, so the filter keeps something."""
    codes = _codes(k, 1 << 10)
    codes[100:100 + 3 * k] = np.tile(
        np.random.default_rng(k).integers(0, 4, size=k).astype(np.uint8), 3)
    planes, valid, key, tvalid = _both_extract(codes, k, mode)
    pos = 100 + k - 1   # a window of the repeat, whether a position
    #                     names a window's first base or its last
    hi, lo = mw.to_hilo(key[pos:pos + 1].numpy(), k)
    full = (int(hi[0]) << 64) | int(lo[0])
    suffix = (full & ((1 << (2 * slen)) - 1), slen)
    _, want = ref_counter._suffix_filter(planes, valid, suffix)
    got = counter._suffix_filter(key, tvalid, suffix, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[pos] and got.sum() < tvalid.sum()
    assert counter._suffix_filter(key, tvalid, None, k) is tvalid


def _brute_suffix(seqs, k, mode, suffix):
    """Count k-mers AS STORED (canonical / forward / reverse-complement)
    whose last len(suffix) bases are `suffix`."""
    out = {}
    for s in seqs:
        for i in range(len(s) - k + 1):
            w = s[i:i + k]
            if any(ch not in "ACGT" for ch in w):
                continue
            rc = "".join(COMP[ch] for ch in reversed(w))
            f, r = km.string_to_kmer(w), km.string_to_kmer(rc)
            stored = {"canonical": w if f <= r else rc, "forward": w,
                      "reverse": rc}[mode]
            if stored.endswith(suffix):
                key = km.string_to_kmer(stored)
                out[key] = out.get(key, 0) + 1
    return out


def _as_dict(hi, lo, c):
    return {(int(h) << 64) | int(l): int(v) for h, l, v in zip(hi, lo, c)}


def _write_fa(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">s{i}\n{s}\n")


@pytest.fixture
def no_shard(monkeypatch):
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")


@pytest.mark.parametrize("k,mode,suffix", [
    (21, "canonical", "ACG"), (21, "forward", "T"), (21, "reverse", "GA"),
    (16, "forward", "GGGG"), (33, "canonical", "C"), (9, "reverse", "whole k-mer"),
])
def test_count_suffix_matches_reference_and_brute(tmp_path, no_shard,
                                                  monkeypatch, k, mode,
                                                  suffix):
    """The filter applies to the k-mer as stored, not to the read's
    strand: pinned by a brute force.  A suffix sends the count to the
    host sort path even when the device accumulator is forced."""
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", "1")
    rng = np.random.default_rng(k)
    seqs = ["".join("ACTG"[c] for c in rng.integers(0, 4, size=300))
            for _ in range(25)] + ["G" * 50, "ACGTN" * 20]
    if suffix == "whole k-mer":  # a suffix of k bases, one that occurs
        suffix = "".join(COMP[ch] for ch in reversed(seqs[0][:k]))
    fa = str(tmp_path / "in.fa")
    _write_fa(fa, seqs)
    assert counter._use_device_acc([fa], k, "cpu", suffix) == 0
    ref = _as_dict(*ref_counter.count_to_arrays(
        [fa], k, mode=mode, chunk_len=1 << 12, count_suffix=suffix))
    got = _as_dict(*counter.count_to_arrays(
        [fa], k, mode=mode, chunk_len=1 << 12, count_suffix=suffix,
        device="cpu"))
    want = _brute_suffix(seqs, k, mode, suffix)
    assert got == ref == want and want


def test_count_suffix_longer_than_k_raises(tmp_path, no_shard):
    fa = str(tmp_path / "in.fa")
    _write_fa(fa, ["ACGTACGTACGT"])
    for fn, kw in ((ref_counter.count_to_arrays, {}),
                   (counter.count_to_arrays, {"device": "cpu"})):
        with pytest.raises(ValueError, match="count-suffix longer than k"):
            fn([fa], 5, count_suffix="ACGTAC", **kw)


# --------------------------------------- the host sort path, a whole count

@pytest.mark.parametrize("k,mode,suffix", [
    (21, "canonical", None), (16, "forward", None), (33, "canonical", None),
    (64, "forward", None), (21, "canonical", "AC")])
def test_host_sort_chunk_path_matches_reference_compacted(
        tmp_path, no_shard, monkeypatch, k, mode, suffix):
    """A count on the host sort path (sort_starts on the device, run
    lengths and the merge on the host): equal arrays to the reference's
    device-compacted pipeline."""
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", "0")
    rng = np.random.default_rng(k + 3)
    seqs = ["".join("ACTG"[c] for c in rng.integers(0, 4, size=250))
            for _ in range(20)] * 2 + ["G" * 80, "ACGTN" * 20]
    fa = str(tmp_path / "in.fa")
    _write_fa(fa, seqs)
    kw = dict(mode=mode, chunk_len=1 << 12, count_suffix=suffix)
    seen = []
    real = counter.cnt.sort_starts
    monkeypatch.setattr(counter.cnt, "sort_starts",
                        lambda *a: seen.append(1) or real(*a))
    got = counter.count_to_arrays([fa], k, device="cpu", **kw)
    assert seen
    # the reference reads its knob at import into this global
    monkeypatch.setattr(ref_counter, "_COMPACT_DEVICE", True)
    ref = ref_counter.count_to_arrays([fa], k, **kw)
    assert len(ref[2])
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
