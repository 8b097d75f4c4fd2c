"""meryl_tpu_torch counting against meryl_tpu and an inline brute force:
the device-accumulator path (forced, on the CPU) with every exactness
hatch, the host sort path, and the sort/run-start ops it uses."""

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


def _brute(seqs, k, mode="canonical"):
    out = {}
    for s in seqs:
        for i in range(len(s) - k + 1):
            w = s[i:i + k]
            if any(ch not in "ACGT" for ch in w):
                continue
            f = km.string_to_kmer(w)
            rc = km.string_to_kmer("".join(COMP[ch] for ch in reversed(w)))
            if mode == "canonical":
                f = min(f, rc)
            elif mode == "reverse":
                f = rc
            out[f] = out.get(f, 0) + 1
    return out


def _rand_seqs(rng, n, ln):
    return ["".join("ACTG"[c] for c in rng.integers(0, 4, size=ln))
            for _ in range(n)]


def _as_dict(hi, lo, c):
    return {(int(h) << 64) | int(l): int(v) for h, l, v in zip(hi, lo, c)}


def _write_fa(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">s{i}\n{s}\n")


@pytest.fixture(autouse=True)
def force_acc(monkeypatch):
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", "1")
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")


def _count_both(tmp_path, seqs, k, mode="canonical", chunk_len=1 << 15,
                expected=None):
    """-> (port dict, reference dict, port run stats)."""
    fa = str(tmp_path / "in.fa")
    _write_fa(fa, seqs)
    exp = expected or ref_counter._use_device_acc(None, [fa], k, chunk_len)
    assert exp == (expected or counter._use_device_acc([fa], k, "cpu"))
    ref = ref_counter.count_to_arrays_device_acc(
        [fa], k, mode=mode, hpc=False, chunk_len=chunk_len,
        expected_uniques=exp)
    got = counter.count_to_arrays_device_acc(
        [fa], k, mode=mode, hpc=False, chunk_len=chunk_len,
        expected_uniques=exp, device="cpu")
    return _as_dict(*got), _as_dict(*ref), dict(counter.LAST_WIRE_STATS)


@pytest.mark.parametrize("k,mode", [(21, "canonical"), (15, "forward"),
                                    (33, "canonical"), (9, "reverse")])
def test_acc_matches_reference_and_brute(tmp_path, k, mode):
    rng = np.random.default_rng(21)
    base = _rand_seqs(rng, 40, 300)
    seqs = base * 3 + _rand_seqs(rng, 30, 200)
    got, ref, _ = _count_both(tmp_path, seqs, k, mode)
    assert got == ref == _brute(seqs, k, mode)


def test_acc_native_pack_every_chunk(tmp_path, monkeypatch):
    """Each chunk of a count is packed by the native pass (native_packs
    = chunks); under MERYL_TPU_NO_NATIVE by none, with the same counts."""
    rng = np.random.default_rng(19)
    seqs = _rand_seqs(rng, 60, 300) + ["ACGTN" * 30]
    monkeypatch.delenv("MERYL_TPU_NO_NATIVE", raising=False)
    got, ref, stats = _count_both(tmp_path, seqs, 21, chunk_len=1 << 12)
    assert stats["chunks"] > 1 and stats["recounts"] == 0
    assert stats["native_packs"] == stats["chunks"]
    monkeypatch.setenv("MERYL_TPU_NO_NATIVE", "1")
    fallback = counter.count_to_arrays_device_acc(
        [str(tmp_path / "in.fa")], 21, mode="canonical", hpc=False,
        chunk_len=1 << 12, expected_uniques=counter._use_device_acc(
            [str(tmp_path / "in.fa")], 21, "cpu"), device="cpu")
    assert counter.LAST_WIRE_STATS["native_packs"] == 0
    assert counter.LAST_WIRE_STATS["chunks"] == stats["chunks"]
    assert _as_dict(*fallback) == got == ref == _brute(seqs, 21)


@pytest.mark.parametrize("k", [16, 32])
def test_acc_allones_kmer(tmp_path, k):
    rng = np.random.default_rng(5)
    seqs = _rand_seqs(rng, 20, 200) + ["G" * 40, "G" * k]
    got, ref, _ = _count_both(tmp_path, seqs, k, "forward")
    want = _brute(seqs, k, "forward")
    assert got == ref == want
    assert got[(1 << (2 * k)) - 1] == 40 - k + 2


def test_acc_allones_not_doubled_by_host_recount(tmp_path):
    """A chunk recounted on the host path (poly-A overflow past OVF_CAP)
    that also holds all-ones windows: its device scalar must drop."""
    seqs = ["A" * 5000, "G" * 40]
    got, ref, stats = _count_both(tmp_path, seqs, 16, "forward",
                                  chunk_len=1 << 13)
    assert stats["recounts"] > 0
    assert got == ref == _brute(seqs, 16, "forward")
    assert got[(1 << 32) - 1] == 25


def test_acc_overflow_recount(tmp_path):
    seqs = ["A" * 5000, "A" * 3000]
    got, ref, stats = _count_both(tmp_path, seqs, 21, "forward",
                                  chunk_len=1 << 13)
    assert stats["recounts"] > 0
    assert got == ref == _brute(seqs, 21, "forward")


def test_acc_overflow_capture(tmp_path):
    rng = np.random.default_rng(31)
    seqs = ["A" * 1850] + _rand_seqs(rng, 30, 300)
    got, ref, stats = _count_both(tmp_path, seqs, 21)
    assert stats["captured"] > 0 and stats["recounts"] == 0
    assert got == ref == _brute(seqs, 21)


def test_acc_regrow(tmp_path):
    rng = np.random.default_rng(7)
    seqs = _rand_seqs(rng, 60, 400)
    got, ref, stats = _count_both(tmp_path, seqs, 21, chunk_len=1 << 14,
                                  expected=64)
    assert stats["regrows"] > 0
    assert got == ref == _brute(seqs, 21)


def test_acc_with_n_bases(tmp_path):
    rng = np.random.default_rng(9)
    seqs = ["ACGTNNACGTACGTACGTACGTTTTGCA" * 8, *_rand_seqs(rng, 10, 150)]
    got, ref, _ = _count_both(tmp_path, seqs, 11)
    assert got == ref == _brute(seqs, 11)


def test_acc_multi_chunk_merges(tmp_path):
    rng = np.random.default_rng(13)
    seqs = _rand_seqs(rng, 200, 500)
    got, ref, stats = _count_both(tmp_path, seqs, 21, chunk_len=1 << 13)
    assert stats["merges"] > 1 and stats["chunks"] > 8
    assert got == ref == _brute(seqs, 21)


def test_acc_capacity_salvage(tmp_path, monkeypatch):
    monkeypatch.setenv("MERYL_TPU_ACC_CAP_GB", "0.000002")  # ~2 KB
    rng = np.random.default_rng(17)
    seqs = _rand_seqs(rng, 80, 400)
    got, ref, stats = _count_both(tmp_path, seqs, 21, chunk_len=1 << 13,
                                  expected=64)
    assert stats["salvaged"]
    assert got == ref == _brute(seqs, 21)


def test_acc_deferred_regrow_exact():
    """The merge's row-overflow check is deferred one merge cadence: an
    overflow found while later chunks are staged must still regrow and
    count exactly."""
    rng = np.random.default_rng(31)
    seqs = _rand_seqs(rng, 40, 600)
    acc = counter.DeviceAccCounter(21, "canonical", 1 << 13,
                                   expected_uniques=8, device="cpu")
    la0 = acc.La
    for s in seqs:
        acc.add_codes(km.encode_bases(s))
    got = _as_dict(*acc.finalize())
    assert acc.La > la0 and acc.n_regrows > 0
    assert got == _brute(seqs, 21)


def test_capacity_budget_counts_held_state():
    """A regrow's budget counts what stays alive during it (the old
    accumulator and the staged cells), so a budget that fits the new
    accumulator alone still raises AccCapacity."""
    rng = np.random.default_rng(3)
    seqs = _rand_seqs(rng, 8, 600)
    acc = counter.DeviceAccCounter(21, "canonical", 1 << 13,
                                   expected_uniques=8, device="cpu")
    acc.La = 256  # ~580 uniques per row overflow it
    for s in seqs:  # the M-th chunk dispatches a merge, unverified
        acc.add_codes(km.encode_bases(s))
    _, _, n_runs, old_acc, staged, la = acc._unverified
    new_la = la
    while new_la < int(n_runs.max()):
        new_la *= 2
    # enough for the grown merge's working set, not for the held state
    acc._cap_bytes = new_la * acc.B * counter.acc_bytes_per_unique(21) + 1
    with pytest.raises(counter.AccCapacity):
        acc._verify_merge()
    assert acc._acc is old_acc and acc.La == la
    assert len(acc._staged) == len(staged)
    assert all(a is b for a, b in zip(acc._staged, staged))
    assert _as_dict(*counter.merge_runs(acc.salvage())) == \
        _brute(seqs, 21)


@pytest.mark.parametrize("k,mode", [(21, "canonical"), (16, "forward"),
                                    (32, "forward"), (64, "forward")])
def test_host_path_matches_reference(tmp_path, monkeypatch, k, mode):
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", "0")
    rng = np.random.default_rng(k)
    seqs = _rand_seqs(rng, 50, 300) + ["G" * 80, "ACGTN" * 30]
    fa = str(tmp_path / "in.fa")
    _write_fa(fa, seqs)
    ref = _as_dict(*ref_counter.count_to_arrays([fa], k, mode=mode,
                                                chunk_len=1 << 13))
    got = _as_dict(*counter.count_to_arrays([fa], k, mode=mode,
                                            chunk_len=1 << 13,
                                            device="cpu"))
    assert got == ref == _brute(seqs, k, mode)


@pytest.mark.parametrize("k", [16, 21, 33])
def test_sort_ops_match_reference(k):
    rng = np.random.default_rng(k)
    L = 1 << 12
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    codes[:300] = 3  # poly-G: all-ones windows alias the sentinel at 16
    codes[rng.integers(0, L, size=40)] = 255
    planes, valid = ref_ext.extract_kmers(jnp.asarray(codes), k, "forward")
    key, tvalid = text.extract_kmers(torch.from_numpy(codes), k, "forward")

    sp, counts, start, n_unique = ref_count.sort_count(planes, valid)
    tk, tcounts, tstart, tn = cnt.sort_count(key, tvalid, k)
    np.testing.assert_array_equal(tstart.numpy(), np.asarray(start))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(counts))
    assert int(tn) == int(n_unique)
    for a, b in zip(mw.to_planes(tk.numpy(), k), sp):
        np.testing.assert_array_equal(a, np.asarray(b))

    for rowlen in (None, 256):
        sp, start, n_inv = ref_count.sort_starts(planes, valid, rowlen)
        tk, tstart, tn_inv = cnt.sort_starts(key, tvalid, k, rowlen)
        np.testing.assert_array_equal(tstart.numpy(), np.asarray(start))
        np.testing.assert_array_equal(tn_inv.numpy(), np.asarray(n_inv))
        for a, b in zip(mw.to_planes(tk.numpy(), k), sp):
            np.testing.assert_array_equal(a, np.asarray(b))
