"""The one-card count's finalize tail in one native pass
(csrc/finalize_host.cpp through counter.finalize_dense) against the numpy
tail it replaces (mw.to_hilo, merge_runs, the clamp and the all-ones
append): the same planted counter finalized by both paths must give
the same (hi, lo, counts) bit for bit, at one and several threads; and
a fed counter that captures windows against meryl_tpu and a brute
force."""

import numpy as np
import pytest
import torch

from meryl_tpu import counter as ref_counter
from meryl_tpu_torch import counter as ctr
from meryl_tpu_torch import kmer as km
from meryl_tpu_torch.ops import multiword as mw

B = 8
VMAX = int(km.VALUE_MAX)


def _keys(rng, n, k):
    """-> sorted distinct unsigned (hi, lo) of about n k-mers, never the
    all-ones one (the sentinel at 2k % 32 == 0)."""
    bits = 2 * k
    lo = rng.integers(0, 1 << min(bits, 63), size=n, dtype=np.uint64)
    if bits >= 64:
        lo = (lo << np.uint64(1)) | rng.integers(0, 2, size=n,
                                                 dtype=np.uint64)
    hi = rng.integers(0, 1 << (bits - 64), size=n, dtype=np.uint64) \
        if bits > 64 else np.zeros(n, np.uint64)
    ones_hi, ones_lo = mw.sentinel_hilo(k)
    keep = ~((hi == np.uint64(ones_hi)) & (lo == np.uint64(ones_lo)))
    hi, lo = hi[keep], lo[keep]
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    new = np.ones(len(lo), bool)
    new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    return hi[new], lo[new]


def _case(name):
    """-> (k, download (hi, lo, counts-u32) or None, captured windows
    (hi, lo) with repeats, host-counted runs, n_allones)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    k = int(name.split("-")[0][1:])
    kind = name.split("-", 1)[1]
    n = {"small-larger": 100, "empty-download": 0, "no-acc": 50}.get(
        kind, 60_000 if kind == "hifi" else 5_000)
    # hifi: 2,124 new keys and 2,000 hits, a HiFi job's 4,124 windows
    m = {"hifi": 2124, "empty": 0, "one": 1, "one-hit": 0,
         "small-larger": 0}.get(kind, 300)
    hi, lo = _keys(rng, n + m + 16, k)
    pick = np.zeros(len(lo), bool)
    pick[rng.choice(len(lo), min(m, len(lo)), replace=False)] = True
    if kind == "edges":      # small keys before the first and past the last
        pick[:3] = pick[-3:] = True
    d_hi, d_lo = hi[~pick], lo[~pick]
    if kind == "empty-download":
        d_hi, d_lo = d_hi[:0], d_lo[:0]
    d_c = rng.integers(1, 1 << 20, size=len(d_lo)).astype(np.uint32)
    d_c[::97] = VMAX                                    # saturated
    c_hi, c_lo = hi[pick], lo[pick]
    if kind in ("hifi", "one-hit", "clamp") and len(d_lo):
        hits = rng.choice(len(d_lo), 2000 if kind == "hifi" else
                          1 if kind == "one-hit" else 40, replace=False)
        c_hi = np.concatenate([c_hi, d_hi[hits]])
        c_lo = np.concatenate([c_lo, d_lo[hits]])
        if kind == "clamp":  # the sum passes VALUE_MAX
            d_c[hits] = VMAX - 3
    if len(c_lo) > 1:        # a window captured several times
        rep = rng.integers(1, 4, size=len(c_lo))
        c_hi, c_lo = np.repeat(c_hi, rep), np.repeat(c_lo, rep)
        if kind == "clamp":
            c_hi = np.concatenate([c_hi, np.repeat(c_hi[-1:], 10)])
            c_lo = np.concatenate([c_lo, np.repeat(c_lo[-1:], 10)])
    perm = rng.permutation(len(c_lo))
    runs = []
    if kind == "small-larger":     # a host-counted run past the download
        f_hi, f_lo = _keys(rng, 5000, k)
        f_c = rng.integers(1, 9, size=len(f_lo)).astype(np.uint64)
        f_c[7] = np.uint64(1 << 33)                     # past 32 bits
        runs.append((f_hi, f_lo, f_c))
    if kind == "no-acc":
        runs.append((d_hi, d_lo, np.ones(len(d_lo), np.uint64)))
    n_allones = 0
    if kind in ("allones", "allones-host"):
        n_allones = 7
        if kind == "allones-host":   # a recounted chunk held it too
            a_hi, a_lo = mw.sentinel_hilo(k)
            runs.append((np.array([a_hi], np.uint64),
                         np.array([a_lo], np.uint64),
                         np.array([VMAX - 2], np.uint64)))
    dl = None if kind == "no-acc" else (d_hi, d_lo, d_c)
    return k, dl, (c_hi[perm], c_lo[perm]), runs, n_allones


def _planted(k, dl, capt, runs, n_allones):
    """A CPU counter holding this state, as a count leaves it before
    finalize: the download's entries in B sorted rows of the accumulator
    (padding at count 0), the captured windows, the host-counted runs,
    the all-ones scalar."""
    c = ctr.DeviceAccCounter(k, "forward", 1 << 12, 1, device="cpu")
    assert c.B == B
    if dl is not None:
        hi, lo, cts = dl
        cuts = np.linspace(0, len(lo), B + 1).astype(int)
        la = max(64, int(np.diff(cuts).max()) + 1)
        s_hi, s_lo = mw.sentinel_hilo(k)
        keys = mw.from_hilo(np.full(B * la, s_hi, np.uint64),
                            np.full(B * la, s_lo, np.uint64), k)
        keys = keys.reshape((B, la) + keys.shape[1:])
        counts = np.zeros((B, la), np.int64)
        for r in range(B):
            a, b = cuts[r], cuts[r + 1]
            keys[r, :b - a] = mw.from_hilo(hi[a:b], lo[a:b], k)
            counts[r, :b - a] = cts[a:b]
        c._acc = (torch.from_numpy(keys), torch.from_numpy(counts))
        c.La = la
        c._max_run = int((counts > 0).sum(axis=1).max())
    if len(capt[1]):
        c._ovf_keys = [mw.from_hilo(capt[0], capt[1], k)]
    c._fallback_runs = list(runs)
    if n_allones:
        c._nallones = [torch.tensor(n_allones)]
    return c


CASES = ["k21-empty", "k21-one", "k21-one-hit", "k21-hifi", "k33-hifi",
         "k64-hifi", "k33-empty", "k64-one", "k21-edges", "k64-edges",
         "k21-small-larger", "k21-clamp", "k33-clamp", "k21-empty-download",
         "k21-no-acc", "k16-allones", "k32-allones", "k32-allones-host"]


@pytest.mark.parametrize("name", CASES)
def test_native_finalize_is_the_numpy_tail(name, monkeypatch):
    """finalize through the native pass (1, 3 and 8 threads) equals
    finalize through numpy bit for bit, dtypes included; the pass counts
    one native finalize and the small run's entries."""
    state = _case(name)
    monkeypatch.setenv("MERYL_TPU_NO_NATIVE", "1")
    before = dict(ctr.FINALIZE_STATS)
    want = _planted(*state).finalize()
    assert ctr.FINALIZE_STATS["numpy"] == before["numpy"] + 1
    assert want[2].dtype == np.uint32
    monkeypatch.delenv("MERYL_TPU_NO_NATIVE")
    assert ctr._native_finalize() is not None
    k, dl, capt, runs, n_allones = state
    small = list(runs)
    if len(capt[1]):
        small.append(ctr._unique_run(*capt))
    if n_allones:
        small.append(_planted(*state)._allones_run(n_allones))
    n_small = len(ctr.merge_runs(small)[2])
    for threads in (1, 3, 8):
        monkeypatch.setattr(ctr, "FINALIZE_THREADS", threads)
        before = dict(ctr.FINALIZE_STATS)
        got = _planted(*state).finalize()
        assert ctr.FINALIZE_STATS["native"] == before["native"] + 1
        assert ctr.FINALIZE_STATS["merged"] == before["merged"] + n_small
        assert ctr.FINALIZE_STATS["numpy"] == before["numpy"]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if n_allones:
        a_hi, a_lo = mw.sentinel_hilo(k)
        assert (want[0][-1], want[1][-1]) == (a_hi, a_lo)
    if name == "k21-clamp":
        assert (want[2] == VMAX).sum() > (dl[2] == VMAX).sum()


def _write_fa(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">s{i}\n{s}\n")


def _brute(seqs, k):
    comp = str.maketrans("ACGT", "TGCA")
    out = {}
    for s in seqs:
        for i in range(len(s) - k + 1):
            w = s[i:i + k]
            f = km.string_to_kmer(w)
            rc = km.string_to_kmer(w.translate(comp)[::-1])
            out[min(f, rc)] = out.get(min(f, rc), 0) + 1
    return out


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_counter_finalize_with_captures(tmp_path, monkeypatch, path):
    """A count whose routing rows overflow (poly-A and poly-AC runs)
    captures windows; finalize counts by the path it took, merges the
    capture run's unique keys natively, and gives meryl_tpu's count."""
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", "1")
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    if path == "numpy":
        monkeypatch.setenv("MERYL_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("MERYL_TPU_NO_NATIVE", raising=False)
    rng = np.random.default_rng(31)
    seqs = ["A" * 1850, "AC" * 700] + [
        "".join("ACTG"[c] for c in rng.integers(0, 4, size=300))
        for _ in range(30)]
    fa = str(tmp_path / "in.fa")
    _write_fa(fa, seqs)
    captured = []
    real_capture = ctr.DeviceAccCounter._capture_run

    def capture_run(self):
        run = real_capture(self)
        captured.append(len(run[2]))
        return run

    monkeypatch.setattr(ctr.DeviceAccCounter, "_capture_run", capture_run)
    exp = ctr._use_device_acc([fa], 21, "cpu")
    before = dict(ctr.FINALIZE_STATS)
    got = ctr.count_to_arrays_device_acc(
        [fa], 21, mode="canonical", hpc=False, chunk_len=1 << 15,
        expected_uniques=exp, device="cpu")
    stats = dict(ctr.LAST_WIRE_STATS)
    assert stats["captured"] > 0 and stats["recounts"] == 0
    assert len(captured) == 1 and captured[0] > 0
    assert ctr.FINALIZE_STATS[path] == before[path] + 1
    other = "numpy" if path == "native" else "native"
    assert ctr.FINALIZE_STATS[other] == before[other]
    merged = ctr.FINALIZE_STATS["merged"] - before["merged"]
    assert merged == (captured[0] if path == "native" else 0)
    ref = ref_counter.count_to_arrays_device_acc(
        [fa], 21, mode="canonical", hpc=False, chunk_len=1 << 15,
        expected_uniques=exp)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got[2].dtype == np.uint32
    assert {int(v): int(c) for v, c in zip(got[1], got[2])} == \
        _brute(seqs, 21)
