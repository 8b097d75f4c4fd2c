"""meryl_tpu_torch on the card: the CUDA kernels (extraction, the
bitonic row sorts and their pass floor) against their plain PyTorch
versions, and the counting and set-op paths on CUDA against the CPU.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports no JAX, so on
the card's machine (which has none) run it without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import os
import re

import numpy as np
import pytest
import torch

from meryl_tpu_torch import counter
from meryl_tpu_torch import kmer as km
from meryl_tpu_torch.ops import accum
from meryl_tpu_torch.ops import extract as ext
from meryl_tpu_torch.ops import extract_cuda
from meryl_tpu_torch.ops import multiword as mw
from meryl_tpu_torch.ops import rowsort, setops

pytestmark = pytest.mark.cuda

KS = [1, 5, 15, 16, 21, 31, 32, 33, 48, 63, 64]
MODES = ["canonical", "forward", "reverse", "both"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _wire(seed, L, dev):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    codes[rng.integers(0, L, size=L // 100)] = 255
    codes[1000:1037] = 255
    codes[L - 333:] = 255  # n_real < L
    packed2, exc, n_real = km.pack_codes_2bit(codes)
    return (torch.from_numpy(packed2.view(np.int32)).to(dev),
            torch.from_numpy(exc).to(dev), n_real)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("L", [1 << 16, 4096 + 48])
def test_kernel_matches_plain(cuda, k, mode, L):
    p, e, n_real = _wire(k * 7 + L, L, cuda)
    before = extract_cuda.LAUNCHES
    got = extract_cuda.extract_kmers_packed(p, e, n_real, k, mode)
    torch.cuda.synchronize()
    assert extract_cuda.LAUNCHES == before + 1
    want = ext.extract_kmers_packed(p, e, n_real, k, mode)
    assert torch.equal(got[-1], want[-1])
    v = want[-1]
    assert v.any()
    for g, w in zip(got[:-1], want[:-1]):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g[v], w[v])


def _extract_consts():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "meryl_tpu_torch", "csrc", "extract.cu")
    with open(path) as f:
        text = f.read()
    return [int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
            for n in ("TILE", "HALO", "MIN_RUN")]


TILE, HALO, MIN_RUN = _extract_consts()


def _edge_codes(rng, L):
    """Random codes with an exception at and around every tile edge,
    CTA edge and halo end of the grid the kernel takes at L: one CTA a
    MIN_RUN windows while those fit the card at once (L <= 2^18 on 132
    SMs of four CTAs or more)."""
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    n_words, grid = L // 16, (L + MIN_RUN - 1) // MIN_RUN
    for b in range(grid):
        start = n_words * b // grid * 16
        stop = n_words * (b + 1) // grid * 16
        for base in range(start, stop, TILE):
            for edge in (base, min(base + TILE, stop)):
                for d in (-1, 0, 1, HALO - 1, HALO):
                    if 0 <= edge + d < L:
                        codes[edge + d] = 255
    return codes


def _pattern_wire(pattern, L, dev):
    """Wires of the kernel's edges: "edges" (_edge_codes), "poly-G"
    (the all-ones k-mer everywhere), "word-edges" (exceptions on the
    first and last code of packed words), "twice-floor" (an exception
    list twice kmer.pack_codes_2bit's L/64 floor)."""
    rng = np.random.default_rng(L)
    if pattern == "edges":
        codes = _edge_codes(rng, L)
    elif pattern == "poly-G":
        codes = np.full(L, 3, np.uint8)
        codes[[TILE - 1, L // 2 + 16]] = 255
        codes[L - 5:] = 255
    elif pattern == "word-edges":
        codes = rng.integers(0, 4, size=L).astype(np.uint8)
        codes[np.arange(15, L, 16 * 37)] = 255
        codes[np.arange(16, L, 16 * 41)] = 255
    else:
        codes = rng.integers(0, 4, size=L).astype(np.uint8)
        codes[rng.choice(L, size=(L >> 6) + 40, replace=False)] = 255
    packed2, exc, n_real = km.pack_codes_2bit(codes)
    if pattern == "twice-floor":
        assert len(exc) == 2 * (L >> 6)
    return (torch.from_numpy(packed2.view(np.int32)).to(dev),
            torch.from_numpy(exc).to(dev), n_real)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [1, 16, 21, 32, 33, 48, 64])
@pytest.mark.parametrize("pattern,L", [("edges", 5 * 2048 + 48),
                                       ("edges", (1 << 16) + 48),
                                       ("poly-G", (1 << 16) + 48),
                                       ("word-edges", 1 << 16),
                                       ("twice-floor", 1 << 16)])
def test_kernel_edges_match_plain(cuda, k, mode, pattern, L):
    p, e, n_real = _pattern_wire(pattern, L, cuda)
    got = extract_cuda.extract_kmers_packed(p, e, n_real, k, mode)
    want = ext.extract_kmers_packed(p, e, n_real, k, mode)
    assert torch.equal(got[-1], want[-1])
    v = want[-1]
    assert v.any()
    for g, w in zip(got[:-1], want[:-1]):
        assert torch.equal(g[v], w[v])


@pytest.mark.parametrize("k,mode", [(21, "canonical"), (64, "both")])
def test_kernel_allocates_only_its_outputs(cuda, k, mode):
    p, e, n_real = _wire(9, 1 << 16, cuda)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = extract_cuda.extract_kmers_packed(p, e, n_real, k, mode)
    torch.cuda.synchronize()
    outs = sum(-(-t.untyped_storage().nbytes() // 512) * 512 for t in got)
    assert torch.cuda.max_memory_allocated() - before == outs


def test_kernel_rejects_bad_input(cuda):
    p, e, n_real = _wire(1, 4096, cuda)
    with pytest.raises(ValueError):
        extract_cuda.extract_kmers_packed(p.long(), e, n_real, 21)
    with pytest.raises(ValueError):
        extract_cuda.extract_kmers_packed(p, e.cpu(), n_real, 21)
    with pytest.raises(ValueError):
        extract_cuda.extract_kmers_packed(p, e, n_real, 65)


@pytest.mark.parametrize("k,mode", [(21, "canonical"), (33, "canonical"),
                                    (16, "forward")])
def test_route_cuda_matches_cpu(cuda, k, mode):
    chunk = 1 << 15
    plan = accum.plan_route(chunk, k, 1 << 16)
    cfg = (k, km.num_planes(k), mode, plan["B"], plan["R0"], plan["L0"],
           plan["c"], plan["bits"])
    p, e, n_real = _wire(k, chunk, cuda)
    got = accum.route_chunk_packed(p, e, n_real, cfg)
    want = accum.route_chunk_packed(p.cpu(), e.cpu(), n_real, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _rows(seed, R, L, lo=-(1 << 31), hi=1 << 31):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, size=(R, L),
                                         dtype=np.int64).astype(np.int32))


def _pattern_rows(seed, R, L, span):
    """Random int32 rows in [-span, span), or every entry equal, or each
    row strictly descending from INT32_MAX (the value of the kernel's
    virtual pads)."""
    if span == "equal":
        return torch.full((R, L), -3, dtype=torch.int32)
    if span == "descending":
        top = (1 << 31) - 1
        return torch.arange(top, top - L, -1,
                            dtype=torch.int64).to(torch.int32).repeat(R, 1)
    return _rows(seed, R, L, -span, span)


@pytest.mark.parametrize("R,L", [(3, 1), (5, 7), (64, 2048), (4, 3000),
                                 (8, rowsort.MAX_ROW), (6, 33), (5, 2047),
                                 (4, 3072), (3, 4097), (2, 8191)])
@pytest.mark.parametrize("span", [1 << 31, 5, "equal", "descending"])
def test_bitonic_rows_matches_plain(cuda, R, L, span):
    seed = R * L + (span if isinstance(span, int) else 0)
    x = _pattern_rows(seed, R, L, span).to(cuda)
    before = rowsort.LAUNCHES
    got = rowsort.bitonic_rows(x)
    torch.cuda.synchronize()
    assert rowsort.LAUNCHES == before + 1
    assert torch.equal(got, rowsort.bitonic_rows_plain(x))


@pytest.mark.parametrize("R,L", [(2, 1), (64, 2048), (7, 999), (8, 5120),
                                 (4, rowsort.MAX_ROW), (1, 2), (1, 3),
                                 (3, 7), (5, 33), (2, rowsort.MAX_ROW - 1),
                                 (1 << 13, 2048)])
def test_pass_floor_matches_plain(cuda, R, L):
    x = _rows(R + L, R, L).to(cuda)
    before = rowsort.PASS_FLOOR_LAUNCHES
    got = rowsort.pass_floor(x)
    torch.cuda.synchronize()
    assert rowsort.PASS_FLOOR_LAUNCHES == before + 1
    assert torch.equal(got, rowsort.pass_floor_plain(x))


@pytest.mark.parametrize("R,L", [(5, 7), (3, 999), (4, 2047), (9, 2046),
                                 (4, 2050), (2, rowsort.MAX_ROW - 1)])
def test_pass_floor_misaligned_view(cuda, R, L):
    """x = big[1:] starts L * 4 bytes into its storage: at an odd word
    for odd L, at 8 bytes past 16 for L = 2 mod 4."""
    big = _rows(R * L, R + 1, L).to(cuda)
    x = big[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 == (4 * L) % 16
    before = rowsort.PASS_FLOOR_LAUNCHES
    got = rowsort.pass_floor(x)
    torch.cuda.synchronize()
    assert rowsort.PASS_FLOOR_LAUNCHES == before + 1
    assert torch.equal(got, rowsort.pass_floor_plain(x))


@pytest.mark.parametrize("passes", [0, 1, 2, 65])
@pytest.mark.parametrize("R,L,xo,oo", [
    (64, 2048, 0, 0), (3, 2048, 1, 0), (3, 2048, 2, 0), (3, 2048, 0, 1),
    (3, 2048, 3, 2), (5, 2046, 2, 2), (1, 2, 1, 3), (1, 2, 0, 0),
    (2, 1, 1, 1), (5, 999, 1, 2), (4, rowsort.MAX_ROW, 2, 1),
    (3, rowsort.MAX_ROW - 1, 3, 0)])
def test_pass_floor_entry_point(cuda, passes, R, L, xo, oo):
    """The C entry point with the input and the output at word offsets
    xo and oo of their storage: 0 passes copy the input, any other count
    gives the plain result; nothing outside the output is written."""
    n = R * L
    xs = _rows(n + passes, 1, n + 4).to(cuda).view(-1)
    x = xs[xo:xo + n].view(R, L)
    os_ = torch.full((n + 4,), -7, dtype=torch.int32, device=cuda)
    out = os_[oo:oo + n].view(R, L)
    rc = rowsort._lib().mt_pass_floor(
        x.data_ptr(), out.data_ptr(), R, L, passes,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(out, x if passes == 0 else rowsort.pass_floor_plain(x))
    assert (os_[:oo] == -7).all() and (os_[oo + n:] == -7).all()
    assert rowsort._lib().mt_pass_floor(
        x.data_ptr(), out.data_ptr(), R, L, -1,
        torch.cuda.current_stream().cuda_stream) != 0


def _set_rows(seed, R, L, k):
    """Rows of set-op entries: keys drawn from a small pool (so ties
    across inputs are common), the sentinel as padding, values and
    input ids as payloads."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-(1 << 63), (1 << 63) - 1, size=(max(4, L // 3),
                                                         mw.num_words(k)))
    key = pool[rng.integers(0, len(pool), size=(R, L))]
    sent = np.array(mw.sentinel_words(k), np.int64)
    key[rng.random((R, L)) < 0.1] = sent
    if mw.num_words(k) == 1:
        key = key[..., 0]
    vals = rng.integers(0, 1 << 32, size=(R, L))
    ids = rng.integers(0, 3, size=(R, L)).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (key, vals,
                                                                ids)]


def _pattern_set_rows(seed, R, L, k, pattern):
    """Set-op rows of one pattern: "random" (_set_rows), "equal" (every
    key the same), "descending" (distinct keys, each row reversed), or
    "sentinel" (as the packer builds them: the all-ones k-mer in both
    inputs, input ids 0 and 1, then sentinel padding with value 0 and
    id 2; at k = 16 and 32 the two have the same words)."""
    if pattern == "random":
        return _set_rows(seed, R, L, k)
    rng = np.random.default_rng(seed)
    nw = mw.num_words(k)
    vals = rng.integers(0, 1 << 32, size=(R, L))
    ids = rng.integers(0, 3, size=(R, L)).astype(np.int32)
    if pattern == "equal":
        key = np.full((R, L, nw), -5, np.int64)
    elif pattern == "descending":
        key = np.zeros((R, L, nw), np.int64)
        key[..., -1] = np.arange(L, 0, -1) * 977 - (1 << 40)
    else:
        ones = (1 << (2 * k)) - 1
        allones = mw.from_hilo(np.array([ones >> 64], np.uint64),
                               np.array([ones & ((1 << 64) - 1)], np.uint64),
                               k)[0]
        pool = rng.integers(-(1 << 63), (1 << 63) - 1, size=(L, nw))
        key = np.repeat(pool[None], R, axis=0)
        key[:, rng.random(L) < 0.3] = allones
        n_real = (L * 2) // 3
        key[:, n_real:] = np.array(mw.sentinel_words(k), np.int64)
        vals[:, n_real:] = 0
        ids[:, :n_real] = rng.integers(0, 2, size=(R, n_real))
        ids[:, n_real:] = 2
    if nw == 1:
        key = key[..., 0]
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (key, vals,
                                                                ids)]


_SORT_ROW_CASES = [
    pytest.param(R, L, "random", id=f"{R}-{L}")
    for R, L in [(3, 1), (5, 300), (16, 5120), (4, rowsort.MAX_ROW),
                 (6, 33), (5, 2047), (4, 3072), (3, 4097), (2, 8191)]
] + [
    pytest.param(R, L, pattern, id=f"{R}-{L}-{pattern}")
    for pattern in ("equal", "descending", "sentinel")
    for R, L in [(6, 33), (4, 3072), (2, 8191)]
]


@pytest.mark.parametrize("k", [16, 21, 32, 33, 64])
@pytest.mark.parametrize("R,L,pattern", _SORT_ROW_CASES)
def test_sort_rows_matches_plain(cuda, k, R, L, pattern):
    key, vals, ids = (t.to(cuda) for t in _pattern_set_rows(
        k * L, R, L, k, pattern))
    before = rowsort.LAUNCHES
    got = rowsort.sort_rows(key, vals, ids, k)
    torch.cuda.synchronize()
    assert rowsort.LAUNCHES == before + 1
    want = rowsort.sort_rows_plain(key, vals, ids, k)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if pattern == "equal":              # the identity permutation
        assert torch.equal(got[1], vals) and torch.equal(got[2], ids)


def test_rowsort_rejects_bad_input(cuda):
    x = _rows(1, 2, rowsort.MAX_ROW + 2).to(cuda)
    with pytest.raises(ValueError):
        rowsort.bitonic_rows(x)
    with pytest.raises(ValueError):
        rowsort.bitonic_rows(x[:, :64].long())
    key, vals, ids = (t.to(cuda) for t in _set_rows(2, 2, 64, 21))
    with pytest.raises(ValueError):
        rowsort.sort_rows(key, vals, ids.long(), 21)
    with pytest.raises(ValueError):
        rowsort.sort_rows(key, vals.cpu(), ids, 21)


@pytest.mark.parametrize("op,m", [("union-sum", 2), ("intersect", 3),
                                  ("subtract", 2), ("greater-than", 1)])
def test_merge_rows_cuda_matches_cpu(cuda, op, m):
    k = 21
    key, vals, ids = _set_rows(7, 8, 1024, k)
    ids = ids % m
    got = setops.merge_op(key.to(cuda), vals.to(cuda), ids.to(cuda), op, m,
                          1, k)
    want = setops.merge_op(key, vals, ids, op, m, 1, k)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("acc", ["1", "0"])
def test_count_cuda_matches_cpu(cuda, tmp_path, monkeypatch, acc):
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", acc)
    rng = np.random.default_rng(5)
    fa = str(tmp_path / "in.fa")
    with open(fa, "w") as f:
        for i in range(300):
            s = "".join("ACTG"[c] for c in rng.integers(0, 4, 400))
            f.write(f">s{i}\n{s}\n{'G' * 40 if i % 50 == 0 else ''}\n")
    got = counter.count_to_arrays([fa], 21, chunk_len=1 << 14,
                                  device="cuda")
    want = counter.count_to_arrays([fa], 21, chunk_len=1 << 14,
                                   device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------- downloads, batches, suffix, plan

def _fed(k, codes, dev, chunk=1 << 14, exp=1 << 14):
    acc = counter.DeviceAccCounter(k, "forward", chunk, exp, device=dev)
    for s in range(0, len(codes), chunk):
        acc.add_codes(codes[s:s + chunk])
    return acc


def _download_pageable_int64(acc, decode=True):
    """The accumulator's keys and int64 counts, each with `.cpu()` into
    pageable host memory: the plainest download; decoded, or with decode
    False as the key words and u32 counts the native finalize reads."""
    lmax = acc.download_lmax()
    keys = acc._acc[0][:, :lmax].reshape((-1,) + acc._tail()).cpu().numpy()
    counts = acc._acc[1][:, :lmax].reshape(-1).cpu().numpy()
    keepm = counts > 0
    if not decode:
        return keys[keepm], counts[keepm].astype(np.uint32)
    hi, lo = mw.to_hilo(keys[keepm], acc.k)
    return hi, lo, counts[keepm].astype(np.uint64)


@pytest.mark.parametrize("k", [10, 16, 21, 32, 33])
def test_downloads_equal_on_card(cuda, monkeypatch, k):
    """The pinned dense download finalizes to what a pageable int64
    download gives, and to the CPU's result, through the native tail and
    through numpy's (MERYL_TPU_NO_NATIVE)."""
    monkeypatch.setattr(counter, "PIN_MIN_BYTES", 1 << 12)  # pin here too
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=1 << 17).astype(np.uint8)
    codes[rng.integers(0, len(codes), size=200)] = 255
    codes[5000:5000 + 3 * k] = 3           # the all-ones k-mer
    codes[7000:7000 + 21 * 900] = np.tile(codes[7000:7021], 900)  # hot
    outs = {}
    for tail in ("native", "numpy"):
        if tail == "numpy":
            monkeypatch.setenv("MERYL_TPU_NO_NATIVE", "1")
        else:
            monkeypatch.delenv("MERYL_TPU_NO_NATIVE", raising=False)
        for arm in ("pageable", "dense", "cpu"):
            acc = _fed(k, codes, "cpu" if arm == "cpu" else cuda)
            if arm == "pageable":
                acc.download = lambda decode=True, acc=acc: \
                    _download_pageable_int64(acc, decode)
            before = counter.FINALIZE_STATS[tail]
            outs[tail, arm] = acc.finalize()
            assert counter.FINALIZE_STATS[tail] == before + 1
    for key, out in outs.items():
        for a, b in zip(out, outs["numpy", "pageable"]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert len(outs["numpy", "cpu"][2]) > 1000


@pytest.mark.parametrize("n", [10, (1 << 17) - 1, 1 << 17, (1 << 20) + 3])
def test_to_host_small_and_pinned(cuda, n):
    x = torch.arange(n, dtype=torch.int64, device=cuda) * 3 - 7
    np.testing.assert_array_equal(counter._to_host(x), x.cpu().numpy())
    np.testing.assert_array_equal(counter._to_host(x.cpu()),
                                  x.cpu().numpy())


def _reads_file(tmp_path, n=400, ln=400, seed=5):
    rng = np.random.default_rng(seed)
    fa = str(tmp_path / "in.fa")
    with open(fa, "w") as f:
        for i in range(n):
            s = "".join("ACTG"[c] for c in rng.integers(0, 4, ln))
            f.write(f">s{i}\n{s}\n{'G' * 40 if i % 50 == 0 else ''}\n")
    return fa


@pytest.mark.parametrize("acc", ["1", "0", "auto"])
def test_batched_cuda_matches_plain(cuda, tmp_path, monkeypatch, acc):
    """memory= through count_to_db on the card: several batches, their
    union-sum through the row-sort kernel, equal to the unbatched
    count."""
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", acc)
    fa = _reads_file(tmp_path)
    plain = counter.count_to_db([fa], str(tmp_path / "p.meryl"), 21,
                                chunk_len=1 << 14, device="cuda")
    before = extract_cuda.LAUNCHES, rowsort.LAUNCHES
    db = counter.count_to_db([fa], str(tmp_path / "b.meryl"), 21,
                             chunk_len=1 << 14, memory_gb=0.0008,
                             device="cuda")
    st = counter.LAST_BATCH_STATS
    assert st["batches"] >= 3 and len(st["counted"]) == st["batches"]
    assert all(b["device_acc"] == (acc != "0") for b in st["counted"])
    assert extract_cuda.LAUNCHES - before[0] >= st["chunks"]
    assert rowsort.LAUNCHES > before[1]
    for a, b in zip(db.load_all(), plain.load_all()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,mode,suffix", [(21, "canonical", "ACG"),
                                           (33, "forward", "T"),
                                           (21, "canonical", None)])
def test_suffix_and_compact_cuda_match_cpu(cuda, tmp_path, monkeypatch, k,
                                           mode, suffix):
    """The host sort path, with and without count-suffix, on the card."""
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", "0")
    fa = _reads_file(tmp_path, n=100)
    kw = dict(mode=mode, chunk_len=1 << 14, count_suffix=suffix)
    got = counter.count_to_arrays([fa], k, device="cuda", **kw)
    want = counter.count_to_arrays([fa], k, device="cpu", **kw)
    assert len(want[2])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_plan_reports_the_cards_memory(cuda, tmp_path, monkeypatch):
    monkeypatch.delenv("MERYL_TPU_HBM_GB", raising=False)
    fa = _reads_file(tmp_path, n=10)
    plan = counter.configure_counting([fa], 21)
    total = torch.cuda.get_device_properties(0).total_memory
    assert plan["hbm_gb"] == total / 1e9
    assert plan["device_chunk_hbm_bytes"] <= total * 0.5
    assert plan["devices"] == 1 and plan["sharded"] is False


# ---- lookup on the card against the CPU path

class _ArraysDB:
    def __init__(self, k, hi, lo, counts, mode="canonical"):
        self.k, self.mode = k, mode
        self._t = (hi, lo, counts)

    def load_all(self):
        return self._t


def _lookup_table(k, n, seed):
    rng = np.random.default_rng(seed)
    bits = 2 * k
    lo = rng.integers(0, 1 << min(bits, 63), size=n, dtype=np.uint64)
    hi = rng.integers(0, 1 << (bits - 64), size=n, dtype=np.uint64) \
        if bits > 64 else np.zeros(n, np.uint64)
    ones = (1 << bits) - 1                       # the all-ones k-mer
    hi = np.append(hi, np.uint64(ones >> 64))
    lo = np.append(lo, np.uint64(ones & ((1 << 64) - 1)))
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    keep = np.ones(len(lo), bool)
    keep[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    hi, lo = hi[keep], lo[keep]
    c = rng.integers(1, 1000, size=len(lo)).astype(np.uint32)
    c[::31] = np.uint32(km.VALUE_MAX)
    q = np.concatenate([np.arange(len(lo)), rng.integers(0, len(lo), 3000)])
    qhi = np.concatenate([hi[q], rng.integers(0, 4, 2000, dtype=np.uint64)])
    qlo = np.concatenate([lo[q], rng.integers(0, 1 << 40, 2000,
                                              dtype=np.uint64)])
    if bits <= 64:                     # queries are k-mers: 2k bits
        qhi[:] = 0
        qlo &= np.uint64((1 << bits) - 1)
    return (hi, lo, c), mw.from_hilo(qhi, qlo, k), rng.random(len(qlo)) < .9


@pytest.mark.parametrize("regime", ["bsearch", "grid"])
@pytest.mark.parametrize("k", [16, 21, 32, 33, 64])
def test_lookup_regimes_cuda_match_cpu(cuda, monkeypatch, k, regime):
    """The binary search on a device-resident table, and the grid join
    on a table that MERYL_TPU_LOOKUP_DEVICE_GB keeps on the host."""
    from meryl_tpu_torch import lookup

    arrays, key, valid = _lookup_table(k, 20000, k)
    if regime == "grid":
        monkeypatch.setenv("MERYL_TPU_LOOKUP_DEVICE_GB", "1e-6")
    out = []
    for dev in ("cpu", cuda):
        t = lookup.ExactLookup(_ArraysDB(k, *arrays), device=dev)
        assert t._device_resident == (regime == "bsearch")
        if regime == "grid":
            t.JOIN_MIN_Q, t.BACJ_SLAB = 1, 1 << 14
        kt = torch.from_numpy(key).to(dev)
        vt = torch.from_numpy(valid).to(dev)
        out.append(t.values_bulk(kt, vt))
        np.testing.assert_array_equal(t.values_bulk(kt, vt, True),
                                      (out[-1] > 0).astype(np.uint32))
    np.testing.assert_array_equal(out[0], out[1])
    assert (out[1] == km.VALUE_MAX).any()


@pytest.mark.parametrize("mode", ["-bed", "-bed-runs", "-wig-count",
                                  "-wig-depth", "-existence"])
def test_lookup_cli_cuda_matches_cpu(cuda, tmp_path, mode):
    from meryl_tpu_torch import cli, lookup_cli

    rng = np.random.default_rng(4)
    g = "".join("ACGT"[c] for c in rng.integers(0, 4, 20000))
    fa = str(tmp_path / "g.fa")
    with open(fa, "w") as f:
        f.write(f">g\n{g}\n")
    q = str(tmp_path / "q.fa")
    with open(q, "w") as f:
        f.write(f">q\n{g[5000:15000]}NN{g[:100000 % 20000]}"
                + "".join("ACGT"[c] for c in rng.integers(0, 4, 80000))
                + "\n>s\nACGTAC\n")
    db = str(tmp_path / "g.meryl")
    assert cli.main(["count", "k=21", fa, "output", db, "device=cpu"]) == 0
    outs = []
    for dev in ("cpu", "cuda"):
        out = str(tmp_path / f"{dev}.txt")
        before = extract_cuda.LAUNCHES
        assert lookup_cli.main([mode, "-sequence", q, "-mers", db,
                                "-output", out, "-device", dev]) == 0
        if dev == "cuda":
            assert extract_cuda.LAUNCHES > before
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and outs[0]


def test_position_lookup_cuda_matches_cpu(cuda, tmp_path):
    from meryl_tpu_torch import cli
    from meryl_tpu_torch.tools import position_lookup

    rng = np.random.default_rng(6)
    g = "".join("ACGT"[c] for c in rng.integers(0, 4, 30000))
    fa = str(tmp_path / "g.fa")
    with open(fa, "w") as f:
        f.write(f">g\n{g}\n")
    reads = str(tmp_path / "r.fa")
    with open(reads, "w") as f:
        for i in range(200):
            p = int(rng.integers(0, 29000))
            f.write(f">r{i}\n{g[p:p + 150]}\n")
    db = str(tmp_path / "g.meryl")
    assert cli.main(["count", "k=21", fa, "output", db, "device=cpu"]) == 0
    outs = []
    for dev in ("cpu", "cuda"):
        names = [str(tmp_path / f"{dev}.{x}") for x in ("hpq", "mpb", "qpb")]
        assert position_lookup.main(["-m", db, "-s", fa, "-hpq", names[0],
                                     "-mpb", names[1], "-qpb", names[2],
                                     "-device", dev, reads]) == 0
        outs.append([open(n, "rb").read() for n in names])
    assert outs[0] == outs[1] and all(outs[0])


# ----------------------------------------------------------------- meryl2

@pytest.fixture
def meryl2_inputs(tmp_path):
    """Two reads files sharing most of one genome, at k=16 with poly-G
    (the all-ones k-mer) in both."""
    rng = np.random.default_rng(9)
    g = "".join("ACGT"[c] for c in rng.integers(0, 4, 60000))
    paths = []
    for i, (a, b) in enumerate(((0, 40000), (15000, 60000))):
        fa = str(tmp_path / f"r{i}.fa")
        with open(fa, "w") as f:
            f.write(f">s\n{g[a:b]}\n>p\n{'G' * (30 + i)}\n")
        paths.append(fa)
    return paths


MERYL2_CMDS = [
    ["union-sum"],
    ["intersect", "assign:value=min", "assign:label=xor"],
    ["union", "assign:value=mul#268435456", "assign:label=rotate-left#33",
     "select:bases:gc:>=7", "or", "not", "select:input:@2"],
    ["union-max", "select:value:>=2", "and", "select:label:<3"],
]


@pytest.mark.parametrize("rowpack", [1, 1 << 60])
@pytest.mark.parametrize("cmd", MERYL2_CMDS, ids=lambda c: c[0])
def test_meryl2_cuda_matches_cpu(cuda, tmp_path, monkeypatch, meryl2_inputs,
                                 cmd, rowpack):
    """meryl2-torch on the card equals it on the CPU: labelled counts
    (the extraction kernel) and an action over them, row-packed (the
    bitonic row sort) or flat; DB files byte-equal."""
    from meryl_tpu_torch.v2 import cli as v2

    monkeypatch.setattr(v2.Evaluator, "ROWPACK_MIN", rowpack)
    outs = []
    for dev in ("cpu", "cuda"):
        dbs = []
        for i, fa in enumerate(meryl2_inputs):
            db = str(tmp_path / f"{dev}{i}.meryl")
            before = extract_cuda.LAUNCHES
            assert v2.main(["-k", "16", "count", f"label=#{i + 1}", fa,
                            f"output:database={db}", f"device={dev}"]) == 0
            assert (extract_cuda.LAUNCHES > before) == (dev == "cuda")
            dbs.append(db)
        out = str(tmp_path / f"{dev}_out.meryl")
        before = rowsort.LAUNCHES
        assert v2.main(cmd + dbs + [f"output:database={out}",
                                    f"device={dev}"]) == 0
        assert (rowsort.LAUNCHES > before) == (dev == "cuda" and rowpack == 1)
        outs.append({n: open(os.path.join(out, n), "rb").read()
                     for n in sorted(os.listdir(out))})
    assert outs[0] == outs[1]


@pytest.mark.parametrize("k", [16, 21, 33])
@pytest.mark.parametrize("m", [2, 7])
def test_meryl2_engine_cuda_matches_cpu(cuda, k, m):
    """merge_action on the card (row-packed: the bitonic kernel; m = 7:
    the flat segmented path) against the CPU, every output."""
    from meryl_tpu_torch.optree import BucketEvaluator
    from meryl_tpu_torch.v2 import engine

    rng = np.random.default_rng(k * m)
    bits = 2 * k
    ins, halves = [], []
    for _ in range(m):
        lo = rng.integers(0, 1 << min(bits, 63), size=40000,
                          dtype=np.uint64)
        if bits % 32 == 0:
            lo[0] = np.uint64((1 << bits) - 1)   # the all-ones k-mer
        lo = np.unique(lo)
        n = len(lo)
        c = rng.integers(1, 1 << 32, size=n, dtype=np.uint64)
        ins.append((np.zeros(n, np.uint64), lo, c.astype(np.uint32)))
        lab = rng.integers(0, 1 << 62, size=n, dtype=np.int64)
        halves.append([lab & 0xFFFFFFFF, lab >> 32])
    ev = BucketEvaluator(k, "cpu")
    pack = ev._pack_rows if m <= 6 else ev._pack_flat
    keys, values, ids, (llo, lhi) = pack(ins, m, extras=halves)
    sel = engine.Selector(((engine.SelectorTerm(
        "bases", "ge", ("letters", "CG"), ("const", k // 2)),),))
    res = []
    for dev in ("cpu", "cuda"):
        before = rowsort.LAUNCHES
        got = engine.merge_action(
            *(torch.from_numpy(x).to(dev) for x in (keys, values, llo, lhi,
                                                     ids)),
            m, k, engine.Assign("mul", 3, True), engine.Assign("heaviest"),
            sel, 3, 0, 0)
        assert (rowsort.LAUNCHES > before) == (dev == "cuda" and m <= 6)
        res.append([x.cpu() for x in got])
    for a, b in zip(*res):
        assert torch.equal(a, b)


# ------------------------------------------------------- multi-GPU path

@pytest.mark.parametrize("k", [21, 33])
def test_sharded_count_nccl_matches_count(cuda, tmp_path, monkeypatch, k):
    """MERYL_TPU_SHARDED=1 on the card inside a 1-rank NCCL group (the
    path of a launcher job's rank) gives count_to_arrays' arrays; the
    extraction kernel launches once a step and the hatches run."""
    import torch.distributed as dist

    from meryl_tpu_torch.parallel import shard_count
    rng = np.random.default_rng(6)
    fa = str(tmp_path / "in.fa")
    with open(fa, "w") as f:
        f.write(">polyA\n" + "A" * 3000 + "\n")
        for i in range(300):
            s = "".join("ACTG"[c] for c in rng.integers(0, 4, 400))
            f.write(f">s{i}\n{s}\n")
    monkeypatch.setenv("MERYL_TPU_SHARD_CHUNK", str(1 << 14))
    monkeypatch.setenv("MERYL_TPU_SHARD_ACC_CAP", str(1 << 16))
    monkeypatch.setenv("MERYL_TPU_SHARDED", "1")
    before = extract_cuda.LAUNCHES
    with shard_count.one_rank_group("cuda"):
        assert dist.get_backend() == "nccl"
        got = counter.count_to_arrays([fa], k, device="cuda")
    stats = dict(shard_count.LAST_SHARD_STATS)
    assert not dist.is_initialized()
    assert extract_cuda.LAUNCHES - before >= stats["steps"] >= 1
    assert stats["recount_chunks"] >= 1 and stats["spills"] >= 1
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    want = counter.count_to_arrays([fa], k, device="cuda")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [21, 33])
def test_local_members_on_one_card_match_count(cuda, tmp_path, monkeypatch,
                                              k):
    """Two members of one process on cuda:0 (a LocalGroup, one thread
    each) give count_to_arrays' arrays; each launches the extraction
    kernel once a step, and the hatches run."""
    import torch.distributed as dist

    from meryl_tpu_torch.parallel import shard_count
    rng = np.random.default_rng(7)
    fa = str(tmp_path / "in.fa")
    with open(fa, "w") as f:
        f.write(">polyA\n" + "A" * 3000 + "\n")
        for i in range(300):
            s = "".join("ACTG"[c] for c in rng.integers(0, 4, 400))
            f.write(f">s{i}\n{s}\n")
    monkeypatch.setenv("MERYL_TPU_SHARD_ACC_CAP", str(1 << 15))
    before = extract_cuda.LAUNCHES
    got = counter.count_to_arrays_sharded([fa], k, chunk_len=1 << 14,
                                          devices=["cuda:0"] * 2)
    stats = dict(shard_count.LAST_SHARD_STATS)
    assert not dist.is_initialized()
    assert extract_cuda.LAUNCHES - before >= 2 * stats["steps"] >= 2
    assert stats["recount_chunks"] >= 1 and stats["spills"] >= 1
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    want = counter.count_to_arrays([fa], k, device="cuda")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _collectives(m, n):
    """Every collective a ShardedCounter makes, on member m's device;
    -> the results on the host."""
    r, dev = m.rank, m.device
    inp = torch.arange(2 * n * 3, dtype=torch.int64, device=dev).reshape(
        2 * n, 3) + 1000 * r
    wide = torch.arange(n * 4 * 2, dtype=torch.int64, device=dev).reshape(
        n, 4, 2) - 77 * r
    outs = [torch.empty_like(inp), torch.empty_like(wide)]
    m.all_to_all_single(outs[0], inp)
    m.all_to_all_single(outs[1], wide)
    from meryl_tpu_torch.parallel import local_group as lg
    red = [torch.tensor([r, -r, 7], dtype=torch.int64, device=dev)
           for _ in range(3)]
    for op, t in zip((lg.SUM, lg.MAX, lg.MIN), red):
        m.all_reduce(t, op)
    got = [torch.zeros((2, 2), dtype=torch.int64, device=dev)
           for _ in range(n)]
    m.all_gather(got, torch.full((2, 2), r, dtype=torch.int64, device=dev))
    m.barrier()
    return [t.cpu() for t in outs + red + got]


def test_job_group_on_one_card_matches_local_group(cuda):
    """A JobGroup of 4 members on cuda:0 over a 1-rank NCCL group (one
    NCCL rank, four threads) gives the LocalGroup's results."""
    import torch.distributed as dist

    from meryl_tpu_torch.parallel import local_group as lg
    from meryl_tpu_torch.parallel import shard_count
    n = 4
    want = lg.LocalGroup(["cuda:0"] * n).run(lambda m: _collectives(m, n))
    with shard_count.one_rank_group("cuda"):
        assert dist.get_backend() == "nccl"
        group = lg.JobGroup(["cuda:0"] * n)
        got = group.run(lambda m: _collectives(m, n))
    assert not dist.is_initialized()
    assert [m.exchange_grids for m in group.members] == [2 * n] * n
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)


@pytest.mark.parametrize("k", [21, 33])
def test_job_members_on_one_card_match_count(cuda, tmp_path, monkeypatch,
                                            k):
    """count_to_arrays_multihost over 4 members on cuda:0 in a 1-rank
    NCCL group gives count_to_arrays' arrays; each member launches the
    extraction kernel once a step, and the hatches run."""
    import torch.distributed as dist

    from meryl_tpu_torch.parallel import multihost, shard_count
    rng = np.random.default_rng(8)
    fa = str(tmp_path / "in.fa")
    with open(fa, "w") as f:
        f.write(">polyA\n" + "A" * 3000 + "\n")
        for i in range(300):
            s = "".join("ACTG"[c] for c in rng.integers(0, 4, 400))
            f.write(f">s{i}\n{s}\n")
    monkeypatch.setenv("MERYL_TPU_SHARD_ACC_CAP", str(1 << 15))
    before = extract_cuda.LAUNCHES
    with shard_count.one_rank_group("cuda"):
        parts = multihost.count_to_arrays_multihost(
            [fa], k, chunk_len=1 << 14, device="cuda",
            devices=["cuda:0"] * 4)
    stats = dict(shard_count.LAST_SHARD_STATS)
    assert not dist.is_initialized()
    assert extract_cuda.LAUNCHES - before >= 4 * stats["steps"] >= 4
    assert stats["recount_chunks"] >= 1 and stats["spills"] >= 1
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    want = counter.count_to_arrays([fa], k, device="cuda")
    for i, w in zip((1, 2, 3), want):
        np.testing.assert_array_equal(
            np.concatenate([p[i] for p in parts]), w)
