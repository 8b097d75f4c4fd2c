"""The accumulator's dense download (DeviceAccCounter.download: 32-bit
counts and the key words in one buffer) against meryl_tpu's download
and a brute force.  The same seeded numpy codes feed both packages'
DeviceAccCounter, or the same accumulator is planted in both; the
decoded arrays must be equal exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meryl_tpu import counter as ref_ctr
from meryl_tpu import kmer as km
from meryl_tpu_torch import counter as ctr
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


def _hot_codes():
    """A few k-mers repeated far past a small count field."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, 4, size=1 << 13).astype(np.uint8)
    return np.concatenate([base, np.tile(base[:21], 400), base[::-1]])


def _random_codes(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=n).astype(np.uint8)


def _allones_codes(k):
    """Random codes with one poly-G run: the all-ones k-mer."""
    codes = _random_codes(k, 1 << 13)
    codes[500:500 + 3 * k] = 3
    codes[499] = codes[500 + 3 * k] = 9
    return codes


STREAMS = {
    "allones-16": (16, lambda: _allones_codes(16)),
    "allones-32": (32, lambda: _allones_codes(32)),
    "hot": (21, _hot_codes),
    "k32": (32, lambda: _random_codes(4, 1 << 14)),
    "k33": (33, lambda: _random_codes(5, 1 << 13)),
    "k10": (10, lambda: _random_codes(2, 1 << 14)),
    "k21": (21, lambda: _random_codes(2, 1 << 14)),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_dense_download_stream_matches_reference(name):
    """A fed counter's finalize through the dense download: equal to the
    reference's and to the brute force; 8 B a key word and 4 B a count
    of each unique in one fetch; the all-ones k-mer (poly-G) counted by
    the scalar outside the accumulator; hot counts exact."""
    k, make = STREAMS[name]
    codes = make()
    c, r = _counters(k=k)
    _feed(c, codes)
    _feed(r, codes)
    got = c.finalize()
    for a, b in zip(got, r.finalize()):
        np.testing.assert_array_equal(a, b)
    want = _brute(codes, k, c.chunk_len)
    assert _as_dict(*got) == want
    if name.startswith("allones"):
        assert want[(1 << (2 * k)) - 1] == 2 * k + 1
    elif name != "hot":   # every unique came down with the accumulator
        assert c.wire_d2h_bytes == len(got[2]) * (8 * mw.num_words(k) + 4)


# ------------------------------------ a planted accumulator, direct

def _acc_rows(k, B=8, La=256, seed=6, count_exc_rows=range(8)):
    """Random sorted accumulator rows in the reference's format (P
    planes), with an empty row, a dense and a sparse row, wide gaps,
    and in `count_exc_rows` two large counts (past 2^31, and saturated)
    -> (planes, counts, want list)."""
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
        if r != 5:  # row 5 stays narrow
            gaps[n // 2] = np.uint64(1) << np.uint64(big)   # a wide gap
        if r == 6 and P == 2:
            gaps[n // 3] = np.uint64(1) << np.uint64(35)    # past 32 bits
        keys = np.cumsum(gaps) + np.uint64(r * span)
        cts = rng.integers(1, 1 << 9, size=n).astype(np.uint32)
        if r in count_exc_rows:
            cts[1] = np.uint32((1 << 31) + 7)
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


# (k, seed, rows with large counts): three widths at seed 6, four at
# seed 11, and two with large counts in only two rows
PLANTED = [(12, 6, range(8)), (21, 6, range(8)), (32, 6, range(8)),
           (21, 11, range(8)), (16, 11, range(8)), (32, 11, range(8)),
           (12, 11, range(8)), (21, 6, (0, 1)), (32, 6, (0, 1))]


@pytest.mark.parametrize("k,seed,rows", PLANTED, ids=[
    f"k{k}-seed{seed}" + ("" if rows == range(8) else "-2rows")
    for k, seed, rows in PLANTED])
def test_download_roundtrip_direct(k, seed, rows):
    """An accumulator planted in a counter decodes to what was planted
    (wide gaps, counts past 2^31, a saturated count, an empty row), as
    the reference's download of the same accumulator does."""
    planes, counts, want = _acc_rows(k, B=8, seed=seed, count_exc_rows=rows)
    c, r = _counters(k=k, exp=1)
    assert c.B == r.B == 8
    c._acc = _port_acc(planes, counts, k)
    r._acc = (tuple(jnp.asarray(p) for p in planes), jnp.asarray(counts))
    for x in (c, r):
        x.La = counts.shape[1]
        x._max_run = int((counts > 0).sum(axis=1).max())
        x._bases_seen = 40_000
    hi, lo, cts = c.download()
    assert cts.dtype == np.uint64 and not hi.any()
    assert list(zip(lo.tolist(), cts.tolist())) == want
    assert c.wire_d2h_bytes == len(want) * (8 * mw.num_words(k) + 4)
    rhi, rlo, rcts = r.finalize()
    np.testing.assert_array_equal(rhi, hi)
    np.testing.assert_array_equal(rlo, lo)
    np.testing.assert_array_equal(rcts.astype(np.uint64), cts)
