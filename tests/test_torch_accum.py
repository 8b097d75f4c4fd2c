"""meryl_tpu_torch routing and merging against meryl_tpu.ops.accum.

The reference runs with the exact integer row map (cfg + ("int",)),
the only map the port has.  The same numpy inputs go to both; all
outputs are integers and must be bit-equal: cells, overflow capture,
per-row overflow counts and the all-ones scalar of the route; keys,
counts and run counts of the merge."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meryl_tpu import kmer as km
from meryl_tpu.ops import accum as ref_accum
from meryl_tpu_torch.ops import accum
from meryl_tpu_torch.ops import extract as text
from meryl_tpu_torch.ops import multiword as mw


def _ref_planes(key: torch.Tensor, k: int, shape):
    """Port key tensor -> tuple of reference planes of `shape`."""
    flat = key.numpy().reshape((-1,) + key.shape[len(shape):])
    return tuple(jnp.asarray(p.reshape(shape))
                 for p in mw.to_planes(flat, k))


def _port_key(planes, k: int) -> torch.Tensor:
    shape = np.asarray(planes[0]).shape
    key = mw.from_planes([np.asarray(p).reshape(-1) for p in planes], k)
    return torch.from_numpy(key.reshape(shape + key.shape[1:]))


def _assert_key_equal(port_key, ref_planes, k):
    shape = np.asarray(ref_planes[0]).shape
    for a, b in zip(_ref_planes(port_key, k, shape), ref_planes):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _cfg(chunk_len, k, mode, exp):
    plan = accum.plan_route(chunk_len, k, exp)
    assert plan == ref_accum.plan_route(chunk_len, k, exp)
    return (k, km.num_planes(k), mode, plan["B"], plan["R0"], plan["L0"],
            plan["c"], plan["bits"])


def _route_both(codes, cfg):
    packed2, exc, n_real = km.pack_codes_2bit(codes)
    ref = ref_accum.route_chunk_packed(
        jnp.asarray(packed2), jnp.asarray(exc), jnp.uint32(n_real),
        cfg + ("int",))
    port = accum.route_chunk_packed(
        torch.from_numpy(packed2.view(np.int32)), torch.from_numpy(exc),
        n_real, cfg)
    return port, ref


def _assert_route_equal(port, ref, k):
    cells, ovf, n_ovf_row, n_allones = port
    _assert_key_equal(cells, ref[0], k)
    _assert_key_equal(ovf, ref[1], k)
    np.testing.assert_array_equal(n_ovf_row.numpy(), np.asarray(ref[2]))
    assert int(n_allones) == int(ref[3])


def _random_codes(seed, n, breakers=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    if breakers:
        codes[rng.integers(0, n, size=n // 150)] = 255
    return codes


@pytest.mark.parametrize("k,mode", [(21, "canonical"), (15, "forward"),
                                    (33, "canonical"), (9, "reverse")])
def test_route_matches_reference(k, mode):
    chunk = 1 << 15
    cfg = _cfg(chunk, k, mode, 1 << 16)
    codes = _random_codes(k, chunk)
    codes[chunk - 300:] = 255  # trailing pad: n_real < chunk
    port, ref = _route_both(codes, cfg)
    _assert_route_equal(port, ref, k)


@pytest.mark.parametrize("k", [16, 32])
def test_route_poly_g_allones(k):
    """Forward poly-G windows are the all-ones k-mer, which aliases the
    sentinel at 2k % 32 == 0: it must leave the cells and count in the
    scalar."""
    chunk = 1 << 13
    cfg = _cfg(chunk, k, "forward", 1 << 12)
    codes = _random_codes(k, chunk)
    codes[499:601] = [255] + [3] * 100 + [255]  # poly-G runs, fenced
    codes[1999:2001 + k] = [255] + [3] * k + [255]
    port, ref = _route_both(codes, cfg)
    _assert_route_equal(port, ref, k)
    assert int(port[3]) == (100 - k + 1) + 1


def test_route_fully_valid_row_capture():
    """A routing row with no invalid windows and one overflowing cell
    (the round-4 phantom-kmer shape): the searchsorted bucket counts
    must be exact, so the capture holds real windows only and matches
    the reference."""
    k = 21
    chunk = 1 << 17
    cfg = _cfg(chunk, k, "canonical", 1 << 17)
    _, _, _, B, _, L0, c, bits = cfg
    rng = np.random.default_rng(7)
    base = rng.integers(0, 4, size=chunk).astype(np.uint8)
    hot = rng.integers(0, 4, size=k).astype(np.uint8)

    def rows_of(codes):
        key, valid = text.extract_kmers(torch.from_numpy(codes), k)
        r = accum.row_from_prefix_int(accum._top_bits(key, k, bits),
                                      bits, B, True)
        return torch.where(valid, r, B).numpy()

    hrow = int(rows_of(np.concatenate([hot, np.full(1, 9, np.uint8)]))[0])
    bg = int((rows_of(base)[:L0] == hrow).sum())
    copies = max(60, c - bg + 120)
    period = np.empty((copies, 2 * k), np.uint8)
    period[:, :k] = hot
    period[:, k:] = rng.integers(0, 4, size=(copies, k))
    base[:period.size] = period.reshape(-1)
    port, ref = _route_both(base, cfg)
    _assert_route_equal(port, ref, k)
    nrow = port[2].numpy()
    assert 0 < nrow.max() <= accum.OVF_CAP
    ovf = port[1]
    for r in np.flatnonzero(nrow):
        assert not mw.is_sentinel(ovf[r, :nrow[r]], k).any()


@pytest.mark.parametrize("bits,B,canonical", itertools.product(
    (1, 10, 14, 16), (1, 8, 1000, 1024), (True, False)))
def test_row_map_matches_reference(bits, B, canonical):
    pref = np.arange(1 << bits, dtype=np.uint32)
    want = ref_accum.row_from_prefix_int(pref, bits, B, canonical, xp=np)
    got = accum.row_from_prefix_int(torch.from_numpy(pref.astype(np.int64)),
                                    bits, B, canonical).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got) >= 0).all()


@pytest.mark.parametrize("k,b", [(5, 10), (16, 16), (21, 16), (32, 13),
                                 (33, 16), (40, 16), (64, 16)])
def test_top_bits_match_reference(k, b):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=512).astype(np.uint8)
    from meryl_tpu.ops import extract as ext
    planes, _ = ext.extract_kmers(jnp.asarray(codes), k, "forward")
    want = np.asarray(ref_accum._top_bits(planes, k, b))
    key, _ = text.extract_kmers(torch.from_numpy(codes), k, "forward")
    np.testing.assert_array_equal(accum._top_bits(key, k, b).numpy(), want)


def test_plan_route_l0_knob_clamps_to_pow2_divisor(monkeypatch):
    for want, chunk, got in [("1000", 1 << 13, 512), ("3", 1 << 13, 2),
                             ("0", 1 << 13, 1), (str(1 << 20), 1 << 13,
                                                 1 << 13),
                             ("6144", 3 << 12, 4096), ("65536", 3 << 12,
                                                       4096)]:
        monkeypatch.setenv("MERYL_TPU_ACC_L0", want)
        plan = accum.plan_route(chunk, 21, 1 << 14)
        assert plan["L0"] == got
        assert plan["R0"] * plan["L0"] == chunk
    monkeypatch.delenv("MERYL_TPU_ACC_L0")
    assert accum.plan_route(3 << 12, 21, 1 << 14)["L0"] == 3 << 12
    assert accum.plan_route(3 << 18, 21, 1 << 14)["L0"] == 1 << 18
    assert accum.plan_route(5 << 17, 21, 1 << 14)["L0"] == 1 << 17


def _fresh(k, B, La):
    P = km.num_planes(k)
    planes = tuple(jnp.full((B, La), 0xFFFFFFFF, jnp.uint32)
                   for _ in range(P))
    return planes, jnp.zeros((B, La), jnp.uint32)


def _merge_both(acc, staged_ref, k, La_out):
    """Run both merges on the same (reference-format) inputs; returns
    (port result, reference result)."""
    vmax = int(km.VALUE_MAX)
    P = km.num_planes(k)
    ref = ref_accum.merge_cells(acc[0], acc[1], tuple(staged_ref), P,
                                La_out, vmax)
    port = accum.merge_cells(
        _port_key(acc[0], k),
        torch.from_numpy(np.asarray(acc[1]).astype(np.int64)),
        [_port_key(s, k) for s in staged_ref], k, La_out, vmax)
    return port, ref


def _assert_merge_equal(port, ref, k):
    _assert_key_equal(port[0], ref[0], k)
    np.testing.assert_array_equal(port[1].numpy(),
                                  np.asarray(ref[1]).astype(np.int64))
    np.testing.assert_array_equal(port[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("k", [21, 33])
def test_merge_matches_reference(k):
    """Three merges: a truncating one (n_runs > La), a regrow into a
    wider accumulator, and one that saturates counts at VALUE_MAX.
    Entries past each row's n_runs (the sanitized tail) must be
    sentinel / 0 in both."""
    chunk = 1 << 13
    cfg = _cfg(chunk, k, "canonical", 1 << 10)
    B = cfg[3]
    cells = []
    for seed in range(4):
        codes = _random_codes(100 + seed, chunk)
        if seed == 3:
            codes[:chunk // 2] = _random_codes(100, chunk)[:chunk // 2]
        _, ref = _route_both(codes, cfg)
        cells.append(ref[0])

    La = 256
    port, ref = _merge_both(_fresh(k, B, La), cells[:3], k, La)
    _assert_merge_equal(port, ref, k)
    assert int(np.asarray(ref[2]).max()) > La  # truncated: regrow needed

    la = 4096  # regrow: the driver pads the old accumulator to la
    acc = _fresh(k, B, la)
    port, ref = _merge_both(acc, cells[:3], k, la)
    _assert_merge_equal(port, ref, k)
    assert int(np.asarray(ref[2]).max()) <= la
    assert (np.asarray(ref[1])[:, -1] == 0).all()  # sanitized tail

    # saturation: accumulator counts just below VALUE_MAX, then a merge
    # of a chunk that shares half its windows
    cnt = np.asarray(ref[1]).copy()
    cnt[cnt > 0] = km.VALUE_MAX - 1
    acc = (ref[0], jnp.asarray(cnt))
    port, ref = _merge_both(acc, [cells[3]], k, la)
    _assert_merge_equal(port, ref, k)
    assert (np.asarray(ref[1]) == km.VALUE_MAX).any()
