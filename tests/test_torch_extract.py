"""meryl_tpu_torch extraction and key layout against meryl_tpu.

The same numpy inputs go through the JAX functions (XLA path, and the
Pallas kernel in interpret mode) and through the port on the CPU.
Outputs are integers: valid masks must be equal, and keys equal at
valid positions once converted to the reference's uint32 planes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meryl_tpu import kmer as km
from meryl_tpu.ops import extract as ext
from meryl_tpu.ops.extract_pallas import extract_kmers_pallas
from meryl_tpu_torch.ops import extract as text
from meryl_tpu_torch.ops import extract_cuda
from meryl_tpu_torch.ops import multiword as mw

KS = [1, 5, 15, 16, 21, 31, 32, 33, 48, 63, 64]
MODES = ["canonical", "forward", "reverse", "both"]
L = 1 << 10


def _codes(seed, L=L, n_breakers=20):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    codes[rng.integers(0, L, size=n_breakers)] = 255
    codes[100:130] = 255  # an N run
    return codes


def _assert_keys_equal(got_key, got_valid, want_planes, want_valid, k):
    want_v = np.asarray(want_valid)
    np.testing.assert_array_equal(np.asarray(got_valid), want_v)
    got_planes = mw.to_planes(np.asarray(got_key), k)
    assert len(got_planes) == len(want_planes) == km.num_planes(k)
    for gp, wp in zip(got_planes, want_planes):
        np.testing.assert_array_equal(gp[want_v], np.asarray(wp)[want_v])


def _check(got, want, k, mode):
    if mode == "both":
        _assert_keys_equal(got[0], got[2], want[0], want[2], k)
        _assert_keys_equal(got[1], got[2], want[1], want[2], k)
    else:
        _assert_keys_equal(got[0], got[1], want[0], want[1], k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", KS)
def test_extract_matches_reference(k, mode):
    codes = _codes(k)
    want = ext.extract_kmers(jnp.asarray(codes), k, mode)
    got = text.extract_kmers(torch.from_numpy(codes), k, mode)
    _check(got, want, k, mode)

    # packed wire with n_real < L: a trailing separator run is pad
    codes[L - 200:] = 255
    packed2, exc, n_real = km.pack_codes_2bit(codes)
    assert n_real < L
    want = ext.extract_kmers_packed(jnp.asarray(packed2), jnp.asarray(exc),
                                    jnp.uint32(n_real), k, mode)
    # the CPU tensor goes to the plain version through the kernel's
    # wrapper, as on the counting path
    got = extract_cuda.extract_kmers_packed(
        torch.from_numpy(packed2.view(np.int32)), torch.from_numpy(exc),
        n_real, k, mode)
    _check(got, want, k, mode)


@pytest.mark.parametrize("k", [5, 16, 21, 33, 64])
def test_extract_matches_pallas_interpret(k):
    codes = _codes(100 + k)
    want = extract_kmers_pallas(jnp.asarray(codes), k, block=256,
                                interpret=True)
    got = text.extract_kmers(torch.from_numpy(codes), k, "canonical")
    _check(got, want, k, "canonical")


def test_cpu_wrapper_does_not_launch():
    before = extract_cuda.LAUNCHES
    packed2, exc, n_real = km.pack_codes_2bit(_codes(3))
    extract_cuda.extract_kmers_packed(
        torch.from_numpy(packed2.view(np.int32)), torch.from_numpy(exc),
        n_real, 21)
    assert extract_cuda.LAUNCHES == before


@pytest.mark.parametrize("k", [1, 16, 21, 32, 33, 48, 64])
def test_key_layout_roundtrip_and_order(k):
    rng = np.random.default_rng(k)
    n = 4000
    P = km.num_planes(k)
    planes = [rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
              .astype(np.uint32) for _ in range(P)]
    top = 2 * k - 32 * (P - 1)
    if top < 32:
        planes[-1] &= np.uint32((1 << top) - 1)
    planes[-1][:50] = np.uint32((1 << min(top, 32)) - 1)  # top-bit keys
    key = mw.from_planes(planes, k)
    for a, b in zip(mw.to_planes(key, k), planes):
        np.testing.assert_array_equal(a, b)
    # int64 key order == unsigned k-mer order
    hi, lo = km.hilo_from_planes(planes)
    want = np.lexsort((lo, hi))
    skey, _ = mw.sort(torch.from_numpy(key), k, stable=True)
    got_hi, got_lo = mw.to_hilo(skey.numpy(), k)
    np.testing.assert_array_equal(got_hi, hi[want])
    np.testing.assert_array_equal(got_lo, lo[want])
    # words built from int64-held planes match the host converter
    t = mw.words_from_planes_t([torch.from_numpy(p.astype(np.int64))
                                for p in planes])
    np.testing.assert_array_equal(t.numpy(), key)


@pytest.mark.parametrize("k,hilo", [
    (16, (0, 0xFFFFFFFF)), (21, (0, (1 << 64) - 1)),
    (32, (0, (1 << 64) - 1)), (33, (0xFFFFFFFF, (1 << 64) - 1)),
    (64, ((1 << 64) - 1, (1 << 64) - 1))])
def test_sentinel_is_image_of_all_ones_planes(k, hilo):
    assert mw.sentinel_hilo(k) == hilo
    s = mw.sentinel(k, "cpu").numpy()
    hi, lo = mw.to_hilo(s.reshape((1,) + s.shape), k)
    assert (int(hi[0]), int(lo[0])) == hilo
