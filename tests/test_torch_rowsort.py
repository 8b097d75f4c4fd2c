"""meryl_tpu_torch row sorts against the Pallas kernels they port.

The probe's own kernel bodies (scripts/probe_r4_pallas_sort.py,
`bitonic_kernel` and `roll_pass_kernel`) run here under
pl.pallas_call(..., interpret=True) at R = 32 rows of 2048 int32, with
the probe's SUB / LANE / BR tiling, and are held exactly against the
plain versions of the port's `bitonic_rows` and `pass_floor` (the CPU
runs them; tests/test_torch_cuda.py holds the CUDA kernels against the
same plain versions on the card).  The set-op row sort's plain version
is held against lax.sort(..., is_stable=True) with payloads.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from meryl_tpu import kmer as km
from meryl_tpu_torch.ops import multiword as mw
from meryl_tpu_torch.ops import rowsort

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = 32


@pytest.fixture(scope="module")
def probe():
    path = os.path.join(ROOT, "scripts", "probe_r4_pallas_sort.py")
    spec = importlib.util.spec_from_file_location("probe_r4_pallas_sort",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    argv = sys.argv
    sys.argv = [path]                 # the probe reads --cpu at import
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    assert not mod.CPU
    return mod


def _pallas(probe, kernel):
    spec = pl.BlockSpec((probe.BR, probe.SUB, probe.LANE),
                        lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((R, probe.SUB, probe.LANE),
                                       jnp.int32),
        in_specs=[spec], out_specs=spec, grid=(R // probe.BR,),
        interpret=True)


def _rows(probe, seed, span):
    rng = np.random.default_rng(seed)
    return rng.integers(-span, span, size=(R, probe.SUB * probe.LANE),
                        dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("span", [1 << 31, 7])
def test_bitonic_rows_matches_probe_kernel(probe, span):
    x = _rows(probe, 1, span)
    want = np.asarray(_pallas(probe, probe.bitonic_kernel)(
        jnp.asarray(x.reshape(R, probe.SUB, probe.LANE)))).reshape(R, -1)
    got = rowsort.bitonic_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.sort(x, axis=1))


@pytest.mark.parametrize("span", [1 << 31, 3])
def test_pass_floor_matches_probe_kernel(probe, span):
    x = _rows(probe, 2, span)
    want = np.asarray(_pallas(probe, probe.roll_pass_kernel)(
        jnp.asarray(x.reshape(R, probe.SUB, probe.LANE)))).reshape(R, -1)
    got = rowsort.pass_floor(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    pairs = x.reshape(R, -1, 2)
    np.testing.assert_array_equal(
        want, np.stack([pairs.min(-1), pairs.max(-1)], -1).reshape(R, -1))


def test_pass_floor_plain_odd_rows():
    x = torch.tensor([[5, 4, 3, 2, 1]], dtype=torch.int32)
    assert rowsort.pass_floor(x).tolist() == [[4, 5, 2, 3, 1]]


@pytest.mark.parametrize("k", [15, 16, 21, 32, 33, 64])
def test_sort_rows_plain_matches_stable_lax_sort(k):
    """Rows with ties (the same key from several inputs, sentinel
    padding that aliases the all-ones k-mer at k = 16 and 32): the
    plain row sort gives lax.sort's stable order, payloads included."""
    rng = np.random.default_rng(k)
    P = km.num_planes(k)
    rows, L = 6, 300
    pool_hi = rng.integers(0, 1 << 62, size=40, dtype=np.uint64)
    pool_lo = rng.integers(0, 1 << 62, size=40, dtype=np.uint64) * \
        np.uint64(4)
    bits = 2 * k
    if bits < 64:
        pool_lo &= np.uint64((1 << bits) - 1)
    pool_hi = pool_hi & np.uint64((1 << max(bits - 64, 0)) - 1)
    pool_hi[0] = (1 << max(bits - 64, 0)) - 1
    pool_lo[0] = (1 << min(bits, 64)) - 1         # the all-ones k-mer
    pick = rng.integers(0, 40, size=rows * L)
    planes = km.planes_from_hilo(pool_hi[pick], pool_lo[pick], P)
    pad = rng.random(rows * L) < 0.2
    for p in planes:
        p[pad] = 0xFFFFFFFF                      # the sentinel
    planes = [p.reshape(rows, L) for p in planes]
    values = rng.integers(0, 1 << 32, size=(rows, L)).astype(np.uint32)
    ids = rng.integers(0, 4, size=(rows, L)).astype(np.int32)

    out = jax.lax.sort(tuple(jnp.asarray(planes[p])
                             for p in range(P - 1, -1, -1))
                       + (jnp.asarray(values), jnp.asarray(ids)),
                       num_keys=P, is_stable=True)
    want_planes = [np.asarray(out[P - 1 - p]) for p in range(P)]

    key = mw.from_planes([p.reshape(-1) for p in planes], k)
    key = torch.from_numpy(key.reshape((rows, L) + key.shape[1:]))
    skey, sval, sids = rowsort.sort_rows(
        key, torch.from_numpy(values.astype(np.int64)),
        torch.from_numpy(ids), k)
    got_planes = mw.to_planes(skey.numpy().reshape(
        (rows * L,) + skey.shape[2:]), k)
    for g, w in zip(got_planes, want_planes):
        np.testing.assert_array_equal(g.reshape(rows, L), w)
    np.testing.assert_array_equal(sval.numpy(),
                                  np.asarray(out[P]).astype(np.int64))
    np.testing.assert_array_equal(sids.numpy(), np.asarray(out[P + 1]))


def test_wrappers_reject_other_devices():
    """A wrapper runs its plain version only on a CPU tensor; any other
    device but CUDA is refused (CUDA launches the kernel)."""
    x = torch.zeros((2, 64), dtype=torch.int32, device="meta")
    for fn in (rowsort.bitonic_rows, rowsort.pass_floor):
        with pytest.raises(ValueError):
            fn(x)
    with pytest.raises(ValueError):
        rowsort.sort_rows(x.long(), x.long(), x, 21)
