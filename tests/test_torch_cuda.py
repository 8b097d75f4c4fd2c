"""meryl_tpu_torch on the card: the CUDA extraction kernel against its
plain PyTorch version, and the counting path on CUDA against the CPU.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports no JAX, so on
the card's machine (which has none) run it without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from meryl_tpu import kmer as km
from meryl_tpu_torch import counter
from meryl_tpu_torch.ops import accum
from meryl_tpu_torch.ops import extract as ext
from meryl_tpu_torch.ops import extract_cuda

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
