"""K-mer extraction in plain PyTorch (counterpart of
meryl_tpu/ops/extract.py).

This is the reference version of the Hopper kernel in
ops/extract_cuda.py: the CPU path runs it, and the card's tests hold
the kernel against it.  It builds the reference's uint32 planes with
the same 16-base rolling dot products (exact in int64) and joins them
into the port's int64 key words (ops/multiword.py).

Semantics, as in the reference:
  * canonical = min(fmer, rmer) in the A=00,C=01,T=10,G=11 order;
  * a code > 3 invalidates every window that contains it;
  * windows starting at or past n_real - k + 1 are invalid;
  * forward / reverse keep one strand, both returns the two.
"""

from __future__ import annotations

import torch

from ..kmer import num_planes
from . import multiword as mw

INVALID_CODE = 255
MODES = ("canonical", "forward", "reverse", "both")


def _planes(c: torch.Tensor, k: int, L: int):
    """codes (L,) int64 in 0..3 -> forward and reverse-complement
    reference planes (int64 tensors holding uint32 values)."""
    P = num_planes(k)
    lp = 16 * P - k
    rpad = k + 16
    dev = c.device
    z = torch.zeros

    def ladder(v, forward):
        for step in (1, 2, 4, 8):
            hiw = 1 << (2 * step)
            a, b = v[:-step], v[step:]
            v = a * hiw + b if forward else a + b * hiw
        return v

    x = torch.cat([z(lp, dtype=torch.int64, device=dev), c,
                   z(rpad, dtype=torch.int64, device=dev)])
    y = ladder(x, True)
    zz = ladder(torch.cat([z(lp, dtype=torch.int64, device=dev), c ^ 2,
                           z(rpad, dtype=torch.int64, device=dev)]),
                False)

    def top_mask(v, p):
        bits = 2 * k - 32 * p
        return v & ((1 << bits) - 1) if bits < 32 else v

    f = [top_mask(y[lp + k - 16 * (p + 1):lp + k - 16 * (p + 1) + L], p)
         for p in range(P)]
    r = [top_mask(zz[lp + 16 * p:lp + 16 * p + L], p) for p in range(P)]
    return f, r


def extract_kmers(codes: torch.Tensor, k: int, mode: str = "canonical",
                  n_real: int | None = None):
    """codes: (L,) uint8 base codes (0..3, INVALID_CODE elsewhere).

    -> (key, valid): key is (L,) or (L, 2) int64 (ops/multiword.py) for
    the window starting at each position, valid is (L,) bool.  Mode
    "both" returns (fkey, rkey, valid)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not 1 <= k <= 64:
        raise ValueError(f"k must be in [1, 64], got {k}")
    L = codes.shape[0]
    c = codes.to(torch.int64)
    ok = c <= 3
    f, r = _planes(torch.where(ok, c, 0), k, L)
    fkey = mw.words_from_planes_t(f)
    rkey = mw.words_from_planes_t(r)

    # a window is valid when it holds no invalid code; the tail past L
    # counts as invalid
    bad = torch.cat([(~ok).to(torch.int32),
                     torch.ones(k, dtype=torch.int32, device=c.device)])
    cs = torch.cat([torch.zeros(1, dtype=torch.int64, device=c.device),
                    torch.cumsum(bad, 0)])
    last = L - k if n_real is None else int(n_real) - k
    valid = ((cs[k:k + L] - cs[:L]) == 0) & (
        torch.arange(L, device=c.device) <= last)

    if mode == "canonical":
        return mw.where(mw.lt(fkey, rkey, k), fkey, rkey, k), valid
    if mode == "forward":
        return fkey, valid
    if mode == "reverse":
        return rkey, valid
    return fkey, rkey, valid


def unpack_codes(packed2: torch.Tensor, exc: torch.Tensor) -> torch.Tensor:
    """Packed wire (kmer.pack_codes_2bit) -> (L,) uint8 codes.

    packed2: (L/16,) int32 holding the uint32 words (code j of word w at
    bits 2*(j mod 16)); exc: int32 positions of non-ACGT codes, padded
    with INT32_MAX — entries outside [0, L) drop."""
    W = packed2.shape[0]
    words = packed2.to(torch.int64) & 0xFFFFFFFF
    sh = 2 * torch.arange(16, dtype=torch.int64, device=packed2.device)
    codes = ((words[:, None] >> sh) & 3).reshape(W * 16).to(torch.uint8)
    e = exc.to(torch.int64)
    codes[e[(e >= 0) & (e < W * 16)]] = INVALID_CODE
    return codes


def extract_kmers_packed(packed2: torch.Tensor, exc: torch.Tensor,
                         n_real: int, k: int, mode: str = "canonical"):
    """extract_kmers over the 2-bit packed wire; codes at positions >=
    n_real are trailing pad."""
    return extract_kmers(unpack_codes(packed2, exc), k, mode,
                         n_real=n_real)
