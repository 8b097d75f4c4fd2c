"""The extraction kernel's index arithmetic, replayed in numpy.

meryl_tpu_torch/csrc/extract.cu runs only on the card.  This file
replays `extract_kernel` on numpy uint64 arrays with the kernel's own
THREADS, TILE, HALO, TILE_WORDS and TILE_BITS, read from the source:

  * the CTA's contiguous run of windows for a grid of G CTAs, walked in
    tiles of TILE;
  * the THREADS-way search of the sorted exception list (a step is one
    __syncthreads_count over THREADS probes), and the tile bitmap built
    from the entries in [base, base + n + HALO), with the index carried
    to the next tile by counting;
  * per window: the 64-bit span of codes by funnel shifts of the tile's
    words (two spans for k > 32), the forward key by reversing the 2-bit
    groups (__brevll, then a swap inside each pair), the reverse
    complement by XOR 0xAAAA..., validity by a funnel shift of the
    bitmap and p + k <= n_real;
  * the stores: every position is written exactly once.

Shared arrays have the kernel's sizes, so an index past them raises.
Every replay is held bit for bit against the port's plain
ops/extract.py and against meryl_tpu/ops/extract.py run on CPU JAX;
tests/test_torch_cuda.py holds the kernel itself against the plain
version on the card.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meryl_tpu.ops import extract as ref_ext
from meryl_tpu_torch import kmer as km
from meryl_tpu_torch.ops import extract as ext
from meryl_tpu_torch.ops import multiword as mw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "meryl_tpu_torch", "csrc", "extract.cu")
MODES = ["canonical", "forward", "reverse", "both"]
U64 = np.uint64
ODD = U64(0x5555555555555555)
COMP = U64(0xAAAAAAAAAAAAAAAA)
FLIP = U64(1 << 63)
M32 = U64(0xFFFFFFFF)
BIG = np.iinfo(np.int64).max


def _source_consts():
    with open(SRC) as f:
        text = f.read()
    got = {}
    for name in ("THREADS", "TILE", "HALO", "MIN_RUN"):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        assert m, f"constexpr int {name} not found in extract.cu"
        got[name] = int(m.group(1))
    for name in ("TILE_WORDS", "TILE_BITS"):
        m = re.search(rf"constexpr int {name} = ([^;]+);", text)
        assert m, f"constexpr int {name} not found in extract.cu"
        expr = m.group(1).replace("/", "//")
        assert re.fullmatch(r"[A-Z_ ()+\-/\d]+", expr), expr
        got[name] = eval(expr, {}, dict(got))  # noqa: S307 (constants)
    return got


_C = _source_consts()
THREADS, TILE, HALO = _C["THREADS"], _C["TILE"], _C["HALO"]
TILE_WORDS, TILE_BITS = _C["TILE_WORDS"], _C["TILE_BITS"]
L = 2 * TILE + 48          # not a multiple of TILE
CAP = 1024                 # exception list length, INT32_MAX padded
# one CTA (three tiles), two (a tile and a part each), five (part of a
# tile each), and the grid the kernel takes at this L on the card: one
# CTA a MIN_RUN windows
GRIDS = [1, 2, 5, (L + _C["MIN_RUN"] - 1) // _C["MIN_RUN"]]

_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def brevll(x):
    """__brevll on a uint64 array."""
    b = np.ascontiguousarray(x, "<u8").view(np.uint8).reshape(-1, 8)
    return _REV8[b[:, ::-1]].copy().view("<u8").reshape(x.shape)


def rev_pairs(x):
    b = brevll(x)
    return ((b >> U64(1)) & ODD) | ((b & ODD) << U64(1))


def funnel_r(lo, hi, s):
    """__funnelshift_r(lo, hi, s) for 0 <= s < 32, uint32 values held
    in uint64."""
    return (((hi << U64(32)) | lo) >> s.astype(U64)) & M32


def bits64(w, i, s):
    """extract.cu bits64: 64 bits from bit s of w[i], out of w[i..i+2]."""
    a, b, c = w[i], w[i + 1], w[i + 2]
    return (funnel_r(b, c, s) << U64(32)) | funnel_r(a, b, s)


def search(exc, x):
    """The kernel's THREADS-way search: the first index of sorted `exc`
    whose entry is >= x, and the number of steps (barriers) taken."""
    lo, hi, steps = 0, len(exc), 0
    while lo < hi:
        step = (hi - lo + THREADS - 1) // THREADS
        i = lo + np.arange(THREADS, dtype=np.int64) * step
        probe = np.where(i < hi, exc[np.minimum(i, hi - 1)], BIG)
        c = int((probe < x).sum())
        if c == 0:
            hi = lo
        else:
            hi = min(lo + c * step, hi)
            lo += (c - 1) * step + 1
        steps += 1
    return lo, steps


def replay(packed, exc, n_real, k, mode, grid):
    """extract_kernel on a grid of `grid` CTAs -> the wrapper's outputs
    (int64 keys, (L,) or (L, 2); a second key array in mode "both";
    the valid mask)."""
    nw = 1 if k <= 32 else 2
    n_words = len(packed)
    Lw = n_words * 16
    gw = packed.astype(np.uint32).astype(U64)
    exc = exc.astype(np.int64)
    out = np.zeros((2, Lw, nw), U64)
    valid = np.zeros(Lw, bool)
    written = np.zeros(Lw, np.int64)
    kmask = ~U64(0) if k == 64 else U64((1 << k) - 1)
    twok = 2 * k
    mask_lo = ~U64(0) if nw == 2 or twok == 64 else U64((1 << twok) - 1)
    mask_hi = ~U64(0) if nw == 1 or twok == 128 else \
        U64((1 << (twok - 64)) - 1)
    down = U64(64 - twok if nw == 1 else 128 - twok)
    for b in range(grid):
        start = n_words * b // grid * 16
        stop = n_words * (b + 1) // grid * 16
        ex, _ = search(exc, start)
        for base in range(start, stop, TILE):
            n = min(TILE, stop - base)
            wi = base // 16 + np.arange(TILE_WORDS)
            words = np.where(wi < n_words, gw[np.minimum(wi, n_words - 1)],
                             U64(0))
            bits = np.zeros(TILE_BITS, U64)
            end = min(base + n + HALO, Lw)
            j0 = ex
            while True:
                j = j0 + np.arange(THREADS, dtype=np.int64)
                e = np.where(j < len(exc), exc[np.minimum(j, len(exc) - 1)],
                             BIG)
                off = e[e < end] - base
                np.bitwise_or.at(bits, off >> 5,
                                 U64(1) << (off & 31).astype(U64))
                ex += int((e < base + n).sum())
                if int((e < end).sum()) < THREADS:
                    break
                j0 += THREADS
            j = np.arange(n)
            s = (j & 15) * 2
            span_lo = bits64(words, j >> 4, s)
            if nw == 1:
                fh = rh = np.zeros(n, U64)
                fl = rev_pairs(span_lo) >> down
                rl = (span_lo ^ COMP) & mask_lo
            else:
                span_hi = bits64(words, (j >> 4) + 2, s)
                a, bb = rev_pairs(span_lo), rev_pairs(span_hi)
                fh = a >> down
                fl = bb if down == 0 else \
                    (bb >> down) | (a << (U64(64) - down))
                rl = span_lo ^ COMP
                rh = (span_hi ^ COMP) & mask_hi
            gap = bits64(bits, j >> 5, j & 31) & kmask
            p = base + j
            valid[p] = (gap == 0) & (p + k <= n_real)
            if mode == "canonical":
                rev = rl < fl if nw == 1 else (rh < fh) | ((rh == fh)
                                                          & (rl < fl))
            else:
                rev = np.full(n, mode == "reverse")
            keys = [(np.where(rev, rh, fh), np.where(rev, rl, fl)),
                    (rh, rl)]
            for o, (h, lo_) in enumerate(keys[:2 if mode == "both" else 1]):
                if nw == 2:
                    out[o, p, 0] = h
                out[o, p, nw - 1] = lo_
            written[p] += 1
    assert (written == 1).all(), "a position written twice or never"
    keys = (out ^ FLIP).view(np.int64)
    keys = keys[..., 0] if nw == 1 else keys
    return (keys[0], keys[1], valid) if mode == "both" else (keys[0], valid)


# ------------------------------------------------------------ inputs

def _edges():
    """Positions at and around every tile and CTA edge, and the end of
    each tile's halo, for every grid of GRIDS."""
    n_words = L // 16
    pos = set()
    for g in GRIDS:
        for b in range(g):
            start = n_words * b // g * 16
            stop = n_words * (b + 1) // g * 16
            for base in range(start, stop, TILE):
                edge = min(base + TILE, stop)
                for d in (-1, 0, 1, HALO - 1, HALO):
                    pos.update((base + d, edge + d))
    return sorted(p for p in pos if 0 <= p < L)


def _wire(codes):
    """codes -> (packed (L/16,) uint32, exc (CAP,) int32 sorted and
    INT32_MAX padded, n_real), the padded list longer than
    kmer.pack_codes_2bit makes it."""
    packed, exc, n_real = km.pack_codes_2bit(codes)
    real = exc[exc != km.EXC_PAD]
    assert len(real) <= CAP
    pad = np.full(CAP, km.EXC_PAD, np.int32)
    pad[:len(real)] = real
    return packed, pad, n_real


def _inputs():
    rng = np.random.default_rng(44)
    rand = rng.integers(0, 4, size=L).astype(np.uint8)
    rand[rng.integers(0, L, size=L // 100)] = 255
    rand[1000:1037] = 255
    rand[L - 333:] = 255                 # n_real < L
    edges = rng.integers(0, 4, size=L).astype(np.uint8)
    edges[_edges()] = 255
    polyg = np.full(L, 3, np.uint8)      # the all-ones k-mer everywhere
    polyg[[TILE - 1, TILE + 16]] = 255
    polyg[L - 5:] = 255
    words = rng.integers(0, 4, size=L).astype(np.uint8)
    words[np.arange(15, L, 16 * 37)] = 255   # last code of a word
    words[np.arange(16, L, 16 * 41)] = 255   # first code of a word
    return {"random": _wire(rand), "edges": _wire(edges),
            "poly-G": _wire(polyg), "word-edges": _wire(words)}


INPUTS = _inputs()


def _plain(packed, exc, n_real, k, mode):
    got = ext.extract_kmers_packed(
        torch.from_numpy(packed.view(np.int32)), torch.from_numpy(exc),
        n_real, k, mode)
    return tuple(t.numpy() for t in got)


def _reference(packed, exc, n_real, k, mode):
    """meryl_tpu on CPU JAX, as the port's int64 key words."""
    got = ref_ext.extract_kmers_packed(jnp.asarray(packed),
                                       jnp.asarray(exc), jnp.uint32(n_real),
                                       k, mode)
    keys = [mw.from_planes([np.asarray(p) for p in planes], k)
            for planes in got[:-1]]
    return (*keys, np.asarray(got[-1]))


def _assert_same(got, want, what):
    np.testing.assert_array_equal(got[-1], want[-1], err_msg=what)
    v = want[-1]
    for g, w in zip(got[:-1], want[:-1]):
        assert g.shape == w.shape and g.dtype == w.dtype, what
        np.testing.assert_array_equal(g[v], w[v], err_msg=what)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", range(1, 65))
def test_replay_matches_plain_and_reference(k, mode):
    for name, (packed, exc, n_real) in INPUTS.items():
        plain = _plain(packed, exc, n_real, k, mode)
        ref = _reference(packed, exc, n_real, k, mode)
        _assert_same(plain, ref, f"plain vs reference, {name}")
        assert ref[-1].any(), name
        for g in GRIDS:
            _assert_same(replay(packed, exc, n_real, k, mode, g), ref,
                         f"replay vs reference, {name}, grid {g}")


@pytest.mark.parametrize("n", [0, 1, 2, 255, 256, 257, 4096, 65536, 65537,
                               300000])
def test_search_finds_first_at_or_past(n):
    """The THREADS-way search against np.searchsorted, on sorted lists
    with repeats and INT32_MAX padding; at most two steps for the
    2^16-entry floor of a 2^22-code chunk."""
    rng = np.random.default_rng(n)
    exc = np.sort(rng.integers(0, 1 << 22, size=n)).astype(np.int64)
    exc[n - n // 4:] = km.EXC_PAD
    xs = np.concatenate([[0, 1, 1 << 22, km.EXC_PAD, int(km.EXC_PAD) + 1],
                         rng.integers(0, 1 << 22, size=50),
                         exc[rng.integers(0, max(n, 1), size=20)] if n
                         else []])
    for x in xs.astype(np.int64):
        got, steps = search(exc, x)
        assert got == np.searchsorted(exc, x, side="left"), x
        if n <= THREADS * THREADS:
            assert steps <= 2


def test_replay_exception_list_twice_the_floor():
    """A list past the L/64 floor (kmer.pack_codes_2bit doubles its
    capacity) on a grid of one CTA and of one CTA a tile."""
    n = 1 << 14
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.choice(n, size=(n >> 6) + 40, replace=False)] = 255
    packed, exc, n_real = km.pack_codes_2bit(codes)
    assert len(exc) == 2 * (n >> 6)
    for k, mode in ((21, "canonical"), (33, "both"), (64, "forward")):
        want = _plain(packed, exc, n_real, k, mode)
        for g in (1, n // TILE):
            _assert_same(replay(packed, exc, n_real, k, mode, g), want,
                         f"k={k} {mode} grid {g}")
