"""The row-sort kernel's compare-exchange schedule, replayed in numpy.

meryl_tpu_torch/csrc/rowsort.cu runs only on the card.  This file
replays its network (`sort_row` and the helpers it calls) on numpy
arrays with the kernel's own E, WARP and MAX_ROW, read from the source:
the all-ascending bitonic network on next_pow2(L) positions, the
positions >= L as virtual +inf (held in registers as the largest key
with their own position as the column, never loaded from or stored to
shared memory), and the three phases as the kernel's index maps:

  * strides below E inside a thread (`reg_step`, `reg_mirror`);
  * strides E .. W/2 across a warp, each lane keeping the min or the max
    of its value and its partner lane's (`shfl_step`, `shfl_mirror`);
  * a stage above W: registers to shared memory, the cross-warp head on
    cosets of 2^C positions (`cross_warp`), back to registers.

Every row is held against np.argsort(kind="stable"): keys and the
column order, i.e. the stable permutation that the kernel gathers the
payloads by.  The emulator also checks, after every phase, that each
virtual pad is still the pad of its own position (pads never move), and
its shared-memory stage has exactly L slots, so a load or store of a pad
position would fail.  tests/test_torch_cuda.py holds the kernel itself
against the plain sort on the card.
"""

import os
import re

import numpy as np
import pytest

from meryl_tpu_torch.ops import rowsort

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "meryl_tpu_torch", "csrc", "rowsort.cu")
PAD = np.iinfo(np.int64).max


def _source_consts():
    with open(SRC) as f:
        text = f.read()
    got = {}
    for name in ("MAX_ROW", "E", "WARP"):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        assert m, f"constexpr int {name} not found in rowsort.cu"
        got[name] = int(m.group(1))
    assert re.search(r"constexpr int W = WARP \* E;", text)
    return got


_C = _source_consts()
E, WARP, MAX_ROW = _C["E"], _C["WARP"], _C["MAX_ROW"]
W = WARP * E


def sort_threads(L):
    """rowsort.cu sort_threads: whole warps of E positions covering L."""
    return ((L + E - 1) // E + WARP - 1) // WARP * WARP


def _less(ak, ai, bk, bi):
    return (ak < bk) | ((ak == bk) & (ai < bi))


class Cta:
    """One CTA per row, R rows at once: registers vk, vi (R, T, E) and
    the shared-memory stage sk, si (R, L)."""

    def __init__(self, keys):
        self.R, self.L = keys.shape
        self.T = sort_threads(self.L)
        self.pos = np.arange(self.T * E).reshape(self.T, E)
        self.real = self.pos < self.L
        self.sk = keys.astype(np.int64).copy()
        self.si = np.broadcast_to(np.arange(self.L), keys.shape).copy()
        self.barriers = 1                       # after the row's copy in
        self.load_regs()

    # -------------------------------------------------- registers

    def load_regs(self):
        self.vk = np.full((self.R, self.T, E), PAD, np.int64)
        self.vi = np.broadcast_to(self.pos, self.vk.shape).copy()
        self.vk[:, self.real] = self.sk[:, self.pos[self.real]]
        self.vi[:, self.real] = self.si[:, self.pos[self.real]]

    def store_regs(self):
        self.check_pads()
        self.sk[:, self.pos[self.real]] = self.vk[:, self.real]
        self.si[:, self.pos[self.real]] = self.vi[:, self.real]

    def check_pads(self):
        pads = ~self.real
        assert (self.vk[:, pads] == PAD).all()
        assert (self.vi[:, pads] == self.pos[pads]).all()

    def cex_regs(self, lo_e, hi_e):
        """cex(v[lo], v[hi]) for the register pairs of every thread."""
        ak, ai = self.vk[:, :, lo_e], self.vi[:, :, lo_e]
        bk, bi = self.vk[:, :, hi_e], self.vi[:, :, hi_e]
        sw = _less(bk, bi, ak, ai)
        self.vk[:, :, lo_e] = np.where(sw, bk, ak)
        self.vi[:, :, lo_e] = np.where(sw, bi, ai)
        self.vk[:, :, hi_e] = np.where(sw, ak, bk)
        self.vi[:, :, hi_e] = np.where(sw, ai, bi)

    def reg_step(self, J):
        lo = [e for e in range(E) if not e & J]
        self.cex_regs(lo, [e | J for e in lo])

    def reg_mirror(self, S):
        lo = [e for e in range(E) if not e & (S // 2)]
        self.cex_regs(lo, [e ^ (S - 1) for e in lo])

    def reg_down(self, j):
        J = E // 2
        while J >= 1:
            if j >= J:
                self.reg_step(J)
            J //= 2

    # ------------------------------------------------ warp shuffles

    def keep(self, ok, oi, lower):
        """Each lane keeps the smaller of (mine, other) if its position
        is the lower one, else the larger."""
        take = _less(ok, oi, self.vk, self.vi) == lower[None, :, None]
        self.vk = np.where(take, ok, self.vk)
        self.vi = np.where(take, oi, self.vi)

    def shfl_step(self, m):
        t = np.arange(self.T)
        lane = t % WARP
        self.keep(self.vk[:, t ^ m], self.vi[:, t ^ m], (lane & m) == 0)

    def shfl_mirror(self, m):
        t = np.arange(self.T)
        lane = t % WARP
        rev = np.arange(E)[::-1]
        other_k = self.vk[:, t ^ m][:, :, rev]
        other_i = self.vi[:, t ^ m][:, :, rev]
        self.keep(other_k, other_i, (lane & ((m + 1) >> 1)) == 0)

    def warp_down(self, j):
        while j >= E:
            self.shfl_step(j // E)
            self.check_pads()
            j >>= 1
        self.reg_down(j)
        self.check_pads()

    # ------------------------------------------------ shared memory

    def cross_warp(self, C, size):
        M, H = 1 << C, 1 << (C - 1)
        L = self.L
        cosets = (L + size - 1) // size * W
        c = np.arange(cosets)
        b, x = c // W * size, c % W
        c = c[b + x < L]                         # cosets of pads only: none
        b, x = c // W * size, c % W
        pos = np.empty((len(c), M), np.int64)
        for u in range(M):
            o = x + (u % H) * W
            pos[:, u] = b + (o if u < H else size - 1 - o)
        real = pos < L
        flat = np.sort(pos[real])
        assert np.array_equal(flat, np.arange(L)), "cosets tile 0..L-1"
        rk = np.full((self.R,) + pos.shape, PAD, np.int64)
        ri = np.broadcast_to(pos, rk.shape).copy()
        rk[:, real] = self.sk[:, pos[real]]
        ri[:, real] = self.si[:, pos[real]]

        def cex(u, v):
            ak, ai = rk[:, :, u].copy(), ri[:, :, u].copy()
            bk, bi = rk[:, :, v], ri[:, :, v]
            sw = _less(bk, bi, ak, ai)
            rk[:, :, u] = np.where(sw, bk, ak)
            ri[:, :, u] = np.where(sw, bi, ai)
            rk[:, :, v] = np.where(sw, ak, bk)
            ri[:, :, v] = np.where(sw, ai, bi)

        for u in range(H):                      # the mirror
            cex(u, u + H)
        for q in range(C - 2, -1, -1):          # j = W << q
            for u in range(M):
                if not u & (1 << q):
                    if u < H:
                        cex(u, u | (1 << q))
                    else:
                        cex(u | (1 << q), u)
        assert (rk[:, ~real] == PAD).all()
        assert (ri[:, ~real] == pos[~real]).all()
        self.sk[:, pos[real]] = rk[:, real]
        self.si[:, pos[real]] = ri[:, real]

    # ------------------------------------------------------ the row

    def sort_row(self):
        n = 1
        while n < self.L:
            n <<= 1
        size = 2
        while size <= n:
            j = size >> 2
            if size <= W:
                if size > E:
                    self.shfl_mirror(size // E - 1)
                else:
                    self.reg_mirror(size)
            else:
                self.store_regs()
                self.barriers += 1
                self.cross_warp((size // W).bit_length() - 1, size)
                self.barriers += 1
                self.load_regs()
                j = W >> 1
            self.warp_down(j)
            size <<= 1
        self.store_regs()
        self.barriers += 1                      # before the row's copy out
        return self.sk, self.si


def _check(keys):
    sk, si = Cta(keys).sort_row()
    want = np.argsort(keys, axis=1, kind="stable")
    np.testing.assert_array_equal(si, want)
    np.testing.assert_array_equal(sk, np.take_along_axis(keys, want, 1))


def _rows(L, seed):
    """All-equal, descending, descending with ties, and random rows with
    many ties (some of them the largest key, which the virtual pads
    share: the all-ones k-mer at k = 16 and 32)."""
    rng = np.random.default_rng(seed)
    tie = rng.integers(0, max(2, L // 8), size=(4, L))
    tie[0, rng.random(L) < 0.2] = PAD
    tie[1] = np.where(rng.random(L) < 0.5, PAD, tie[1])
    return np.concatenate([
        np.full((1, L), 7),
        np.arange(L, 0, -1)[None] * 3 - (1 << 40),
        np.sort(tie[2:3], axis=1)[:, ::-1],
        tie,
        rng.integers(-(1 << 62), 1 << 62, size=(1, L)),
    ]).astype(np.int64)


def test_constants_match_the_wrapper():
    assert MAX_ROW == rowsort.MAX_ROW
    assert W == 512 and MAX_ROW // W <= 16       # at most 16 in a coset
    assert sort_threads(MAX_ROW) * E == MAX_ROW


@pytest.mark.parametrize("first", list(range(1, 521, 40)))
def test_network_sorts_stably(first):
    for L in range(first, min(first + 40, 521)):
        _check(_rows(L, L))


@pytest.mark.parametrize("L", [2047, 2048, 2049, 3000, 3072, 4097, 8191,
                               8192])
def test_network_sorts_stably_long_rows(L):
    _check(_rows(L, L))


@pytest.mark.parametrize("L", list(range(1, 17)))
def test_zero_one_principle(L):
    """Every 0-1 row of length L (a network that sorts them all sorts
    every row); the column order checks stability too."""
    bits = (np.arange(1 << L)[:, None] >> np.arange(L)) & 1
    for lo in range(0, len(bits), 4096):
        _check(bits[lo:lo + 4096].astype(np.int64))


@pytest.mark.parametrize("L,barriers", [(1, 2), (512, 2), (513, 4),
                                        (2048, 6), (3072, 8), (4096, 8),
                                        (8192, 10)])
def test_barriers_per_row(L, barriers):
    """Two barriers a stage above W (plus the copy in and out), not one a
    pass: the first version had log2(n) (log2(n) + 1) / 2, 91 at n =
    8192."""
    cta = Cta(np.zeros((1, L), np.int64))
    cta.sort_row()
    assert cta.barriers == barriers
