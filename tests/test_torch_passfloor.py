"""The pass-floor kernel's index arithmetic, replayed in numpy.

meryl_tpu_torch/csrc/rowsort.cu runs only on the card.  This file
replays its pass floor (`mt_pass_floor`, `pass_floor_flat`,
`pass_floor_rows`) on numpy arrays with the kernel's own FLOOR_THREADS,
FLOOR_QUADS, WARP and MAX_ROW, read from the source, and checks that the
lines it mirrors are still the source's:

  * the host's choice for even L: a head of at most one pair by the
    input's (else the output's) 4-byte phase, the quads, a tail of at
    most one pair, and the widest access each side's alignment allows
    (one int4, two int2 or four words);
  * the flat kernel's grid-stride walk over tiles of FLOOR_THREADS x
    FLOOR_QUADS quads for any grid, each thread's quads, the head and
    tail pairs on threads 0 and 1 of CTA 0;
  * the odd-L row path: a warp a row, its lanes over the row's pairs,
    lane 0 copying the last element.

Memory is modelled as the two tensors at byte addresses with every
offset mod 16: each access is checked against its bounds and its
width's alignment, and every output word must be stored exactly once.
Every replay is held against the plain version (rowsort.pass_floor_plain,
itself held against the probe's Pallas kernel in test_torch_rowsort.py);
tests/test_torch_cuda.py holds the kernel itself against it on the card.
"""

import os
import re

import numpy as np
import pytest
import torch

from meryl_tpu_torch.ops import rowsort

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "meryl_tpu_torch", "csrc", "rowsort.cu")


def _source():
    with open(SRC) as f:
        return f.read()


def _source_consts(text):
    got = {}
    for name in ("MAX_ROW", "WARP", "FLOOR_THREADS", "FLOOR_QUADS"):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        assert m, f"constexpr int {name} not found in rowsort.cu"
        got[name] = int(m.group(1))
    return got


_C = _source_consts(_source())
T, Q, WARP = _C["FLOOR_THREADS"], _C["FLOOR_QUADS"], _C["WARP"]
TILE = T * Q
# grids the host may take: min(tiles, resident CTAs) for a card that
# holds 1, 3 or 132 x 8 CTAs at once
RESIDENT = [1, 3, 132 * 8]

# the source lines this file replays (whitespace collapsed)
MIRRORED = [
    "return phase == 0 ? 4 : phase == 2 ? 2 : 1;",
    "const int head = (px == 2 || (px % 2 && po == 2)) ? 1 : 0;",
    "const int64_t n_quads = (pairs - head) / 2;",
    "const int tail = (int)(pairs - head - 2 * n_quads);",
    "flat_for(quad_words(ax + 8 * head), quad_words(ao + 8 * head))",
    "const int grid = (int)(tiles < ctas ? (tiles > 0 ? tiles : 1) : ctas);",
    "const int64_t e = threadIdx.x == 0 ? 0 : 2 * head + 4 * n_quads;",
    "for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {",
    "const int64_t i = t * TILE + q * FLOOR_THREADS + threadIdx.x;",
    "load_quad<VL>(xq + 4 * i, v + 4 * q);",
    "if (i < n_quads) store_quad<VS>(oq + 4 * i, v + 4 * q);",
    "r += (int64_t)gridDim.x * WARPS) {",
    "for (int j = lane; j < L / 2; j += WARP) {",
    "if (lane == 0) orow[L - 1] = xr[L - 1];",
    "const int64_t need = (R + WARPS - 1) / WARPS;",
]


# ------------------------------------------------------------ memory

class Side:
    """A tensor of int32 words at byte address `addr`.  Each access of V
    words is checked against the bounds and the alignment of 4 V bytes;
    each word stored is counted."""

    def __init__(self, words, addr):
        self.w = np.array(words, np.int32)
        self.addr = addr
        self.stores = np.zeros(len(self.w), np.int64)

    def _pos(self, start, V):
        start = np.asarray(start, np.int64)
        assert ((self.addr + 4 * start) % (4 * V) == 0).all(), "misaligned"
        assert (start >= 0).all() and (start + V <= len(self.w)).all()
        return start[..., None] + np.arange(V)

    def load(self, start, V):
        return self.w[self._pos(start, V)]

    def store(self, start, vals, V):
        pos = self._pos(start, V)
        self.w[pos] = vals
        np.add.at(self.stores, pos.ravel(), 1)


def load_quad(side, start, V):
    """load_quad<V>: the four words from `start`, 4 / V accesses."""
    return np.concatenate([side.load(start + k * V, V)
                           for k in range(4 // V)], axis=-1)


def store_quad(side, start, vals, V):
    for k in range(4 // V):
        side.store(start + k * V, vals[..., k * V:(k + 1) * V], V)


def floor_pass(v):
    """One pass over the pairs (v[..., 2i], v[..., 2i + 1])."""
    a, b = v[..., 0::2].copy(), v[..., 1::2].copy()
    v[..., 0::2] = np.minimum(a, b)
    v[..., 1::2] = np.maximum(a, b)


def floor_passes(v, passes, count=None):
    """`passes` passes, two a trip of the loop and the odd one after;
    `count` (a list) collects one entry a pass run."""
    p = 1
    while p < passes:
        for _ in range(2):
            floor_pass(v)
            if count is not None:
                count.append(p)
        p += 2
    if passes & 1:
        floor_pass(v)
        if count is not None:
            count.append(passes)
    return v


# ---------------------------------------------------------- the host

def quad_words(addr):
    phase = (addr >> 2) & 3
    return 4 if phase == 0 else 2 if phase == 2 else 1


def plan_flat(R, L, ax, ao):
    """mt_pass_floor for even L -> (head, n_quads, tail, VL, VS)."""
    pairs = R * (L // 2)
    px, po = (ax >> 2) & 3, (ao >> 2) & 3
    head = 1 if (px == 2 or (px % 2 and po == 2)) else 0
    n_quads = (pairs - head) // 2
    tail = pairs - head - 2 * n_quads
    return (head, n_quads, tail, quad_words(ax + 8 * head),
            quad_words(ao + 8 * head))


# ------------------------------------------------------- the kernels

def run_flat(x, out, head, n_quads, tail, passes, VL, VS, ctas):
    tiles = -(-n_quads // TILE)
    grid = (tiles if tiles > 0 else 1) if tiles < ctas else ctas
    for flag, e in ((head, 0), (tail, 2 * head + 4 * n_quads)):
        if flag:                               # threads 0 and 1 of CTA 0
            v = np.concatenate([x.load(np.array([e]), 1),
                                x.load(np.array([e + 1]), 1)], axis=-1)
            out.store(np.array([e]), floor_passes(v, passes)[:, :1], 1)
            out.store(np.array([e + 1]), v[:, 1:], 1)
    n_it = -(-tiles // grid)
    t = np.arange(grid)[:, None] + np.arange(n_it)[None, :] * grid
    i = (t[:, :, None, None] * TILE + np.arange(Q)[:, None] * T
         + np.arange(T)[None, :])                    # (grid, it, Q, T)
    ok = (t < tiles)[:, :, None, None] & (i < n_quads)
    v = np.zeros(i.shape + (4,), np.int32)
    v[ok] = load_quad(x, 2 * head + 4 * i[ok], VL)
    regs = v.transpose(0, 1, 3, 2, 4).reshape(grid, n_it, T, 4 * Q)
    floor_passes(regs, passes)
    v = regs.reshape(grid, n_it, T, Q, 4).transpose(0, 1, 3, 2, 4)
    store_quad(out, 2 * head + 4 * i[ok], v[ok], VS)


def run_rows(x, out, R, L, passes, ctas):
    warps = T // WARP
    need = -(-R // warps)
    grid = min(need, ctas)
    w = np.arange(grid * warps)
    n_it = -(-R // (grid * warps))
    r = (w[:, None] + np.arange(n_it)[None, :] * grid * warps).ravel()
    r = r[r < R]
    assert np.array_equal(np.sort(r), np.arange(R)), "a warp a row, once"
    m = -(-(L // 2) // WARP)
    j = (np.arange(WARP)[:, None] + np.arange(m)[None, :] * WARP).ravel()
    j = j[j < L // 2]                                 # each lane's pairs
    e = (r[:, None] * L + 2 * j[None, :]).ravel()
    v = np.stack([x.load(e, 1)[:, 0], x.load(e + 1, 1)[:, 0]], axis=-1)
    floor_passes(v, passes)
    out.store(e, v[:, :1], 1)
    out.store(e + 1, v[:, 1:], 1)
    last = r * L + L - 1                              # lane 0
    out.store(last, x.load(last, 1), 1)


def replay(data, R, L, ax, ao, passes, ctas):
    """The kernel on `data` (R * L int32) with the input at byte address
    `ax` and the output at `ao` -> (output words, stores per word)."""
    x, out = Side(data, ax), Side(np.full(R * L, -7, np.int32), ao)
    if L % 2:
        run_rows(x, out, R, L, passes, ctas)
    else:
        head, n_quads, tail, VL, VS = plan_flat(R, L, ax, ao)
        run_flat(x, out, head, n_quads, tail, passes, VL, VS, ctas)
    assert np.array_equal(x.w, data), "the input is only read"
    return out.w, out.stores


# ------------------------------------------------------------- tests

def test_source_is_what_this_file_replays():
    text = " ".join(_source().split())
    for line in MIRRORED:
        assert " ".join(line.split()) in text, line
    assert _C["MAX_ROW"] == rowsort.MAX_ROW
    body = text[text.index("pass_floor_flat(const"):
                text.index("int sort_threads(int L)")]
    assert "__shared__" not in body and "__syncthreads" not in body
    assert ("#pragma unroll 1 for (int p = 1; p < passes; p += 2) { "
            "floor_pass(v); floor_pass(v); } if (passes & 1) floor_pass(v);"
            in text)
    assert 'asm volatile("" : "+r"(v[i]), "+r"(v[i + 1]));' in text


@pytest.mark.parametrize("passes", [0, 1, 2, 3, 65, 66])
def test_every_pass_runs(passes):
    """Two passes a trip and the odd one after: as many passes run as
    the count asks, none folded into another."""
    ran = []
    floor_passes(np.zeros((1, 8), np.int32), passes, ran)
    assert len(ran) == passes


@pytest.mark.parametrize("px", range(4))
@pytest.mark.parametrize("po", range(4))
def test_flat_plan_is_the_widest_aligned(px, po):
    """For every pair of 4-byte phases: a head only when it aligns a
    side that can be aligned, then the widest access each side allows,
    and every quad of both sides aligned to it."""
    R, L = 3, 2048
    head, n_quads, tail, VL, VS = plan_flat(R, L, 64 + 4 * px, 256 + 4 * po)
    assert head + 2 * n_quads + tail == R * L // 2 and tail in (0, 1)
    for p, V in ((px, VL), (po, VS)):
        ph = (p + 2 * head) % 4
        assert V == {0: 4, 2: 2}.get(ph, 1)
    if px % 2 == 0:
        assert VL == 4                      # an even input always gets int4
    if px % 2 and po % 2 == 0:
        assert VS == 4
    if px % 2 == 0 and po % 2 == 0 and (px - po) % 4 == 0:
        assert VL == VS == 4


LS = [1, 2, 3, 7, 33, 999, 2047, 2048, 5120, 8191, 8192]


@pytest.mark.parametrize("off", [0, 4, 8, 12])
@pytest.mark.parametrize("R", [1, 3, 64])
@pytest.mark.parametrize("L", LS)
def test_replay_matches_plain(L, R, off):
    """Input at every offset mod 16, output at every offset, each grid:
    the plain version's words, each output word stored once."""
    rng = np.random.default_rng(L * 131 + R * 7 + off)
    data = rng.integers(-(1 << 31), 1 << 31, size=R * L,
                        dtype=np.int64).astype(np.int32)
    want = rowsort.pass_floor_plain(
        torch.from_numpy(data.reshape(R, L))).numpy().ravel()
    ax = 4096 + off
    for oo in (0, 4, 8, 12):
        for ctas in RESIDENT:
            got, stores = replay(data, R, L, ax, 8192 + oo, 1, ctas)
            np.testing.assert_array_equal(got, want)
            assert (stores == 1).all()
    got, stores = replay(data, R, L, ax, 8192, 0, RESIDENT[-1])
    np.testing.assert_array_equal(got, data)          # 0 passes: a copy
    got, stores = replay(data, R, L, ax, 8192 + off, rowsort.FLOOR_PASSES,
                         RESIDENT[-1])
    np.testing.assert_array_equal(got, want)
    assert (stores == 1).all()


def test_probe_shape_fills_whole_waves():
    """The probe's 2^13 x 2048 rows: int4 both ways, no head or tail,
    and the grid of the card's resident CTAs walks every tile."""
    R, L = 1 << 13, 2048
    head, n_quads, tail, VL, VS = plan_flat(R, L, 0, 0)
    assert (head, tail, VL, VS) == (0, 0, 4, 4)
    tiles = n_quads // TILE
    assert n_quads % TILE == 0 and tiles > RESIDENT[-1]
