"""Inputs shared by the set-op parity tests of meryl_tpu_torch: sorted
k-mer inputs made from a seed with numpy, packed flat or in rows as
meryl_tpu's evaluator packs them, and the comparison of both packages'
merge outputs."""

import numpy as np
import torch

from meryl_tpu import kmer as km
from meryl_tpu.optree import BucketEvaluator as RefEvaluator
from meryl_tpu_torch.ops import multiword as mw
from meryl_tpu_torch.ops import setops

ALL_OPS = sorted(setops.MERGE_OPS | setops.FILTER_OPS | setops.MATH_OPS)
MS = (1, 2, 3, 17)
KS = (16, 21, 32, 33, 64)
THRESHOLDS = (0, 3, 0xFFFFFFF0)
CASES = [(op, m) for op in ALL_OPS for m in MS]


def case_k(op, m):
    """Spread the key widths over the cases (one compile per case)."""
    return KS[(ALL_OPS.index(op) + MS.index(m)) % len(KS)]


def values(rng, n):
    v = rng.integers(1, 40, size=n)
    big = rng.random(n) < 0.3
    v[big] = rng.integers((1 << 32) - 64, 1 << 32, size=int(big.sum()))
    return v.astype(np.uint32)


def keys(rng, n, k):
    """n random distinct k-mers as (hi, lo) uint64, the all-ones k-mer
    among them."""
    bits = 2 * k
    lo_bits = min(bits, 64)
    lo = rng.integers(0, 1 << 62, size=n, dtype=np.uint64) * np.uint64(4) \
        + rng.integers(0, 4, size=n).astype(np.uint64)
    if lo_bits < 64:
        lo &= np.uint64((1 << lo_bits) - 1)
    hi = np.zeros(n, np.uint64)
    if bits > 64:
        hi = rng.integers(0, 1 << (bits - 64), size=n, dtype=np.uint64)
    hi[0] = (1 << max(bits - 64, 0)) - 1 if bits > 64 else 0
    lo[0] = (1 << lo_bits) - 1
    key = np.unique((hi.astype(object) << 64) | lo.astype(object))
    return (np.array([int(x) >> 64 for x in key], np.uint64),
            np.array([int(x) & ((1 << 64) - 1) for x in key], np.uint64))


def inputs(seed, m, k, n_pool=160, multiset=None):
    """m sorted inputs drawn from one key pool (so keys overlap across
    inputs), each holding the all-ones k-mer (the pool's last key).  A
    multiset input repeats some keys with other values."""
    rng = np.random.default_rng(seed)
    phi, plo = keys(rng, n_pool, k)
    ins = []
    for i in range(m):
        pick = np.sort(rng.choice(len(plo), size=int(rng.integers(
            n_pool // 4, n_pool)), replace=False))
        pick = np.unique(np.append(pick, len(plo) - 1))
        if multiset and multiset[i]:
            pick = np.sort(np.concatenate(
                [pick, rng.choice(pick, size=len(pick) // 2)]))
        ins.append((phi[pick], plo[pick], values(rng, len(pick))))
    return ins


def flat(ins, m, k):
    """The flat packing of eval_buckets: inputs concatenated, padded to
    a power of two with the sentinel, value 0 and input id m."""
    P = km.num_planes(k)
    total = sum(len(c) for _, _, c in ins)
    N = RefEvaluator._pad_to(total)
    planes = [np.full(N, 0xFFFFFFFF, np.uint32) for _ in range(P)]
    values = np.zeros(N, np.uint32)
    ids = np.full(N, m, np.int32)
    pos = 0
    for i, (hi, lo, c) in enumerate(ins):
        n = len(c)
        for p, arr in enumerate(km.planes_from_hilo(hi, lo, P)):
            planes[p][pos:pos + n] = arr
        values[pos:pos + n] = c
        ids[pos:pos + n] = i
        pos += n
    return planes, values, ids


def rows(ins, m, k):
    ev = RefEvaluator(k)
    ev.ROW_TARGET = 64
    return ev._pack_rows(ins, m)


def port_args(planes, values, ids, k):
    shape = planes[0].shape
    key = mw.from_planes([p.reshape(-1) for p in planes], k)
    key = key.reshape(shape + key.shape[1:])
    return (torch.from_numpy(np.ascontiguousarray(key)),
            torch.from_numpy(values.astype(np.int64)),
            torch.from_numpy(ids.astype(np.int32)))


def assert_same(ref_out, port_out, k):
    rplanes, rvals, rkeep = ref_out
    skey, vals, keep = port_out
    rplanes = [np.asarray(p).reshape(-1) for p in rplanes]
    got_planes = mw.to_planes(skey.numpy(), k)
    for g, w in zip(got_planes, rplanes):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep))
    np.testing.assert_array_equal(vals.numpy(),
                                  np.asarray(rvals).astype(np.int64))
