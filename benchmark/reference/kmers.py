"""Brute-force canonical k-mers in plain PyTorch, on any device.

A k-mer's key is its 2k bits with the first base highest (A=0, C=1,
T=2, G=3); its canonical key is the smaller of the keys of the k-mer
and of its reverse complement.  A window of k bases counts when it
holds no N and, unless `boundaries` is false, lies inside one read.
`boundaries=False` is the benchmark's control: it reads the reads as one
stream, so windows across the join of two reads count too.
"""

from __future__ import annotations

import numpy as np
import torch

K_MAX = 31          # keys stay below 2^62 in int64

CHUNK_BASES = 1 << 26


def _check_k(k: int) -> None:
    if not 1 <= k <= K_MAX:
        raise ValueError(f"the reference handles 1 <= k <= {K_MAX}, "
                         f"got {k}")


def window_keys(codes: torch.Tensor, lens: torch.Tensor, k: int,
                boundaries: bool = True):
    """codes (T,) uint8 of consecutive reads of lengths `lens` ->
    (canonical key, valid), both (T,): entry i is the window starting
    at i (invalid where fewer than k bases follow)."""
    _check_k(k)
    T = codes.numel()
    dev = codes.device
    key = torch.zeros(T, dtype=torch.int64, device=dev)
    valid = torch.zeros(T, dtype=torch.bool, device=dev)
    W = T - k + 1
    if W <= 0:
        return key, valid
    c = codes.to(torch.int64)
    f = torch.zeros(W, dtype=torch.int64, device=dev)
    r = torch.zeros(W, dtype=torch.int64, device=dev)
    for j in range(k):
        cj = c[j:j + W] & 3
        f.bitwise_left_shift_(2).bitwise_or_(cj)
        r.bitwise_or_((cj ^ 2).bitwise_left_shift_(2 * j))
    bad = torch.zeros(T + 1, dtype=torch.int64, device=dev)
    torch.cumsum(codes == 4, 0, out=bad[1:])
    ok = (bad[k:] - bad[:W]) == 0
    if boundaries:
        ends = torch.cumsum(lens.to(dev), 0)
        end_at = torch.repeat_interleave(ends, lens.to(dev))
        ok &= torch.arange(W, device=dev) + k <= end_at[:W]
    key[:W] = torch.minimum(f, r)
    valid[:W] = ok
    return key, valid


def _chunks(lens: np.ndarray, chunk_bases: int):
    """Read-aligned [a, b) read ranges of about chunk_bases bases."""
    ends = np.cumsum(lens)
    a = 0
    while a < lens.size:
        base0 = ends[a - 1] if a else 0
        b = int(np.searchsorted(ends, base0 + chunk_bases, "right"))
        b = max(b, a + 1)
        yield a, b
        a = b


def count(codes: np.ndarray, lens: np.ndarray, k: int, device,
          boundaries: bool = True, chunk_bases: int = CHUNK_BASES):
    """Counts of canonical k-mers -> (keys, counts): int64 numpy arrays,
    keys ascending.  Reads are taken a chunk of about chunk_bases bases
    at a time (with boundaries off, the chunks are joined too)."""
    lens = np.asarray(lens, np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)])
    keys, cnts = [], []
    for a, b in _chunks(lens, chunk_bases):
        s, e = int(starts[a]), int(starts[b])
        if not boundaries and b < lens.size:
            e = min(int(starts[-1]), e + k - 1)   # the join to the next
        c = torch.from_numpy(np.ascontiguousarray(codes[s:e])).to(device)
        ln = torch.from_numpy(lens[a:b].copy())
        key, valid = window_keys(c, ln, k, boundaries)
        if not boundaries:
            valid[int(starts[b]) - s:] = False    # the next chunk's own
        u, n = torch.unique(key[valid], return_counts=True)
        keys.append(u)
        cnts.append(n)
        del c, key, valid
    if not keys:
        z = np.zeros(0, np.int64)
        return z, z.copy()
    return _merge(keys, cnts)


def _merge(keys, cnts):
    if len(keys) == 1:
        return keys[0].cpu().numpy(), cnts[0].cpu().numpy()
    allk = torch.cat(keys)
    u, inv = torch.unique(allk, return_inverse=True)
    n = torch.zeros(u.numel(), dtype=torch.int64, device=allk.device)
    n.scatter_add_(0, inv, torch.cat(cnts))
    return u.cpu().numpy(), n.cpu().numpy()


def existence(codes: np.ndarray, lens: np.ndarray, k: int, tables, device,
              boundaries: bool = True):
    """meryl-lookup -existence: for each read its valid windows, and for
    each table (sorted int64 keys) the windows whose canonical key is in
    it.  -> (n_total (R,), [n_found (R,) a table]) int64 numpy."""
    lens = np.asarray(lens, np.int64)
    c = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
    ln = torch.from_numpy(lens.copy())
    key, valid = window_keys(c, ln, k, boundaries)
    rid = torch.repeat_interleave(torch.arange(lens.size, device=device),
                                  ln.to(device))
    R = lens.size

    def per_read(mask):
        out = torch.zeros(R, dtype=torch.int64, device=device)
        out.scatter_add_(0, rid, mask.to(torch.int64))
        return out.cpu().numpy()

    found = []
    for t in tables:
        tk = torch.from_numpy(np.ascontiguousarray(t, np.int64)).to(device)
        if tk.numel() == 0:
            found.append(np.zeros(R, np.int64))
            continue
        i = torch.searchsorted(tk, key).clamp_(max=tk.numel() - 1)
        found.append(per_read(valid & (tk[i] == key)))
    return per_read(valid), found
