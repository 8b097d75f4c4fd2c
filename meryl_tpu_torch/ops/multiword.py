"""Key layout: k-mers as int64 words (counterpart of
meryl_tpu/ops/multiword.py, which models a k-mer as P = ceil(2k/32)
uint32 planes, least-significant plane first).

PyTorch on the CPU implements no uint32 shift, compare, add, cummax or
searchsorted, so the port keys a k-mer by signed int64 words:

  * k <= 32: one word holding planes 0-1; a key tensor is (...,);
  * k <= 64: two words, hi = planes 2-3 and lo = planes 0-1; a key
    tensor is (..., 2) with [..., 0] = hi and [..., 1] = lo.

Every word has bit 63 flipped, so signed int64 order equals the
unsigned A<C<T<G order of the reference.  The sentinel (padding and
invalid windows) is the word image of P all-ones planes: 0xFFFFFFFF for
k <= 16, all 64 bits for 16 < k <= 32.  It therefore aliases the real
all-ones k-mer exactly when 2k % 32 == 0, as in the reference
(meryl_tpu/ops/accum.py:28-33, meryl_tpu/ops/count.py:21-24).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kmer as km

FLIP = -(1 << 63)          # int64 with only bit 63 set
_U64 = (1 << 64) - 1


def num_words(k: int) -> int:
    return 1 if k <= 32 else 2


def sentinel_hilo(k: int) -> tuple[int, int]:
    """(hi, lo) unsigned image of P all-ones planes."""
    ones = (1 << (32 * km.num_planes(k))) - 1
    return ones >> 64, ones & _U64


def sentinel_words(k: int) -> list[int]:
    """The sentinel's flipped int64 words, most significant first."""
    hi, lo = sentinel_hilo(k)
    words = [hi, lo] if num_words(k) == 2 else [lo]
    return [w + FLIP for w in words]  # (u ^ 2^63) as int64 == u - 2^63


def sentinel(k: int, device) -> torch.Tensor:
    """Sentinel key, shaped to broadcast against a key tensor."""
    s = sentinel_words(k)
    return torch.tensor(s if len(s) == 2 else s[0], dtype=torch.int64,
                        device=device)


# ---------------------------------------------------------------- host

def to_hilo(key: np.ndarray, k: int):
    """int64 key array -> unsigned (hi, lo) uint64 arrays (kmer.py's
    host representation)."""
    u = np.ascontiguousarray(key, np.int64).view(np.uint64) ^ \
        np.uint64(1 << 63)
    if num_words(k) == 1:
        return np.zeros(len(u), np.uint64), u
    return np.ascontiguousarray(u[:, 0]), np.ascontiguousarray(u[:, 1])


def from_hilo(hi: np.ndarray, lo: np.ndarray, k: int) -> np.ndarray:
    flip = np.uint64(1 << 63)
    lo_w = (np.asarray(lo, np.uint64) ^ flip).view(np.int64)
    if num_words(k) == 1:
        return lo_w
    hi_w = (np.asarray(hi, np.uint64) ^ flip).view(np.int64)
    return np.stack([hi_w, lo_w], axis=-1)


def to_planes(key: np.ndarray, k: int) -> list[np.ndarray]:
    """int64 key array -> the reference's P uint32 planes."""
    hi, lo = to_hilo(key, k)
    return km.planes_from_hilo(hi, lo, km.num_planes(k))


def from_planes(planes, k: int) -> np.ndarray:
    hi, lo = km.hilo_from_planes([np.asarray(p) for p in planes])
    return from_hilo(hi, lo, k)


def words_from_planes_t(planes: list[torch.Tensor]) -> torch.Tensor:
    """Reference planes held as int64 tensors with values in
    [0, 2^32) -> flipped key tensor.  No step overflows int64: the top
    plane of a word enters as (plane - 2^31) * 2^32, which is that
    word's flipped signed value."""
    def word(lo_p, hi_p):
        if hi_p is None:
            return lo_p + FLIP
        return (hi_p - (1 << 31)) * (1 << 32) + lo_p

    P = len(planes)
    lo = word(planes[0], planes[1] if P > 1 else None)
    if P <= 2:
        return lo
    hi = word(planes[2], planes[3] if P > 3 else None)
    return torch.stack([hi, lo], dim=-1)


# -------------------------------------------------------------- device

def split(key: torch.Tensor, k: int) -> list[torch.Tensor]:
    """Key tensor -> list of word tensors, most significant first."""
    if num_words(k) == 1:
        return [key]
    return [key[..., 0], key[..., 1]]


def eq(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    e = a == b
    return e if num_words(k) == 1 else e.all(dim=-1)


def lt(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """Lexicographic a < b (unsigned k-mer order)."""
    if num_words(k) == 1:
        return a < b
    return (a[..., 0] < b[..., 0]) | (
        (a[..., 0] == b[..., 0]) & (a[..., 1] < b[..., 1]))


def is_sentinel(key: torch.Tensor, k: int) -> torch.Tensor:
    return eq(key, sentinel(k, key.device), k)


def where(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          k: int) -> torch.Tensor:
    """torch.where with the predicate over positions, not words."""
    if num_words(k) == 2:
        pred = pred.unsqueeze(-1)
    return torch.where(pred, a, b)


def take(key: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """Gather positions idx along the last position axis."""
    if num_words(k) == 1:
        return torch.gather(key, -1, idx)
    return torch.gather(key, -2, idx.unsqueeze(-1).expand(
        *idx.shape, 2))


def sort(key: torch.Tensor, k: int, payloads=(), stable: bool = False):
    """Sort keys along the last position axis, carrying payloads
    (tensors shaped like the key's positions).  Two words sort as two
    stable passes, lo first, then hi.  -> (sorted key, [payloads])."""
    words = split(key, k)
    if len(words) == 1:
        skey, order = torch.sort(key, dim=-1, stable=stable)
    else:
        order = torch.sort(words[1], dim=-1, stable=True).indices
        hi1 = torch.gather(words[0], -1, order)
        o2 = torch.sort(hi1, dim=-1, stable=True).indices
        order = torch.gather(order, -1, o2)
        skey = take(key, order, k)
    return skey, [torch.gather(p, -1, order) for p in payloads]


def run_starts(skey: torch.Tensor, k: int) -> torch.Tensor:
    """Run-start mask over sorted keys along the last position axis:
    True where an entry differs from its predecessor (column 0 always
    starts a run)."""
    n = skey.shape[-1] if num_words(k) == 1 else skey.shape[-2]
    if num_words(k) == 1:
        neq = skey[..., 1:] != skey[..., :-1]
    else:
        neq = (skey[..., 1:, :] != skey[..., :-1, :]).any(dim=-1)
    first = torch.ones(neq.shape[:-1] + (1,), dtype=torch.bool,
                       device=skey.device)
    return torch.cat([first, neq], dim=-1) if n else neq
