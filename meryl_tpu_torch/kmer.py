"""Host-side k-mer codec for the TPU-native meryl engine.

Encoding contract (required for decoded parity with reference meryl):
  2-bit codes  A=00, C=01, T=10, G=11  -- i.e. sort order A < C < T < G.
  A k-mer of length k is the 2k-bit integer with the FIRST base in the
  MOST significant bits (reference: kmerTiny::addR right-append; sort
  order defined in meryl src/meryl2/merylSelector.H:87-94 and
  documentation/source/reference.rst:538-566).
  Complement of a code is code ^ 0b10 (A<->T, C<->G).
  Canonical k-mer = min(fmer, rmer) under this integer order
  (meryl src/meryl/merylOp-countThreads.C:246).

k is limited to 64 (128-bit payload, reference `kmdata`); values are
uint32 (`kmvalu`, reference documentation/source/reference.rst:48-50).

Host representation of kmer arrays: a pair of uint64 numpy arrays
(hi, lo) where kmer = hi << 64 | lo.  Device representation: P = ceil(2k/32)
uint32 "planes", plane p = bits [32p, 32p+32).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import _build

K_MAX = 64
VALUE_MAX = 0xFFFFFFFF  # kmvalu max

ALPHABET = "ACTG"  # index by 2-bit code

# char -> 2-bit code; 255 = invalid (breaks kmers, like reference kmerIterator)
CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(ALPHABET):
    CODE_LUT[ord(_c)] = _i
    CODE_LUT[ord(_c.lower())] = _i

# code complement: A<->T (00<->10), C<->G (01<->11)  == code ^ 2
COMP = np.array([2, 3, 0, 1], dtype=np.uint8)


def num_planes(k: int) -> int:
    """Number of 32-bit device planes for a k-mer of size k."""
    return max(1, (2 * k + 31) // 32)


def encode_bases(seq) -> np.ndarray:
    """ASCII bytes/str -> uint8 code array (255 where not ACGTacgt)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    buf = np.frombuffer(bytes(seq), dtype=np.uint8)
    return CODE_LUT[buf]


EXC_PAD = np.int32(0x7FFFFFFF)  # out-of-bounds: device scatter drops it


# chunks packed by each path of pack_codes_2bit, since the process began
PACK_STATS = {"native": 0, "numpy": 0}
_stats_lock = threading.Lock()
_pack_fn = None          # the native pass; False once it failed to build


def _native_pack():
    """The native pass (csrc/pack_host.cpp), built at first use, or None
    when it cannot be built or MERYL_TPU_NO_NATIVE is set."""
    global _pack_fn
    if os.environ.get("MERYL_TPU_NO_NATIVE"):
        return None
    if _pack_fn is None:
        try:
            fn = _build.load("pack_host", ".cpp").mt_pack_2bit
        except (OSError, RuntimeError):
            _pack_fn = False
        else:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.POINTER(ctypes.c_int64)]
            fn.restype = ctypes.c_int64
            _pack_fn = fn
    return _pack_fn or None


def _exc_cap(L: int, n_exc: int) -> int:
    """Length of the padded exception list: the floor L/64 (one
    separator per >=64-base read), so typical chunks share one shape,
    as a power of two; a denser list (short reads, N floods) grows to
    the next power of two."""
    floor = max(16, L >> 6)
    floor = 1 << (floor - 1).bit_length()
    return floor if n_exc <= floor else 1 << int(n_exc - 1).bit_length()


def pack_codes_2bit(codes: np.ndarray, pad_to: int | None = None):
    """uint8 code chunk -> packed wire format for
    ops/extract.extract_kmers_packed: 2-bit codes 16 per uint32 word
    (code j of word w at bits 2*(j mod 16), little-endian byte order)
    plus an exception list of non-ACGT positions (INT32_MAX padded to
    a power of two, _exc_cap, so the device sees few shapes).

    -> (packed2 (ceil(L/16),) u32, exc (E_pad,) i32, n_real).
    n_real = 1 + last valid position: the device invalidates every
    window at or past n_real - k + 1, so a trailing separator run (the
    chunker's final-chunk padding) costs NO exception entries.
    Cuts host->device wire bytes 4x vs uint8 codes; the device scatter
    that restores mid-stream exceptions costs ~7 ns each.

    One native pass over the codes (csrc/pack_host.cpp) that releases
    the GIL; _pack_codes_numpy, the plain version, where it is not
    built.  Every call returns fresh arrays."""
    L = pad_to if pad_to is not None else len(codes)
    L = (L + 15) & ~15
    if L < len(codes):       # the native pass writes L / 16 words
        raise ValueError(f"pad_to {pad_to} < {len(codes)} codes")
    fn = _native_pack()
    with _stats_lock:
        PACK_STATS["numpy" if fn is None else "native"] += 1
    if fn is None:
        return _pack_codes_numpy(codes, L)
    codes = np.ascontiguousarray(codes, np.uint8)
    packed2 = np.empty(L // 16, "<u4")
    n_real = ctypes.c_int64()
    cap = _exc_cap(L, 0)
    while True:
        exc = np.empty(cap, np.int32)
        n_exc = fn(codes.ctypes.data, len(codes), L, packed2.ctypes.data,
                   exc.ctypes.data, cap, ctypes.byref(n_real))
        if n_exc <= cap:
            break
        cap = _exc_cap(L, n_exc)     # an N flood: pack again into more
    exc[n_exc:] = EXC_PAD
    return packed2, exc, n_real.value


def _pack_codes_numpy(codes: np.ndarray, L: int):
    """pack_codes_2bit in numpy, L the padded length."""
    ok = codes <= 3
    nz = np.flatnonzero(ok)
    n_real = int(nz[-1]) + 1 if len(nz) else 0
    exc = np.flatnonzero(~ok[:n_real]).astype(np.int32)
    c4 = np.where(ok, codes, 0).astype(np.uint8)
    if len(c4) != L:
        c4 = np.concatenate([c4, np.zeros(L - len(c4), np.uint8)])
    c4 = c4.reshape(-1, 4)
    by = (c4[:, 0] | (c4[:, 1] << 2) | (c4[:, 2] << 4)
          | (c4[:, 3] << 6)).astype(np.uint8)
    packed2 = np.ascontiguousarray(by).view("<u4")
    exc_p = np.full(_exc_cap(L, len(exc)), EXC_PAD, np.int32)
    exc_p[:len(exc)] = exc
    return packed2, exc_p, n_real


def string_to_kmer(s: str) -> int:
    """k-mer string -> 2k-bit integer (python int)."""
    v = 0
    for ch in s:
        c = int(CODE_LUT[ord(ch)])
        if c == 255:
            raise ValueError(f"invalid base {ch!r}")
        v = (v << 2) | c
    return v


def kmer_to_string(v: int, k: int) -> str:
    """2k-bit integer -> k-mer string (first base from MSBs)."""
    out = []
    for i in range(k):
        out.append(ALPHABET[(v >> (2 * (k - 1 - i))) & 3])
    return "".join(out)


def revcomp_kmer(v: int, k: int) -> int:
    """Reverse complement of a 2k-bit kmer integer."""
    r = 0
    for _ in range(k):
        r = (r << 2) | ((v & 3) ^ 2)
        v >>= 2
    return r


def revcomp_string(s: str) -> str:
    m = {"A": "T", "C": "G", "G": "C", "T": "A",
         "a": "t", "c": "g", "g": "c", "t": "a"}
    return "".join(m[c] for c in reversed(s))


def canonical_kmer(v: int, k: int) -> int:
    r = revcomp_kmer(v, k)
    return v if v < r else r


def recanonicalize_acgt(v: int, k: int) -> int:
    """Return the strand of kmer v that is canonical under ACGT (standard
    lexicographic) order rather than meryl's ACTG order.  Used by
    `printACGT` (reference merylOp-nextMer.C:666-669,
    kmer::recanonicalizeACGTorder)."""
    s = kmer_to_string(v, k)
    r = revcomp_string(s)
    return string_to_kmer(min(s, r))


def hilo_from_int(v: int) -> tuple[int, int]:
    return (v >> 64) & 0xFFFFFFFFFFFFFFFF, v & 0xFFFFFFFFFFFFFFFF


def int_from_hilo(hi: int, lo: int) -> int:
    return (int(hi) << 64) | int(lo)


def planes_from_hilo(hi: np.ndarray, lo: np.ndarray, nplanes: int):
    """(hi, lo) uint64 arrays -> list of uint32 plane arrays, LSB plane first."""
    hi = np.asarray(hi, dtype=np.uint64)
    lo = np.asarray(lo, dtype=np.uint64)
    planes = []
    for p in range(nplanes):
        if p < 2:
            planes.append(((lo >> np.uint64(32 * p)) & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        else:
            planes.append(((hi >> np.uint64(32 * (p - 2))) & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return planes


def hilo_from_planes(planes) -> tuple[np.ndarray, np.ndarray]:
    """List of uint32 plane arrays (LSB first) -> (hi, lo) uint64 arrays."""
    n = len(planes[0])
    hi = np.zeros(n, dtype=np.uint64)
    lo = np.zeros(n, dtype=np.uint64)
    for p, pl in enumerate(planes):
        pl = np.asarray(pl, dtype=np.uint64)
        if p < 2:
            lo |= pl << np.uint64(32 * p)
        else:
            hi |= pl << np.uint64(32 * (p - 2))
    return hi, lo


def prefix6_from_hilo(hi: np.ndarray, lo: np.ndarray, k: int) -> np.ndarray:
    """Top 6 bits of the 2k-bit kmer = DB file id (0..63).

    Matches the reference's 64-way file partitioning (reference
    documentation/source/reference.rst:71-81)."""
    hi = np.asarray(hi, dtype=np.uint64)
    lo = np.asarray(lo, dtype=np.uint64)
    shift = 2 * k - 6
    if shift < 0:
        # k <= 2: fewer than 6 kmer bits; spread the whole kmer over
        # the 6-bit file space (any monotone map works — writer and
        # readers share this function)
        return ((lo << np.uint64(-shift)) & np.uint64(63)).astype(
            np.uint32)
    if shift >= 64:
        return ((hi >> np.uint64(shift - 64)) & np.uint64(63)).astype(np.uint32)
    # kmer spans hi:lo boundary only when 2k > 64; for 2k <= 64 all in lo
    if 2 * k <= 64:
        return ((lo >> np.uint64(shift)) & np.uint64(63)).astype(np.uint32)
    # 64 < 2k < 70: top bits split between hi and lo
    nhi = 2 * k - 64          # bits of kmer in hi
    need_lo = 6 - nhi         # bits to take from top of lo
    top = (hi & ((np.uint64(1) << np.uint64(nhi)) - np.uint64(1))) << np.uint64(need_lo)
    top |= lo >> np.uint64(64 - need_lo)
    return (top & np.uint64(63)).astype(np.uint32)


def kmer_strings_to_hilo(strings) -> tuple[np.ndarray, np.ndarray]:
    hi = np.empty(len(strings), dtype=np.uint64)
    lo = np.empty(len(strings), dtype=np.uint64)
    for i, s in enumerate(strings):
        v = string_to_kmer(s)
        hi[i], lo[i] = (v >> 64) & 0xFFFFFFFFFFFFFFFF, v & 0xFFFFFFFFFFFFFFFF
    return hi, lo


_BYTE_CHARS = None        # (256, 4) uint8: byte -> chars of its 4 codes


def _byte_chars():
    global _BYTE_CHARS
    if _BYTE_CHARS is None:
        b = np.arange(256, dtype=np.uint16)
        codes = np.stack([(b >> (2 * t)) & 3 for t in range(4)], axis=1)
        lut = np.frombuffer(ALPHABET.encode(), dtype=np.uint8)
        _BYTE_CHARS = lut[codes]
    return _BYTE_CHARS


def hilo_to_char_matrix(hi: np.ndarray, lo: np.ndarray, k: int):
    """Vectorized decode of (hi, lo) kmer arrays into an (n, k) uint8
    matrix of ASCII bases: one 256->4-chars table gather per byte
    instead of 2k shift passes (a 2-bit code never spans a byte, and
    the hi/lo boundary is at bit 64)."""
    n = len(lo)
    lo = np.ascontiguousarray(lo, dtype="<u8")
    # little-endian byte j of lo holds the codes at shifts 8j..8j+6,
    # so flat column c (= 4j + t) holds the char of shift 2c
    flat = _byte_chars()[lo.view(np.uint8).reshape(n, 8)].reshape(n, 32)
    if k > 32:
        hi = np.ascontiguousarray(hi, dtype="<u8")
        fhi = _byte_chars()[hi.view(np.uint8).reshape(n, 8)].reshape(n, 32)
        flat = np.concatenate([flat, fhi], axis=1)
    # char position i has shift 2*(k-1-i): reverse the first k columns
    return np.ascontiguousarray(flat[:, k - 1::-1])


def recanonicalize_chars(chars: np.ndarray) -> np.ndarray:
    """Re-canonicalize an (n, k) ASCII base matrix so each row is the
    lexicographically smaller of itself and its reverse complement in
    STANDARD ACGT order (printACGT semantics) — vectorized."""
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    rc = comp[chars][:, ::-1]
    neq = chars != rc
    has = neq.any(axis=1)
    first = np.argmax(neq, axis=1)
    rows = np.arange(len(chars))
    take = has & (rc[rows, first] < chars[rows, first])
    out = chars.copy()
    out[take] = rc[take]
    return out


def concat_codes_with_breakers(codes_list):
    """Concatenate per-read 2-bit code arrays with one 0xFF breaker
    after each (breakers invalidate cross-read kmer windows, so a
    batch queries as one buffer).  -> (buf, offs, lens): the buffer,
    each read's start offset, and each read's code length."""
    n = len(codes_list)
    lens = np.fromiter((len(c) for c in codes_list), np.int64, n)
    buf = np.full(int(lens.sum()) + n, 255, np.uint8)
    offs = np.empty(n, np.int64)
    pos = 0
    for i, c in enumerate(codes_list):
        offs[i] = pos
        buf[pos:pos + len(c)] = c
        pos += len(c) + 1
    return buf, offs, lens


def codes_to_hilo(codes: np.ndarray):
    """(n, k) 2-bit code matrix (leftmost base first) -> (hi, lo)
    uint64 arrays, vectorized (k bitwise passes)."""
    n, k = codes.shape
    hi = np.zeros(n, np.uint64)
    lo = np.zeros(n, np.uint64)
    for j in range(k):
        shift = 2 * (k - 1 - j)
        c = codes[:, j].astype(np.uint64)
        if shift >= 64:
            hi |= c << np.uint64(shift - 64)
        else:
            lo |= c << np.uint64(shift)
    return hi, lo


def hilo_to_strings(hi: np.ndarray, lo: np.ndarray, k: int):
    """Vectorized decode of (hi, lo) kmer arrays into ACTG strings."""
    chars = hilo_to_char_matrix(hi, lo, k)
    return chars.view(f"S{k}").ravel().astype(str)
