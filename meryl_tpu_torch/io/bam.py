"""BAM ingestion (no external dependencies).

The reference vendors htslib for BAM/CRAM decoding
(meryl src/utility — src/main.mk:92-140).  Here BAM is decoded
directly: BGZF is a multi-member gzip stream (python's gzip module
handles member concatenation transparently) and BAM alignment records
are a fixed little-endian layout with 4-bit packed bases.

CRAM's reference-based codec stack lives in io.cram (dependency-free
CRAM 3.0).

All records (including secondary/supplementary alignments) are yielded
as stored; canonical counting is strand-insensitive so the alignment
orientation does not affect counts.
"""

from __future__ import annotations

import gzip  # noqa: F401 (re-exported for tests/back-compat)
import struct
from typing import Iterator, Tuple

import numpy as np

from .bgzf import open_bam_stream

# 4-bit base codes: =ACMGRSVTWYHKDBN
SEQ16 = b"=ACMGRSVTWYHKDBN"
_SEQ16_LUT = np.frombuffer(SEQ16, dtype=np.uint8)
# packed byte -> the two bases it encodes (high nibble first):
# bytes.join over this list is C-speed and beats numpy for short reads
_PAIRS = [bytes((SEQ16[b >> 4], SEQ16[b & 15])) for b in range(256)]
_PAIR_LUT = np.frombuffer(b"".join(_PAIRS), np.uint8).reshape(256, 2)
_PHRED33 = bytes(min(q + 33, 255) for q in range(256))

SEP = 0xFF  # kmer-breaker code (matches the native scanner / kmer.py)
_BASE2CODE = np.full(256, SEP, np.uint8)
for _b, _c in zip(b"ACTG", (0, 1, 2, 3)):  # A=00 C=01 T=10 G=11
    _BASE2CODE[_b] = _c
# packed byte -> its two 2-bit codes (non-ACGT nibbles become breakers)
_PAIR_CODES = np.empty((256, 2), np.uint8)
for _b in range(256):
    _PAIR_CODES[_b, 0] = _BASE2CODE[SEQ16[_b >> 4]]
    _PAIR_CODES[_b, 1] = _BASE2CODE[SEQ16[_b & 15]]


def is_bam(path: str) -> bool:
    try:  # cheap probe: stdlib gzip reads 4 bytes lazily (BGZF is
        with gzip.open(path, "rb") as f:  # valid multi-member gzip)
            return f.read(4) == b"BAM\x01"
    except Exception:
        return False


def _skip_header(f):
    magic = f.read(4)
    if magic != b"BAM\x01":
        raise ValueError("not a BAM stream")
    (l_text,) = struct.unpack("<i", f.read(4))
    f.read(l_text)  # SAM header text
    (n_ref,) = struct.unpack("<i", f.read(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", f.read(4))
        f.read(l_name + 4)  # name + l_ref


def _decode_window(buf, starts, nbs, lseqs, hpc):
    """One vectorized pass: gather every record's packed bases from the
    window, expand nibbles straight to 2-bit codes, and lay them out
    with one SEP breaker per record."""
    win = np.frombuffer(buf, np.uint8)
    st = np.asarray(starts, np.int64)
    nb = np.asarray(nbs, np.int64)
    ls = np.asarray(lseqs, np.int64)
    totpk = int(nb.sum())
    cum = np.zeros(len(nb) + 1, np.int64)
    np.cumsum(nb, out=cum[1:])
    idx = np.repeat(st - cum[:-1], nb) + np.arange(totpk)
    codes2 = _PAIR_CODES[win[idx]].reshape(-1)       # 2 codes/byte
    # keep the first l_seq codes of each record's 2*nb nibble region
    within = np.arange(2 * totpk) - np.repeat(2 * cum[:-1], 2 * nb)
    kept = codes2[within < np.repeat(ls, 2 * nb)]
    n_out = int((ls + 1).sum())
    out = np.empty(n_out, np.uint8)
    sep_pos = np.cumsum(ls + 1) - 1
    mask = np.ones(n_out, bool)
    mask[sep_pos] = False
    out[mask] = kept
    out[sep_pos] = SEP
    if hpc:  # drop consecutive equal codes (runs never span a SEP)
        keep = np.empty(len(out), bool)
        keep[0] = True
        np.not_equal(out[1:], out[:-1], out=keep[1:])
        out = out[keep]
    return out


def iter_codes(path: str, hpc: bool = False,
               window: int = 1 << 22) -> Iterator[np.ndarray]:
    """Bulk BAM -> 2-bit code arrays with SEP breakers, for the
    counting path (the reference counts BAM via htslib + kmerIterator;
    merylInput.C:241-275).  Skips names/quals entirely and decodes a
    whole buffered window per numpy pass — an order of magnitude
    faster than going through iter_bam's per-record tuples."""
    from .. import native
    lib = native.get_lib()
    with open_bam_stream(path) as f:
        _skip_header(f)
        if lib is not None and hasattr(lib, "mt_bam_scan"):
            # native path: the whole record walk + nibble decode is
            # one C pass per buffered window; the remainder of a
            # record straddling the window carries over
            carry = b""
            while True:
                data = f.read(window)
                win = carry + data if carry else data
                if not win:
                    break
                r = native.bam_scan(win, hpc)
                if r is None:
                    raise ValueError(f"{path}: malformed BAM record")
                codes, consumed = r
                if len(codes):
                    yield codes
                carry = win[consumed:]
                if not data:
                    break  # trailing partial record: truncated file
            return
        buf = b""
        pos = 0
        u32 = struct.Struct("<i")
        starts: list = []
        nbs: list = []
        lseqs: list = []

        def flush():
            if not lseqs:
                return None
            out = _decode_window(buf, starts, nbs, lseqs, hpc)
            starts.clear()
            nbs.clear()
            lseqs.clear()
            return out

        while True:
            if pos + 4 > len(buf):
                out = flush()
                if out is not None:
                    yield out
                buf = buf[pos:] + f.read(window)
                pos = 0
                if len(buf) < 4:
                    break
            (block_size,) = u32.unpack_from(buf, pos)
            if block_size < 32:
                raise ValueError("malformed BAM record (block_size)")
            end = pos + 4 + block_size
            if end > len(buf):
                out = flush()
                if out is not None:
                    yield out
                while end > len(buf):
                    nxt = f.read(max(window, end - len(buf)))
                    if not nxt:
                        break
                    buf = buf[pos:] + nxt
                    end = 4 + block_size
                    pos = 0
                if end > len(buf):
                    break
            base = pos + 4
            l_read_name = buf[base + 8]
            (n_cigar_op,) = struct.unpack_from("<H", buf, base + 12)
            (l_seq,) = struct.unpack_from("<i", buf, base + 16)
            starts.append(base + 32 + l_read_name + 4 * n_cigar_op)
            nbs.append((l_seq + 1) // 2)
            lseqs.append(l_seq)
            pos = end
        out = flush()
        if out is not None:
            yield out


def iter_bam(path: str) -> Iterator[Tuple[str, bytes, bytes | None]]:
    """Yield (name, bases, quals|None) per alignment record.

    Records are parsed from a large buffered window over the BGZF
    stream (per-record gzip reads cost more than the decode itself)
    with C-speed base unpacking: a 256-entry packed-byte -> base-pair
    join for typical short reads, the numpy LUT for long ones."""
    with open_bam_stream(path) as f:
        _skip_header(f)
        buf = b""
        pos = 0
        u32 = struct.Struct("<i")
        while True:
            if pos + 4 > len(buf):
                buf = buf[pos:] + f.read(1 << 22)
                pos = 0
                if len(buf) < 4:
                    break
            (block_size,) = u32.unpack_from(buf, pos)
            if block_size < 32:
                raise ValueError("malformed BAM record (block_size)")
            end = pos + 4 + block_size
            while end > len(buf):
                nxt = f.read(max(1 << 22, end - len(buf)))
                if not nxt:
                    break
                buf = buf[pos:] + nxt
                end = 4 + block_size
                pos = 0
            if end > len(buf):
                break
            rec = buf
            base = pos + 4
            pos = end
            l_read_name = rec[base + 8]
            (n_cigar_op,) = struct.unpack_from("<H", rec, base + 12)
            (l_seq,) = struct.unpack_from("<i", rec, base + 16)
            off = base + 32
            name = rec[off:off + l_read_name - 1].decode(
                "ascii", "replace")
            off += l_read_name + 4 * n_cigar_op
            nbytes = (l_seq + 1) // 2
            packed = rec[off:off + nbytes]
            off += nbytes
            qual = rec[off:off + l_seq]
            if l_seq <= 1024:
                bases = b"".join(map(_PAIRS.__getitem__, packed))[:l_seq]
            else:
                pk = np.frombuffer(packed, dtype=np.uint8)
                bases = _PAIR_LUT[pk].reshape(-1)[:l_seq].tobytes()
            if l_seq and qual and qual[0] == 0xFF:
                qual = None  # quality absent (0xFF fill per BAM spec)
            elif qual:
                # Phred+33, clamped to printable range (a bogus stored
                # value > 222 must not abort the whole file)
                qual = qual.translate(_PHRED33)
            else:
                qual = None
            yield name, bases, qual
