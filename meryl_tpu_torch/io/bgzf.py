"""Parallel BGZF reader.

BAM files are BGZF: a stream of independent <=64KB gzip members, each
carrying its compressed size in a BC extra subfield — designed for
exactly this kind of parallel inflate (the reference's htslib ships a
threaded BGZF layer; src/main.mk:92-140).  zlib releases the GIL, so
a small thread pool inflates blocks concurrently while the consumer
drains them in order.  Non-BGZF gzip (no BC subfield) falls back to
the stdlib reader transparently.
"""

from __future__ import annotations

import gzip
import io
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor


def _bc_size(header: bytes) -> int | None:
    """BSIZE+1 from a BGZF member header, or None if not BGZF."""
    if len(header) < 18 or header[:4] != b"\x1f\x8b\x08\x04":
        return None
    (xlen,) = struct.unpack_from("<H", header, 10)
    pos = 12
    end = 12 + xlen
    while pos + 4 <= min(end, len(header)):
        si1, si2, slen = header[pos], header[pos + 1], \
            struct.unpack_from("<H", header, pos + 2)[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            if pos + 6 > len(header):
                return None
            (bsize,) = struct.unpack_from("<H", header, pos + 4)
            return bsize + 1
        pos += 4 + slen
    return None


def is_bgzf(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(12)
            if len(head) < 12 or head[:4] != b"\x1f\x8b\x08\x04":
                return False
            (xlen,) = struct.unpack_from("<H", head, 10)
            return _bc_size(head + f.read(xlen)) is not None
    except OSError:
        return False


def _inflate(block: bytes) -> bytes:
    # raw deflate payload sits between the header(+extra) and the
    # 8-byte crc/isize trailer; zlib with wbits=31 handles the whole
    # member including header/trailer validation
    return zlib.decompress(block, 31)


class _BgzfStream(io.RawIOBase):
    """Raw stream over a BGZF file with pipelined multi-threaded
    block inflate; wrap in io.BufferedReader for readline/iteration
    (open_bam_stream does)."""

    def __init__(self, path: str, threads: int = 3, lookahead: int = 32):
        super().__init__()
        self._f = open(path, "rb")
        self._ex = ThreadPoolExecutor(max_workers=max(1, threads))
        self._lookahead = max(2, lookahead)
        self._futures: list = []
        self._buf = bytearray()
        self._pos = 0
        self._eof = False

    def _submit_more(self) -> None:
        while not self._eof and len(self._futures) < self._lookahead:
            fixed = self._f.read(12)
            if len(fixed) < 12:
                self._eof = True
                break
            if fixed[:4] != b"\x1f\x8b\x08\x04":
                raise ValueError("not a BGZF member (corrupt stream?)")
            (xlen,) = struct.unpack_from("<H", fixed, 10)
            extra = self._f.read(xlen)  # BC may sit after other
            header = fixed + extra      # subfields (spec-legal)
            size = _bc_size(header)
            if size is None or size < 12 + xlen + 8:
                raise ValueError("not a BGZF member (corrupt stream?)")
            rest = self._f.read(size - len(header))
            if len(rest) != size - len(header):
                self._eof = True  # truncated trailing member
                break
            self._futures.append(self._ex.submit(_inflate, header + rest))

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        n = len(b)
        while len(self._buf) - self._pos < n:
            self._submit_more()
            if not self._futures:
                break
            if self._pos:  # compact consumed prefix
                del self._buf[:self._pos]
                self._pos = 0
            self._buf += self._futures.pop(0).result()
        take = min(n, len(self._buf) - self._pos)
        b[:take] = self._buf[self._pos:self._pos + take]
        self._pos += take
        return take

    def close(self) -> None:
        if not self.closed:
            self._ex.shutdown(wait=False, cancel_futures=True)
            self._f.close()
        super().close()


def open_bam_stream(path: str, threads: int = 3):
    """BGZF-aware opener: parallel inflate for real BGZF files
    (readline/iteration capable), stdlib gzip for plain-gzip files
    (e.g. test fixtures)."""
    if is_bgzf(path):
        return io.BufferedReader(_BgzfStream(path, threads=threads),
                                 buffer_size=1 << 20)
    return gzip.open(path, "rb")
