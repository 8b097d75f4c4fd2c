"""Sequence input: FASTA/FASTQ readers and the device-chunk feeder.

Capabilities mirrored from the reference's dnaSeqFile layer
(SURVEY.md section 2.3; meryl src/meryl/merylInput.C:241-275):
  * FASTA (multi-line) and FASTQ, auto-detected; gz/bz2/xz compression
    auto-detected by magic bytes
  * streaming chunk interface with a k-1 base halo so kmers spanning
    chunk boundaries are seen exactly once (the reference's _lastBuffer
    carry, merylOp-countThreads.C:144-155)
  * sequence breaks: a separator code between sequences invalidates
    windows spanning two sequences (the reference's '.' breakers,
    merylOp-countThreads.C:196-215)
  * homopolymer compression with cross-buffer carry (merylInput.C:258-263)

BAM and CRAM ingest are dependency-free (reference vendors htslib,
src/main.mk:92-140): io.bam (BGZF/BAM) and io.cram (CRAM 3.0).
"""

from __future__ import annotations

import bz2
import gzip
import io as _io
import lzma
import os
from typing import Iterator, Tuple

import numpy as np

from ..kmer import CODE_LUT

SEP = 255  # sequence separator / invalid code


def open_maybe_compressed(path: str, mode: str = "rb"):
    """Open a file, transparently decompressing gz/bz2/xz (by magic).

    The decompressor is opened BY PATH (not wrapping the sniffing fd):
    gzip/bz2/lzma wrappers around a caller-supplied fileobj do not
    close it, which would leak one fd per compressed file."""
    with open(path, "rb") as f:
        magic = f.read(6)
    if magic[:2] == b"\x1f\x8b":
        from .bgzf import is_bgzf, open_bam_stream
        if is_bgzf(path):  # bgzipped FASTA/FASTQ: parallel inflate
            return open_bam_stream(path)
        return gzip.open(path, "rb")
    if magic[:3] == b"BZh":
        return bz2.open(path, "rb")
    if magic[:6] == b"\xfd7zXZ\x00":
        return lzma.open(path, "rb")
    return open(path, "rb")


def open_output(path: str):
    """Text-mode writer that compresses by extension — the
    reference's compressedFileWriter contract (files.H via call sites
    like merylOp-nextMer.C print targets): .gz/.bz2/.xz outputs are
    produced transparently."""
    if path.endswith(".gz"):
        return gzip.open(path, "wt")
    if path.endswith(".bz2"):
        return bz2.open(path, "wt")
    if path.endswith(".xz"):
        return lzma.open(path, "wt")
    return open(path, "w")


def detect_format(first_byte: bytes) -> str:
    if first_byte == b">":
        return "fasta"
    if first_byte == b"@":
        return "fastq"
    return "raw"


def iter_sequences(path: str, want_quals: bool = False,
                   ) -> Iterator[Tuple[str, bytes, bytes | None]]:
    """Yield (name, bases, quals|None) per sequence.  want_quals=False
    lets the CRAM reader skip quality-block decompression entirely
    (QS is typically the largest series; only the read-filter FASTQ
    output actually consumes qualities) — FASTQ/BAM still yield quals
    either way since theirs are decoded as a side effect."""
    from . import bam
    if bam.is_bam(path):
        yield from bam.iter_bam(path)
        return
    from . import cram
    if path.endswith(".cram") or cram.is_cram(path):
        # dependency-free CRAM 3.0 reader (reference vendors htslib for
        # this, src/main.mk:92-140); reference FASTA via
        # MERYL_TPU_CRAM_REF when slices aren't embedded/reference-less
        yield from cram.iter_cram(path, want_quals=want_quals)
        return
    with open_maybe_compressed(path) as f:
        buf = _io.BufferedReader(f) if not isinstance(f, _io.BufferedReader) else f
        first = buf.peek(1)[:1]
        fmt = detect_format(first)
        if fmt == "fasta":
            name = None
            parts: list[bytes] = []
            for line in buf:
                line = line.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if name is not None:
                        yield name, b"".join(parts), None
                    name = line[1:].split()[0].decode() if len(line) > 1 else ""
                    parts = []
                else:
                    parts.append(line)
            if name is not None:
                yield name, b"".join(parts), None
        elif fmt == "fastq":
            # robust FASTQ: sequence may span multiple lines (ended by
            # the '+' line) and quality spans lines until its length
            # matches the sequence — so a '@' first quality character
            # can't be mistaken for a header (dnaSeqFile semantics)
            while True:
                hdr = buf.readline()
                if not hdr:
                    break
                hdr = hdr.rstrip(b"\r\n")
                if not hdr:
                    continue
                seq_parts = []
                line = buf.readline()
                while line and not line.startswith(b"+"):
                    seq_parts.append(line.rstrip(b"\r\n"))
                    line = buf.readline()
                seq = b"".join(seq_parts)
                qual_parts = []
                qlen = 0
                while qlen < len(seq):
                    qline = buf.readline()
                    if not qline:
                        break
                    q = qline.rstrip(b"\r\n")
                    qual_parts.append(q)
                    qlen += len(q)
                qual = b"".join(qual_parts)
                name = hdr[1:].split()[0].decode() if len(hdr) > 1 else ""
                yield name, seq, qual
        else:  # raw: whole file is one sequence
            data = buf.read()
            yield "", b"".join(data.split()), None


def homopoly_compress_bytes(seq: bytes, last_byte: int = 0) -> bytes:
    """Collapse homopolymer runs (case-insensitive); `last_byte` carries the
    previous chunk's final base so runs spanning chunks stay collapsed."""
    if not seq:
        return seq
    a = np.frombuffer(seq, dtype=np.uint8)
    up = np.where((a >= 97) & (a <= 122), a - 32, a)
    prev = np.empty_like(up)
    prev[0] = last_byte if last_byte == 0 else (last_byte - 32 if 97 <= last_byte <= 122 else last_byte)
    prev[1:] = up[:-1]
    keep = up != prev
    return a[keep].tobytes()


class SequenceChunker:
    """Streams fixed-length code chunks for the device pipeline.

    Each emitted chunk has length `chunk_len`; consecutive chunks overlap
    by k-1 codes so that every window of length k is counted exactly once
    (windows start at local positions 0..chunk_len-k).  Sequences are
    separated by SEP codes.  The final chunk is padded with SEP.
    """

    def __init__(self, paths, k: int, chunk_len: int, hpc: bool = False,
                 segment: tuple[int, int] | None = None,
                 deterministic: bool = False):
        if isinstance(paths, str):
            paths = [paths]
        self.paths = list(paths)
        self.k = k
        self.chunk_len = int(chunk_len)
        self.hpc = hpc
        # segment=(a, b): only process sequences with index % b == a-1 —
        # first-class version of the reference's external seqStore
        # sharding (merylCommandBuilder.C:313-315)
        self.segment = segment
        # deterministic: the chunk stream must be bit-reproducible run
        # to run (the batched counter's resume manifest identifies a
        # batch by chunk index) — disables the multi-file parallel
        # ingest, whose interleaving is timing-dependent
        self.deterministic = deterministic
        if self.chunk_len <= k:
            raise ValueError("chunk_len must exceed k")

    def _file_codes(self, path: str,
                    inner_threads: int | None = None) -> Iterator[np.ndarray]:
        """Code-block stream for ONE file.  Self-terminating: every
        sequence, including the file's last, is followed by a SEP, so
        per-file streams may be concatenated in any order.
        inner_threads caps per-file decode parallelism (the multi-file
        path passes 1 so nested pools don't oversubscribe)."""
        from .. import native
        from . import bam
        if bam.is_bam(path):
            # bulk BAM -> codes decoder (skips names/quals)
            yield from bam.iter_codes(path, hpc=self.hpc)
            return
        if path.endswith(".cram"):
            from . import cram
            yield from cram.iter_cram_codes(path, hpc=self.hpc,
                                            threads=inner_threads)
            return
        if native.available():
            # native C++ scanner: FASTA/FASTQ bytes -> codes + seps
            yield from native.scan_codes(path, hpc=self.hpc)
            return
        sep = np.full(1, SEP, dtype=np.uint8)
        for _, seq, _ in iter_sequences(path):
            if self.hpc:
                seq = homopoly_compress_bytes(seq)
            if seq:
                yield CODE_LUT[np.frombuffer(seq, dtype=np.uint8)]
            yield sep

    def _code_stream(self) -> Iterator[np.ndarray]:
        if self.segment is not None:
            # sequence-index filtering needs the global record order
            yield from self._code_stream_segment()
            return
        if (len(self.paths) > 1 and not self.deterministic
                and os.environ.get("MERYL_TPU_PAR_FILES", "1") != "0"):
            yield from self._code_stream_parallel()
            return
        for path in self.paths:
            yield from self._file_codes(path)

    def _code_stream_segment(self) -> Iterator[np.ndarray]:
        sep = np.full(1, SEP, dtype=np.uint8)
        seq_idx = 0
        a, b = self.segment
        for path in self.paths:
            for _, seq, _ in iter_sequences(path):
                idx = seq_idx
                seq_idx += 1
                if idx % b != a - 1:
                    continue
                if self.hpc:
                    seq = homopoly_compress_bytes(seq)
                if seq:
                    yield CODE_LUT[np.frombuffer(seq, dtype=np.uint8)]
                yield sep

    def _code_stream_parallel(self) -> Iterator[np.ndarray]:
        """Decode multiple input files concurrently (the reference's
        only multi-file story is sequential, merylInput.C; here each
        file gets a worker since single-stream gzip inflate cannot be
        parallelized but a lane's worth of FASTQ.gz files can).  Every
        emitted block is cut at its last sequence boundary (SEP) so
        blocks from different files may interleave without fabricating
        cross-file windows; counting output is interleaving-invariant
        (sorted union-sum)."""
        import queue as _queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        from ..resources import max_threads

        threads = min(len(self.paths), max(1, min(8, max_threads() - 1)))
        if threads <= 1:
            for path in self.paths:
                yield from self._file_codes(path)
            return
        try:
            from .. import native
            native._keep_large_allocs_on_heap()
        except Exception:
            pass

        q: "_queue.Queue" = _queue.Queue(maxsize=threads * 4)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except _queue.Full:
                    continue
            return False

        def run_file(path: str) -> None:
            # a sequence longer than one block accumulates as a LIST of
            # blocks (one concatenate at the cut, not one per block —
            # repeated concatenation is quadratic on chromosome-length
            # FASTA records); blocks may only be emitted cut at a SEP
            # so pieces of one sequence never interleave with another
            # file's blocks in the consumer stream
            try:
                carry = []
                for block in self._file_codes(path, inner_threads=1):
                    seps = np.flatnonzero(block == SEP)
                    if len(seps) == 0:
                        carry.append(block)
                        continue
                    cut = int(seps[-1]) + 1
                    tail = block[cut:] if cut < len(block) else None
                    if carry:
                        carry.append(block[:cut])
                        block = np.concatenate(carry)
                        carry = []
                    else:
                        block = block[:cut]
                    if tail is not None and len(tail):
                        carry.append(tail)
                    if not put(("b", block)):
                        return
                if carry:
                    # stream ended mid-sequence (raw input): close it
                    carry.append(np.full(1, SEP, np.uint8))
                    put(("b", np.concatenate(carry)))
            finally:
                put(("d", None))   # no-op if the consumer is closing

        with ThreadPoolExecutor(max_workers=threads) as ex:
            futs = [ex.submit(run_file, p) for p in self.paths]
            try:
                done = 0
                while done < len(futs):
                    kind, payload = q.get()
                    if kind == "b":
                        if len(payload):
                            yield payload
                    else:
                        done += 1
                for f in futs:
                    f.result()   # surface worker exceptions
            finally:
                stop.set()
                # unblock any producer stuck on a full queue so the
                # executor can shut down
                while not all(f.done() for f in futs):
                    try:
                        q.get_nowait()
                    except _queue.Empty:
                        import time as _t
                        _t.sleep(0.01)

    def __iter__(self) -> Iterator[np.ndarray]:
        L, k = self.chunk_len, self.k
        step = L - (k - 1)
        pend: list[np.ndarray] = []
        npend = 0
        for codes in self._code_stream():
            pend.append(codes)
            npend += len(codes)
            if npend >= L:
                buf = np.concatenate(pend) if len(pend) > 1 else pend[0]
                pos = 0
                while len(buf) - pos >= L:
                    yield buf[pos:pos + L]
                    pos += step
                tail = buf[pos:].copy()
                pend = [tail]
                npend = len(tail)
        if npend > k - 1:  # remaining content may still contain full windows
            buf = np.concatenate(pend) if len(pend) > 1 else pend[0]
            if (buf != SEP).any():
                out = np.full(L, SEP, dtype=np.uint8)
                out[:npend] = buf
                yield out


def total_input_bytes(paths) -> int:
    if isinstance(paths, str):
        paths = [paths]
    return sum(os.path.getsize(p) for p in paths)
