"""A run's input files, made from the configuration, the traffic mix's
`inputs` and the seed.

Each entry of a mix's `inputs` names a file and its kind:
  {"kind": "reads", "depth": D, "prefix": "q"}  reads of the genome
      (the configuration's read model; depth D, or the configuration's
      depth when D is absent), written as FASTQ
  {"kind": "assembly"}  the genome as one contig with the
      configuration's assembly substitutions, written as FASTA
A `reads` entry may add "quality": {"symbols": S, "start": [...],
"end": [...]}, a binned quality model (reference.reads.make_qualities),
drawn from a stream of its own keyed by the input's name, so the bases
stay those of the same entry without it; without it every quality is
'I'.

Either kind may add "compress": "gzip".  The sequences are then drawn
exactly as without it (a read set's stream is keyed by the input's name
as the mix gives it, so `reads.fq` gzipped holds the plain `reads.fq`'s
reads), and the file is written to the input's path plus ".gz", which
`{<name>}` in a mix's words then names; the plain text is never written.
It is one gzip member with mtime 0, no file name and no extra field:
the bytes follow from the seed alone, and a reader takes it for a plain
gzip stream, as a sequencer's `.fastq.gz`, not for BGZF (whose blocks
carry a `BC` extra field).  Its one deflate stream is built as pigz
builds one: the text in fixed blocks of BLOCK bytes, each deflated at
level 6 (gzip's default) from threads, primed with the 32 KiB before
it and ended on a sync flush, so the blocks join into one stream that
compresses as a single pass does, in a fraction of its time.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from reference import reads as rd

GZIP_LEVEL = 6
BLOCK = 1 << 22          # bytes of text a deflate block
WINDOW = 1 << 15         # deflate's window: a block's priming dictionary
# magic, deflate, no flags, mtime 0, no extra flags, OS unknown
GZIP_HEADER = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff"


@dataclass
class Input:
    path: str
    reads: rd.ReadSet     # what the reference counts
    file_bytes: int       # the file as written (compressed, where it is)


def gzip_parts(data) -> list[bytes]:
    """`data` (bytes-like) as one gzip member, in parts to write in
    order (see the module's docstring).  zlib lets go of the GIL while
    it deflates, so the blocks run in parallel."""
    view = memoryview(data).cast("B")
    cuts = list(range(0, len(view), BLOCK)) or [0]

    def deflate(i):
        a = cuts[i]
        last = i == len(cuts) - 1
        z = zlib.compressobj(GZIP_LEVEL, zlib.DEFLATED, -15,
                             zdict=view[max(0, a - WINDOW):a]) if a else \
            zlib.compressobj(GZIP_LEVEL, zlib.DEFLATED, -15)
        return z.compress(view[a:a + BLOCK]) + \
            z.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)

    workers = max(1, min(len(cuts), len(os.sched_getaffinity(0))))
    with ThreadPoolExecutor(workers) as pool:
        body = list(pool.map(deflate, range(len(cuts))))
    tail = struct.pack("<II", zlib.crc32(view), len(view) & 0xFFFFFFFF)
    return [GZIP_HEADER, *body, tail]


def make_inputs(config: dict, spec: dict, seed: int, workdir: str):
    """-> {name: Input}, files written under workdir."""
    genome = rd.make_genome(int(config["genome"]["length_bp"]), seed)
    out = {}
    for name, s in spec.items():
        path = os.path.join(workdir, name)
        compress = s.get("compress")
        if compress not in (None, "gzip"):
            raise ValueError(f"input {name}: unknown compress {compress!r}")
        if s["kind"] == "reads":
            depth = float(s.get("depth", config["reads"]["depth"]))
            key = zlib.crc32(name.encode())
            rs = rd.make_reads(genome, config["reads"], depth, seed, key,
                               s.get("prefix", "r"))
            qual = rd.make_qualities(rs, s["quality"], seed, key) \
                if "quality" in s else None
            data = rd.fastq_bytes(rs, qual)
        elif s["kind"] == "assembly":
            if "quality" in s:
                raise ValueError(f"input {name}: FASTA has no quality")
            asm = rd.make_assembly(
                genome, int(config["assembly"]["substitution_every_bp"]),
                seed)
            rs = rd.ReadSet(asm, np.array([asm.size], np.int64), "asm")
            data = rd.fasta_bytes("asm", asm,
                                  int(config["assembly"]["fasta_line_bp"]))
        else:
            raise ValueError(f"input {name}: unknown kind {s['kind']!r}")
        parts = [data]
        if compress == "gzip":
            parts = gzip_parts(data)
            path += ".gz"
        with open(path, "wb") as f:
            size = sum(f.write(p) for p in parts)
        out[name] = Input(path, rs, size)
    return out
