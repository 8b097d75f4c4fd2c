"""A run's input files, made from the configuration, the traffic mix's
`inputs` and the seed.

Each entry of a mix's `inputs` names a file and its kind:
  {"kind": "reads", "depth": D, "prefix": "q"}  reads of the genome
      (the configuration's read model; depth D, or the configuration's
      depth when D is absent), written as FASTQ
  {"kind": "assembly"}  the genome as one contig with the
      configuration's assembly substitutions, written as FASTA
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass

import numpy as np

from reference import reads as rd


@dataclass
class Input:
    path: str
    reads: rd.ReadSet     # what the reference counts
    file_bytes: int


def make_inputs(config: dict, spec: dict, seed: int, workdir: str):
    """-> {name: Input}, files written under workdir."""
    genome = rd.make_genome(int(config["genome"]["length_bp"]), seed)
    out = {}
    for name, s in spec.items():
        path = os.path.join(workdir, name)
        if s["kind"] == "reads":
            depth = float(s.get("depth", config["reads"]["depth"]))
            rs = rd.make_reads(genome, config["reads"], depth, seed,
                               zlib.crc32(name.encode()),
                               s.get("prefix", "r"))
            size = rd.write_fastq(path, rs)
        elif s["kind"] == "assembly":
            asm = rd.make_assembly(
                genome, int(config["assembly"]["substitution_every_bp"]),
                seed)
            rs = rd.ReadSet(asm, np.array([asm.size], np.int64), "asm")
            size = rd.write_fasta(path, "asm", asm,
                                  int(config["assembly"]["fasta_line_bp"]))
        else:
            raise ValueError(f"input {name}: unknown kind {s['kind']!r}")
        out[name] = Input(path, rs, size)
    return out
