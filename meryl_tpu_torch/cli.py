"""The `meryl-torch` command line: the counting words of meryl's
grammar (meryl_tpu/cli.py), as far as the port goes.

  meryl-torch count k=21 reads.fq output reads.meryl
  meryl-torch count-forward k=21 compress reads.fa output f.meryl device=cpu

Words: count, count-forward, count-reverse, k=K, compress (homopolymer
compression), output DB, device=cuda|cpu (default cuda, which fails
when CUDA is absent), and sequence files.  Every other word of meryl
fails with the ROADMAP item that will port it.
"""

from __future__ import annotations

import os
import sys

USAGE = """usage: meryl-torch count|count-forward|count-reverse k=K \
[compress] [device=cuda|cpu] INPUT... output DB
"""

COUNT_OPS = {"count": "canonical", "count-forward": "forward",
             "count-reverse": "reverse"}

# words of meryl_tpu's CLI and the ROADMAP item that ports them
_NOT_PORTED = {
    "count-suffix": "A13", "memory": "A11", "threads": "A11",
    "n": "A11", "-C": "A11", "segment": "A10",
}


class ParseError(Exception):
    pass


def _not_ported(word: str) -> ParseError:
    item = _NOT_PORTED.get(word.split("=", 1)[0], "A7")
    return ParseError(f"'{word}' is not yet ported in meryl_tpu_torch "
                      f"(ROADMAP.md item {item})")


def parse(argv: list[str]) -> dict:
    cmd = {"op": None, "k": 0, "hpc": False, "output": None,
           "device": "cuda", "inputs": []}
    want_output = False
    for w in argv:
        if want_output:
            cmd["output"] = w
            want_output = False
        elif w in COUNT_OPS:
            if cmd["op"] is not None:
                raise ParseError("one counting operation per command")
            cmd["op"] = w
        elif w.startswith("k="):
            cmd["k"] = int(w[2:])
        elif w.startswith("device="):
            cmd["device"] = w[len("device="):]
        elif w == "compress":
            cmd["hpc"] = True
        elif w == "output":
            want_output = True
        elif "=" not in w and os.path.isfile(w):
            cmd["inputs"].append(w)
        else:
            raise _not_ported(w)
    if want_output:
        raise ParseError("'output' needs a DB path")
    if cmd["op"] is None:
        raise ParseError("no counting operation (count, count-forward, "
                         "count-reverse)")
    if not cmd["k"]:
        raise ParseError("counting needs a kmer size (k=)")
    if not cmd["inputs"]:
        raise ParseError("counting needs sequence file input")
    if cmd["output"] is None:
        raise ParseError("counting needs 'output DB'")
    return cmd


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "help", "--help"):
        sys.stderr.write(USAGE)
        return 0 if argv else 1
    from . import resolve_device
    try:
        cmd = parse(argv)
        device = resolve_device(cmd["device"])
    except (ParseError, ValueError, RuntimeError) as e:
        sys.stderr.write(f"meryl-torch: {e}\n")
        return 1
    from .counter import count_to_db
    count_to_db(cmd["inputs"], cmd["output"], cmd["k"],
                mode=COUNT_OPS[cmd["op"]], hpc=cmd["hpc"], device=device)
    return 0
