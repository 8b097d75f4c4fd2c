"""What meryl and meryl-lookup commands must produce, worked out from
the generated sequences alone.

`Reference.run(command, argv)` takes the words a user types (without
`device=` words, which change nothing in a result) and returns each
output the command makes: a database as (keys, counts), or text (the
lookup's output file, or what `histogram` / `statistics` print).
Databases named as inputs are the outputs of earlier commands given to
the same Reference; sequence files are the read sets it was built with.

Grammar: one operation a command (no brackets), as in
  meryl count k=21 reads.fq output reads.meryl
  meryl greater-than 1 reads.meryl output solid.meryl
  meryl difference asm.meryl reads.meryl output asm-only.meryl
  meryl histogram reads.meryl
  meryl-lookup -existence -sequence q.fq -mers a.meryl b.meryl -output x
The value rules are meryl's (its reference manual, "Set operations" and
"Filters"); values are 32-bit and wrap as meryl's do.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kmers
from .dbfile import histogram_lines, stats
from .reads import ReadSet

MASK = 0xFFFFFFFF
VALUE_MAX = MASK

MERGES = ("union", "union-min", "union-max", "union-sum", "intersect",
          "intersect-min", "intersect-max", "intersect-sum", "subtract",
          "difference", "symmetric-difference")
FILTERS = ("less-than", "greater-than", "at-least", "at-most", "equal-to",
           "not-equal-to")
MATH = ("increase", "decrease", "multiply", "divide", "divide-round",
        "modulo")
REPORTS = ("histogram", "statistics")
IGNORED = ("memory", "threads")       # words that change no result


class Unsupported(ValueError):
    """A command outside what the reference works out."""


class Reference:
    def __init__(self, k: int, device, sequences: dict[str, ReadSet],
                 boundaries: bool = True):
        self.k = int(k)
        self.device = torch.device(device)
        self.sequences = sequences
        self.boundaries = boundaries
        self.dbs: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self._counted: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    # ------------------------------------------------------------ entry

    def run(self, command: str, argv: list[str]) -> dict:
        """-> {"db": {path: (keys, counts)}, "text": {path: str},
        "stdout": what it prints, or None where it prints nothing}."""
        if command == "meryl":
            return self._meryl(argv)
        if command == "meryl-lookup":
            return self._lookup(argv)
        raise Unsupported(f"no reference for command {command!r}")

    # ------------------------------------------------------------ meryl

    def _meryl(self, argv):
        op, thr, ins, out = None, None, [], None
        words = iter(argv)
        for w in words:
            key = w.split("=", 1)[0]
            if w.startswith("k="):
                if int(w[2:]) != self.k:
                    raise Unsupported(f"k {w[2:]} != {self.k}")
            elif key in IGNORED or w in ("-Q", "-V"):
                pass
            elif w == "output":
                out = next(words)
            elif w.isdigit() and op in FILTERS + MATH:
                thr = int(w)
            elif op is None and w in ("count",) + MERGES + FILTERS + MATH \
                    + REPORTS:
                op = w
            elif w in self.dbs or w in self.sequences:
                ins.append(w)
            else:
                raise Unsupported(f"meryl word {w!r}")
        if op is None or not ins:
            raise Unsupported(f"meryl {' '.join(argv)}")
        res = {"db": {}, "text": {}, "stdout": None}
        if op in REPORTS:
            keys, counts = self.dbs[ins[0]]
            res["stdout"] = (histogram_text(counts) if op == "histogram"
                             else statistics_text(counts, self.k))
            return res
        if op == "count":
            if len(ins) != 1:
                raise Unsupported("count of one sequence file")
            db = self._count(ins[0])
        else:
            db = merge(op, [self.dbs[p] for p in ins], thr, self.device)
        if out is None:
            raise Unsupported("a command without output")
        self.dbs[out] = db
        res["db"][out] = db
        return res

    def _count(self, path):
        if path not in self._counted:
            rs = self.sequences[path]
            self._counted[path] = kmers.count(rs.codes, rs.lens, self.k,
                                              self.device, self.boundaries)
        return self._counted[path]

    # ----------------------------------------------------------- lookup

    def _lookup(self, argv):
        mode, seq, dbs, out = None, None, [], None
        lo, hi = 0, VALUE_MAX
        i = 0
        while i < len(argv):
            a = argv[i]
            if a == "-existence":
                mode = a
            elif a == "-sequence":
                i += 1
                seq = argv[i]
            elif a == "-mers":
                while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                    i += 1
                    dbs.append(argv[i])
            elif a == "-output":
                i += 1
                out = argv[i]
            elif a in ("-min", "-max"):
                i += 1
                lo, hi = (int(argv[i]), hi) if a == "-min" else \
                    (lo, int(argv[i]))
            else:
                raise Unsupported(f"meryl-lookup word {a!r}")
            i += 1
        if mode is None or seq is None or not dbs or out is None:
            raise Unsupported(f"meryl-lookup {' '.join(argv)}")
        rs = self.sequences[seq]
        tables = []
        for p in dbs:
            keys, counts = self.dbs[p]
            keep = (counts >= lo) & (counts <= hi)
            tables.append(keys[keep])
        total, found = kmers.existence(rs.codes, rs.lens, self.k, tables,
                                       self.device, self.boundaries)
        cols = [np.array(rs.names(), object), total.astype(str)]
        for t, f in zip(tables, found):
            cols += [np.full(rs.n_reads, str(t.size), object), f.astype(str)]
        lines = ["\t".join(row) for row in zip(*cols)]
        return {"db": {}, "text": {out: "".join(s + "\n" for s in lines)},
                "stdout": None}


# ------------------------------------------------------------- set ops

def merge(op: str, inputs, threshold, device):
    """meryl's value rule of `op` over sorted unique (keys, counts)
    inputs -> (keys, counts) of the entries with a value above 0."""
    if op in FILTERS + MATH and len(inputs) != 1:
        raise Unsupported(f"{op} takes one input")
    if op in FILTERS + MATH and threshold is None:
        raise Unsupported(f"{op} needs a number")
    dev = torch.device(device)
    ks = [torch.from_numpy(np.ascontiguousarray(k, np.int64)).to(dev)
          for k, _ in inputs]
    vs = [torch.from_numpy(np.ascontiguousarray(v, np.int64)).to(dev)
          for _, v in inputs]
    ids = torch.cat([torch.full((k.numel(),), i, dtype=torch.int64,
                                device=dev) for i, k in enumerate(ks)])
    allk, allv = torch.cat(ks), torch.cat(vs)
    u, inv = torch.unique(allk, return_inverse=True)
    n = u.numel()

    def reduce(src, how, init):
        out = torch.full((n,), init, dtype=torch.int64, device=dev)
        return out.scatter_reduce_(0, inv, src, how, include_self=False)

    act = reduce(torch.ones_like(allv), "sum", 0)
    first = reduce(ids, "amin", len(inputs))
    v_first = reduce(torch.where(ids == first[inv], allv, 0), "sum", 0)
    v_min = reduce(allv, "amin", 0)
    v_max = reduce(allv, "amax", 0)
    v_sum = reduce(allv, "sum", 0) & MASK
    m = len(inputs)
    t = (threshold or 0) & MASK
    z = torch.zeros_like(v_sum)
    v = v_first
    if op == "union":
        out = act
    elif op == "union-min":
        out = v_min
    elif op == "union-max":
        out = v_max
    elif op == "union-sum":
        out = v_sum
    elif op.startswith("intersect"):
        base = {"intersect": v_first, "intersect-min": v_min,
                "intersect-max": v_max, "intersect-sum": v_sum}[op]
        out = torch.where(act == m, base, z)
    elif op == "subtract":
        rest = (v_sum - v_first) & MASK
        out = torch.where((first == 0) & (v_first > rest), v_first - rest, z)
    elif op == "difference":
        out = torch.where((act == 1) & (first == 0), v_first, z)
    elif op == "symmetric-difference":
        out = torch.where(act == 1, v_first, z)
    elif op in FILTERS:
        keep = {"less-than": v < t, "greater-than": v > t,
                "at-least": v >= t, "at-most": v <= t, "equal-to": v == t,
                "not-equal-to": v != t}[op]
        out = torch.where(keep, v, z)
    elif op == "increase":
        out = (v + t) & MASK
    elif op == "decrease":
        out = torch.where(v < t, z, v - t)
    elif op == "multiply":
        out = (v * t) & MASK       # a product past 2^63 wraps, low bits kept
    elif op in ("divide", "modulo"):                     # unsigned
        out = z if t == 0 else (v // t if op == "divide" else v % t)
    elif op == "divide-round":
        if t == 0:
            out = z
        else:
            q = v // t
            q = q + ((v - q * t) >= (t + 1) // 2).to(torch.int64)
            out = torch.where(v < t, torch.ones_like(q), q)
    else:
        raise Unsupported(f"meryl operation {op!r}")
    keep = out > 0
    return u[keep].cpu().numpy(), out[keep].cpu().numpy()


# ------------------------------------------------------------- reports

def histogram_text(counts) -> str:
    return "".join(line + "\n" for line in histogram_lines(counts))


def statistics_text(counts, k: int) -> str:
    """meryl's `statistics` table."""
    s = stats(counts)
    nd, nt = s["numDistinct"], s["numTotal"]
    out = [f"Number of {k}-mers that are:\n",
           f"  unique   {s['numUnique']:>20}  (exactly one instance of the "
           f"kmer is in the input)\n",
           f"  distinct {nd:>20}  (non-redundant kmer sequences in the "
           f"input)\n",
           f"  present  {nt:>20}  (...)\n",
           f"  missing  {(1 << (2 * k)) - nd:>20}  (non-redundant kmer "
           f"sequences not in the input)\n",
           "\n",
           "             number of   cumulative   cumulative     presence\n",
           "              distinct     fraction     fraction   in dataset\n",
           "frequency        kmers     distinct        total       (1e-6)\n",
           "--------- ------------ ------------ ------------ ------------\n"]
    v, o = np.unique(np.asarray(counts, np.int64), return_counts=True)
    sd = st = 0
    for a, b in zip(v.tolist(), o.tolist()):
        sd += b
        st += a * b
        out.append("%9d %12d %12.4f %12.4f %12.6f\n" % (
            a, b, sd / nd if nd else 0.0, st / nt if nt else 0.0,
            a / nt * 1e6 if nt else 0.0))
    return "".join(out)
