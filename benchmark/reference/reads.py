"""The benchmark's inputs, made from a seed with vectorised NumPy: a
random genome, read sets sampled from it, an "assembly" of it, and the
FASTQ / FASTA files the program reads.

Codes are A=0, C=1, T=2, G=3 (the complement of a code is code ^ 2) and
4 for N.  Every input of a run comes from `numpy.random.default_rng`
seeded with (seed, stream), one stream an input, so one input does not
shift another.  The sizes of a read set (its read count and lengths,
its numbers of substitutions and N) depend on the configuration alone:
a seed changes which bases are read, never how much work there is.
A FASTQ's qualities are the constant 'I' unless a quality model is
given; its draws take a stream of their own, so the bases do not shift.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LETTERS = np.frombuffer(b"ACTGN", np.uint8)
N_CODE = 4

# stream ids of default_rng((seed, stream))
GENOME, READS, ASSEMBLY, QUALITY = 1, 2, 3, 4


def rng_for(seed: int, stream: int, extra: int = 0) -> np.random.Generator:
    """The generator of one input; any whole seed, negative or past 64
    bits, maps to one 64-bit word."""
    return np.random.default_rng((int(seed) & (2 ** 64 - 1), stream, extra))


@dataclass
class ReadSet:
    """Reads as one flat code array and their lengths, in file order."""
    codes: np.ndarray      # uint8, 0-3 and 4 for N
    lens: np.ndarray       # int64, one a read
    prefix: str            # read i is named f"{prefix}{i:0{width}d}"

    @property
    def bases(self) -> int:
        return int(self.codes.size)

    @property
    def n_reads(self) -> int:
        return int(self.lens.size)

    @property
    def n_n(self) -> int:
        return int(np.count_nonzero(self.codes == N_CODE))

    @property
    def starts(self) -> np.ndarray:
        s = np.zeros(self.lens.size, np.int64)
        np.cumsum(self.lens[:-1], out=s[1:])
        return s

    def names(self) -> list[str]:
        w = _name_width(self.n_reads)
        return [f"{self.prefix}{i:0{w}d}" for i in range(self.n_reads)]


def make_genome(length: int, seed: int) -> np.ndarray:
    return rng_for(seed, GENOME).integers(0, 4, size=length, dtype=np.uint8)


def read_lengths(spec: dict, genome_len: int, depth: float) -> np.ndarray:
    """Lengths of a read set at `depth`, from the configuration alone.

    spec {"fixed": L}: floor(depth * genome / L) reads of L bases.
    spec {"lognormal_mean": m, "lognormal_sigma": s, "min": a, "max": b,
    "draw_seed": d}: lengths from a lognormal of mean m, clipped to
    [a, b], drawn from seed d until they cover depth * genome."""
    target = int(depth * genome_len)
    if "fixed" in spec:
        L = int(spec["fixed"])
        return np.full(target // L, L, np.int64)
    m, s = float(spec["lognormal_mean"]), float(spec["lognormal_sigma"])
    rng = np.random.default_rng(int(spec["draw_seed"]))
    mu = np.log(m) - s * s / 2
    out, total = [], 0
    while total < target:
        x = np.clip(rng.lognormal(mu, s, 4096), spec["min"], spec["max"])
        x = x.astype(np.int64)
        c = total + np.cumsum(x)
        n = int(np.searchsorted(c, target)) + 1
        out.append(x[:n])
        total = int(c[min(n, len(c)) - 1])
    return np.concatenate(out)


def make_reads(genome: np.ndarray, spec: dict, depth: float, seed: int,
               stream_extra: int, prefix: str) -> ReadSet:
    """Reads of `genome` at `depth`: each from a uniform start on either
    strand, then round(rate * bases) substitutions and round(n_rate *
    bases) N at uniform positions."""
    rng = rng_for(seed, READS, stream_extra)
    lens = rng.permutation(read_lengths(spec["length"], genome.size, depth))
    starts = rng.integers(0, genome.size - lens + 1)
    rev = rng.random(lens.size) < 0.5
    if (lens == lens[0]).all():
        L = int(lens[0])
        win = np.lib.stride_tricks.sliding_window_view(genome, L)
        reads = win[starts]
        reads[rev] = reads[rev, ::-1] ^ 2
        codes = reads.reshape(-1)
    else:
        codes = np.empty(int(lens.sum()), np.uint8)
        pos = 0
        for s, L, r in zip(starts.tolist(), lens.tolist(), rev.tolist()):
            seg = genome[s:s + L]
            codes[pos:pos + L] = seg[::-1] ^ 2 if r else seg
            pos += L
    total = codes.size
    n_sub = int(round(float(spec["substitution_rate"]) * total))
    at = rng.integers(0, total, n_sub)
    codes[at] = (codes[at] + rng.integers(1, 4, n_sub, dtype=np.uint8)) & 3
    n_n = int(round(float(spec.get("n_rate", 0.0)) * total))
    codes[rng.integers(0, total, n_n)] = N_CODE
    return ReadSet(codes, lens.astype(np.int64), prefix)


def make_qualities(rs: ReadSet, spec: dict, seed: int,
                   stream_extra: int) -> np.ndarray:
    """One quality letter a base (uint8, flat in file order) from spec
    {"symbols": S, "start": [w...], "end": [w...]}: at a read's first
    base symbol j has weight start[j], at its last end[j], and linear
    between; drawn base by base from the stream (seed, QUALITY,
    stream_extra).  Reads of one length only, as short-read FASTQ is."""
    sym = np.frombuffer(spec["symbols"].encode(), np.uint8)
    w0 = np.asarray(spec["start"], np.float64)
    w1 = np.asarray(spec["end"], np.float64)
    if not (sym.size == w0.size == w1.size > 0):
        raise ValueError("quality: one start and one end weight a symbol")
    if rs.n_reads == 0 or (rs.lens != rs.lens[0]).any():
        raise ValueError("quality: reads of one length only")
    L = int(rs.lens[0])
    # each position's cumulative weights, as uint16 cuts of a uniform draw
    f = np.linspace(0.0, 1.0, L)[:, None]
    w = w0 / w0.sum() * (1 - f) + w1 / w1.sum() * f
    cuts = np.rint(np.cumsum(w, axis=1)[:, :-1] * 65536)
    cuts = np.minimum(cuts, 65535).astype(np.uint16)    # (L, S - 1)
    rng = rng_for(seed, QUALITY, stream_extra)
    out = np.empty((rs.n_reads, L), np.uint8)
    per = max(1, (1 << 24) // L)
    for a in range(0, rs.n_reads, per):
        u = rng.integers(0, 65536, (min(per, rs.n_reads - a), L), np.uint16)
        idx = np.zeros(u.shape, np.uint8)
        for j in range(cuts.shape[1]):
            idx += u >= cuts[:, j]
        out[a:a + per] = sym[idx]
    return out.reshape(-1)


def make_assembly(genome: np.ndarray, every: int, seed: int) -> np.ndarray:
    """The genome as one contig with one substitution every `every`
    bases, from an offset drawn from the seed."""
    rng = rng_for(seed, ASSEMBLY)
    asm = genome.copy()
    at = np.arange(int(rng.integers(0, every)), asm.size, every)
    asm[at] = (asm[at] + rng.integers(1, 4, at.size, dtype=np.uint8)) & 3
    return asm


def _name_width(n: int) -> int:
    return len(str(max(n - 1, 0)))


def _digits(idx: np.ndarray, width: int) -> np.ndarray:
    out = np.empty((idx.size, width), np.uint8)
    v = idx.astype(np.int64)
    for j in range(width - 1, -1, -1):
        out[:, j] = 48 + v % 10
        v //= 10
    return out


def fastq_bytes(rs: ReadSet, qual: np.ndarray | None = None) -> np.ndarray:
    """One four-line record a read, as uint8 text: qualities from `qual`
    (one letter a base, flat), or 'I' when it is None."""
    n, w = rs.n_reads, _name_width(rs.n_reads)
    head = 1 + len(rs.prefix) + w + 1
    if n and (rs.lens == rs.lens[0]).all():
        L = int(rs.lens[0])
        rec = np.empty((n, head + 2 * L + 4), np.uint8)
        rec[:, 0] = ord("@")
        rec[:, 1:1 + len(rs.prefix)] = np.frombuffer(rs.prefix.encode(),
                                                     np.uint8)
        rec[:, 1 + len(rs.prefix):head - 1] = _digits(np.arange(n), w)
        rec[:, head - 1] = 10
        rec[:, head:head + L] = LETTERS[rs.codes.reshape(n, L)]
        rec[:, head + L:head + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, head + L + 3:-1] = ord("I") if qual is None else \
            qual.reshape(n, L)
        rec[:, -1] = 10
        return rec.reshape(-1)
    names = _digits(np.arange(n), w)
    pre = b"@" + rs.prefix.encode()
    recs = []
    for i, (s, L) in enumerate(zip(rs.starts.tolist(), rs.lens.tolist())):
        recs.append(b"".join((pre, names[i].tobytes(), b"\n",
                              LETTERS[rs.codes[s:s + L]].tobytes(), b"\n+\n",
                              b"I" * L if qual is None else
                              qual[s:s + L].tobytes(), b"\n")))
    return np.frombuffer(b"".join(recs), np.uint8)


def write_fastq(path: str, rs: ReadSet,
                qual: np.ndarray | None = None) -> int:
    """fastq_bytes to path; -> bytes written."""
    data = fastq_bytes(rs, qual)
    data.tofile(path)
    return data.size


def fasta_bytes(name: str, codes: np.ndarray, line: int = 80) -> bytes:
    """One sequence in lines of `line` bases."""
    n = codes.size
    rows = -(-n // line)
    buf = np.full((rows, line + 1), 10, np.uint8)
    padded = np.full(rows * line, N_CODE, np.uint8)
    padded[:n] = codes
    buf[:, :line] = LETTERS[padded].reshape(rows, line)
    body = buf.reshape(-1)
    keep = np.ones(body.size, bool)
    if n % line:                       # the last line's unused columns
        keep[(rows - 1) * (line + 1) + n % line:-1] = False
    return b">" + name.encode() + b"\n" + body[keep].tobytes()


def write_fasta(path: str, name: str, codes: np.ndarray,
                line: int = 80) -> int:
    """fasta_bytes to path; -> bytes written."""
    data = fasta_bytes(name, codes, line)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
