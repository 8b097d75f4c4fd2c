"""The port's copies of meryl_tpu's JAX-free host modules against the
originals: the same inputs give byte-equal DB files, wire, sequence
chunks and reports."""

import gzip
import os
import struct

import numpy as np
import pytest

from meryl_tpu import db as ref_db
from meryl_tpu import kmer as ref_km
from meryl_tpu import reports as ref_reports
from meryl_tpu.histogram import MerylHistogram as RefHistogram
from meryl_tpu.io import sequence as ref_seq
from meryl_tpu_torch import db, reports
from meryl_tpu_torch import kmer as km
from meryl_tpu_torch.histogram import MerylHistogram
from meryl_tpu_torch.io import sequence as seq


def _sorted_kmers(rng, n, k):
    bits = 2 * k
    v = rng.integers(0, 1 << min(bits, 63), size=n, dtype=np.uint64)
    hi = rng.integers(0, 1 << (bits - 64), size=n, dtype=np.uint64) \
        if bits > 64 else np.zeros(n, np.uint64)
    order = np.lexsort((v, hi))
    hi, lo = hi[order], v[order]
    keep = np.ones(n, bool)
    keep[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    return hi[keep], lo[keep]


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("k,labels,multiset", [(15, None, False),
                                               (21, None, False),
                                               (33, None, True),
                                               (64, 16, False),
                                               (21, 64, False)])
def test_db_writer_bucket_files_byte_equal(tmp_path, monkeypatch, k, labels,
                                           multiset, path):
    """MerylDBWriter bucket at a time and MerylDB.write whole, through the
    native writer and the numpy fallback: every file of the DB equal byte
    for byte to the reference's."""
    if path == "numpy":
        monkeypatch.setenv("MERYL_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("MERYL_TPU_NO_NATIVE", raising=False)
    before = db.WRITE_STATS[path]
    rng = np.random.default_rng(k)
    hi, lo = _sorted_kmers(rng, 5000, k)
    counts = rng.integers(1, 70, size=len(lo)).astype(np.uint32)
    counts[::97] = (1 << 32) - 1
    lab = None if labels is None else \
        rng.integers(0, 1 << 62, size=len(lo), dtype=np.uint64)
    pref = km.prefix6_from_hilo(hi, lo, k)
    for name, mod in (("port", db), ("ref", ref_db)):
        w = mod.MerylDBWriter(str(tmp_path / f"{name}_w"), k, mode="forward",
                              multiset=multiset,
                              label_bits=labels if labels else 64)
        for ff in (5, 0, 63, 17):          # out of order, the rest empty
            m = pref == ff
            w.add_bucket(ff, hi[m], lo[m], counts[m],
                         None if lab is None else lab[m])
        w.finalize()
        mod.MerylDB.write(str(tmp_path / f"{name}_all"), k, hi, lo, counts,
                          multiset=multiset, labels=lab,
                          label_bits=labels if labels else 64)
    # 64 buckets through add_bucket (4 given, 60 by finalize), one DB
    assert db.WRITE_STATS[path] == before + 65
    for kind in ("w", "all"):
        port, ref = (_files(str(tmp_path / f"{n}_{kind}"))
                     for n in ("port", "ref"))
        assert len(port) == 66 and port == ref


def _pack_case(case):
    """-> (codes, pad_to) of one case of the 2-bit pack."""
    rng = np.random.default_rng(len(case))
    kind, _, arg = case.partition("-")
    if kind == "random":                 # short lengths, off 4 and 16
        n = int(arg)
        codes = rng.integers(0, 4, size=n).astype(np.uint8)
        codes[rng.integers(0, n, size=n // 10 + 1)] = 255
        codes[-min(n, 5):] = 255
        return codes, None
    if kind == "illumina":   # a 2^22 chunk of 150-base reads, 0.05 % N
        codes = rng.integers(0, 4, size=1 << 22).astype(np.uint8)
        codes[rng.random(len(codes)) < 0.0005] = 255
        codes[150::151] = 255
        return codes, None
    if kind == "allsep":                         # n_real 0, no exception
        return np.full(1 << 16, 255, np.uint8), None
    if kind == "nflood":       # past the L/64 floor: the list grows
        codes = rng.integers(0, 4, size=1 << 16).astype(np.uint8)
        flood = rng.random(len(codes)) < 0.3
        codes[flood] = rng.choice(np.array([4, 7, 128, 252, 255], np.uint8),
                                  int(flood.sum()))
        return codes, None
    if kind == "trailsep":        # the chunker's final-chunk padding
        codes = rng.integers(0, 4, size=5000).astype(np.uint8)
        codes[rng.integers(0, 3000, size=40)] = 255
        codes[3001:] = 255
        return codes, None
    codes = rng.integers(0, 4, size=1000).astype(np.uint8)   # "padto"
    codes[::97] = 255
    return codes, 1234


PACK_CASES = ["random-1", "random-3", "random-5", "random-15", "random-16",
              "random-17", "random-1000", "random-4103", "illumina",
              "allsep", "nflood", "trailsep", "padto"]


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_codes_matches_reference(monkeypatch, case, path):
    """The native pass and the numpy fallback each give the reference's
    wire bit for bit: words, padded exception list, n_real."""
    codes, pad_to = _pack_case(case)
    if path == "numpy":
        monkeypatch.setenv("MERYL_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("MERYL_TPU_NO_NATIVE", raising=False)
    before = km.PACK_STATS[path]
    got = km.pack_codes_2bit(codes, pad_to)
    assert km.PACK_STATS[path] == before + 1
    want = ref_km.pack_codes_2bit(codes, pad_to)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]
    L = (max(pad_to or 0, len(codes)) + 15) & ~15
    assert len(got[0]) == L // 16
    if case == "allsep":
        assert got[2] == 0 and (got[1] == km.EXC_PAD).all()
    if case == "nflood":
        assert len(got[1]) > (L >> 6)
    if case == "trailsep":
        assert got[2] == 3001


def _write_bam(path, reads):
    """Unmapped reads as a gzip BAM, 4-bit bases, no qualities."""
    seq16 = "=ACMGRSVTWYHKDBN"
    out = bytearray(b"BAM\x01")
    text = b"@HD\tVN:1.6\n"
    out += struct.pack("<i", len(text)) + text + struct.pack("<i", 0)
    for i, s in enumerate(reads):
        name = f"r{i}".encode() + b"\x00"
        packed = bytearray((len(s) + 1) // 2)
        for j, ch in enumerate(s):
            packed[j // 2] |= seq16.index(ch) << (4 if j % 2 == 0 else 0)
        rec = struct.pack("<iiBBHHHiiii", -1, -1, len(name), 0, 4680, 0, 4,
                          len(s), -1, -1, 0) + name + bytes(packed) \
            + b"\xff" * len(s)
        out += struct.pack("<i", len(rec)) + rec
    with gzip.open(path, "wb") as f:
        f.write(bytes(out))


@pytest.mark.parametrize("fmt", ["fasta", "fastq.gz", "bam"])
def test_sequence_chunks_match_reference(tmp_path, fmt):
    rng = np.random.default_rng(8)
    reads = ["".join("ACGTN"[c] for c in rng.integers(0, 5, size=int(m)))
             for m in rng.integers(10, 300, size=40)]
    if fmt == "fasta":
        path = str(tmp_path / "r.fa")
        with open(path, "w") as f:
            f.write("".join(f">r{i}\n{s[:60]}\n{s[60:]}\n"
                            for i, s in enumerate(reads)))
    elif fmt == "fastq.gz":
        path = str(tmp_path / "r.fq.gz")
        with gzip.open(path, "wt") as f:
            f.write("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                            for i, s in enumerate(reads)))
    else:
        path = str(tmp_path / "r.bam")
        _write_bam(path, reads)
    for k, chunk in ((5, 512), (21, 1 << 12)):
        got = list(seq.SequenceChunker([path], k, chunk, deterministic=True))
        want = list(ref_seq.SequenceChunker([path], k, chunk,
                                            deterministic=True))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_reports_match_reference(capsysbinary):
    rng = np.random.default_rng(2)
    k = 19
    hi, lo = _sorted_kmers(rng, 800, k)
    counts = rng.integers(1, 40, size=len(lo)).astype(np.uint32)
    outs = []
    for rep, hist in ((reports, MerylHistogram), (ref_reports, RefHistogram)):
        rep.print_kmers(hi, lo, counts, k)
        rep.print_kmers(hi, lo, counts, k, acgt_order=True)
        h = hist.from_counts(counts)
        rep.report_histogram(h)
        rep.report_statistics(h, k)
        outs.append(capsysbinary.readouterr().out)
    assert outs[0] == outs[1] and outs[0]
