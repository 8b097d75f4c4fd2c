"""The plain reference against hand-made fixtures."""

import os

import numpy as np
import pytest
import torch

from reference import dbfile, kmers, reads as rd
from reference.meryl import Reference, Unsupported, merge, statistics_text

CODE = {"A": 0, "C": 1, "T": 2, "G": 3, "N": 4}


def codes(s):
    return np.array([CODE[c] for c in s], np.uint8)


def brute(seqs, k):
    """Canonical k-mer counts by a dict, string by string."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    out = {}
    for s in seqs:
        for i in range(len(s) - k + 1):
            w = s[i:i + k]
            if "N" in w:
                continue
            f = r = 0
            for ch in w:
                f = 4 * f + CODE[ch]
            for ch in reversed(w):
                r = 4 * r + CODE[comp[ch]]
            key = min(f, r)
            out[key] = out.get(key, 0) + 1
    return out


READS = ["ACGTTGCAAGGCT", "GGGGGCCCCCAAN", "TTAGNCCATG", "AC", "CATGCATGCATG"]


@pytest.mark.parametrize("k", [1, 3, 5, 8])
@pytest.mark.parametrize("chunk", [1, 7, 1 << 20])
def test_count_matches_dict(k, chunk):
    c = np.concatenate([codes(s) for s in READS])
    lens = np.array([len(s) for s in READS], np.int64)
    keys, counts = kmers.count(c, lens, k, "cpu", chunk_bases=chunk)
    want = brute(READS, k)
    assert keys.tolist() == sorted(want)
    assert counts.tolist() == [want[x] for x in sorted(want)]


@pytest.mark.parametrize("chunk", [1, 7, 1 << 20])
def test_control_counts_across_reads(chunk):
    """boundaries=False reads the reads as one stream."""
    c = np.concatenate([codes(s) for s in READS])
    lens = np.array([len(s) for s in READS], np.int64)
    keys, counts = kmers.count(c, lens, 4, "cpu", boundaries=False,
                               chunk_bases=chunk)
    want = brute(["".join(READS)], 4)
    assert dict(zip(keys.tolist(), counts.tolist())) == want
    assert want != brute(READS, 4)


def test_existence_per_read():
    q = ["ACGTTG", "CCCCCAANGG", "TTAGC"]
    c = np.concatenate([codes(s) for s in q])
    lens = np.array([len(s) for s in q], np.int64)
    table = np.array(sorted(brute(["ACGTT", "CCCCA"], 3)), np.int64)
    total, (found,) = kmers.existence(c, lens, 3, [table], "cpu")
    assert total.tolist() == [4, 5, 3]
    per = []
    for s in q:
        n = 0
        for i in range(len(s) - 2):
            if "N" not in s[i:i + 3] and \
                    next(iter(brute([s[i:i + 3]], 3))) in set(table.tolist()):
                n += 1
        per.append(n)
    assert found.tolist() == per


def db(d):
    k = np.array(sorted(d), np.int64)
    return k, np.array([d[x] for x in sorted(d)], np.int64)


A = {1: 3, 2: 1, 5: 7, 9: 2}
B = {2: 4, 5: 7, 6: 1}


@pytest.mark.parametrize("op,thr,want", [
    ("union", None, {1: 1, 2: 2, 5: 2, 6: 1, 9: 1}),
    ("union-min", None, {1: 3, 2: 1, 5: 7, 6: 1, 9: 2}),
    ("union-max", None, {1: 3, 2: 4, 5: 7, 6: 1, 9: 2}),
    ("union-sum", None, {1: 3, 2: 5, 5: 14, 6: 1, 9: 2}),
    ("intersect", None, {2: 1, 5: 7}),
    ("intersect-min", None, {2: 1, 5: 7}),
    ("intersect-max", None, {2: 4, 5: 7}),
    ("intersect-sum", None, {2: 5, 5: 14}),
    ("difference", None, {1: 3, 9: 2}),
    ("symmetric-difference", None, {1: 3, 9: 2, 6: 1}),
    ("subtract", None, {1: 3, 9: 2}),
])
def test_two_input_rules(op, thr, want):
    keys, vals = merge(op, [db(A), db(B)], thr, "cpu")
    assert dict(zip(keys.tolist(), vals.tolist())) == want


@pytest.mark.parametrize("op,thr,want", [
    ("greater-than", 2, {1: 3, 5: 7}),
    ("less-than", 3, {2: 1, 9: 2}),
    ("at-least", 3, {1: 3, 5: 7}),
    ("at-most", 2, {2: 1, 9: 2}),
    ("equal-to", 7, {5: 7}),
    ("not-equal-to", 7, {1: 3, 2: 1, 9: 2}),
    ("increase", 1, {1: 4, 2: 2, 5: 8, 9: 3}),
    ("decrease", 2, {1: 1, 5: 5}),
    ("multiply", 3, {1: 9, 2: 3, 5: 21, 9: 6}),
    ("divide", 2, {1: 1, 5: 3, 9: 1}),
    ("divide-round", 2, {1: 2, 2: 1, 5: 4, 9: 1}),
    ("modulo", 2, {1: 1, 2: 1, 5: 1}),
])
def test_one_input_rules(op, thr, want):
    keys, vals = merge(op, [db(A)], thr, "cpu")
    assert dict(zip(keys.tolist(), vals.tolist())) == want


def test_wrapping_values():
    keys, vals = merge("union-sum", [db({3: 2 ** 32 - 1}), db({3: 5})],
                       None, "cpu")
    assert vals.tolist() == [4]
    keys, vals = merge("multiply", [db({3: 2 ** 31 + 3})], 2 ** 31 + 1,
                       "cpu")
    assert vals.tolist() == [((2 ** 31 + 3) * (2 ** 31 + 1)) % 2 ** 32]


def test_statistics_and_histogram_text():
    from reference.meryl import histogram_text
    assert histogram_text(np.array([1, 1, 3])) == "1\t2\n3\t1\n"
    text = statistics_text(np.array([1, 1, 3]), 2)
    assert text.splitlines()[1] == "  unique   " + " " * 19 + \
        "2  (exactly one instance of the kmer is in the input)"
    assert text.splitlines()[4].split()[:2] == ["missing", "13"]
    assert text.splitlines()[-1] == \
        "%9d %12d %12.4f %12.4f %12.6f" % (3, 1, 1.0, 1.0, 3 / 5 * 1e6)


def test_commands_chain(tmp_path):
    seq = {"r.fq": rd.ReadSet(np.concatenate([codes(s) for s in READS]),
                              np.array([len(s) for s in READS]), "r")}
    ref = Reference(3, "cpu", seq)
    a = ref.run("meryl", ["count", "k=3", "r.fq", "output", "a"])["db"]["a"]
    want = brute(READS, 3)
    assert dict(zip(a[0].tolist(), a[1].tolist())) == want
    g = ref.run("meryl", ["greater-than", "1", "a", "output", "g"])["db"]["g"]
    assert dict(zip(g[0].tolist(), g[1].tolist())) == \
        {x: v for x, v in want.items() if v > 1}
    h = ref.run("meryl", ["histogram", "g"])
    assert h["stdout"].startswith("2\t") and not h["db"]
    with pytest.raises(Unsupported):
        ref.run("meryl", ["[greater-than", "1", "a]", "output", "x"])
    with pytest.raises(Unsupported):
        ref.run("meryl", ["count", "k=4", "r.fq", "output", "b"])


def test_db_roundtrip(tmp_path):
    k = 5
    keys = np.array([1, 40, 300, 1000, 4 ** 5 - 1], np.uint64)
    counts = np.array([1, 2, 3, 4, 1], np.uint32)
    dbfile.write(str(tmp_path / "d"), k, keys, counts)
    got = dbfile.read(str(tmp_path / "d"), k)
    assert got.keys.tolist() == keys.tolist()
    assert got.counts.tolist() == counts.tolist()
    assert (dbfile.prefix6(got.keys, k) == got.bucket).all()
    assert got.index["numDistinct"] == 5 and got.index["numUnique"] == 2
    assert got.histogram == ["1\t2", "2\t1", "3\t1", "4\t1"]
    assert len(os.listdir(tmp_path / "d")) == 66


def test_reads_same_seed_same_inputs(tmp_path):
    spec = {"length": {"fixed": 50}, "substitution_rate": 0.01,
            "n_rate": 0.01}
    big = 2 ** 31 + 7

    def make(seed):
        g = rd.make_genome(5000, seed)
        return g, rd.make_reads(g, spec, 3, seed, 1, "r")

    g1, r1 = make(big)
    g2, r2 = make(big)
    g3, r3 = make(big + 1)
    assert np.array_equal(g1, g2) and np.array_equal(r1.codes, r2.codes)
    assert not np.array_equal(g1, g3)
    assert not np.array_equal(r1.codes, r3.codes)
    # a seed changes which bases are read, not how much work there is
    assert r1.bases == r3.bases and r1.n_reads == r3.n_reads
    assert r1.n_n > 0 and abs(r1.n_n - r3.n_n) <= r1.n_n // 10 + 2
    p1, p2 = tmp_path / "a.fq", tmp_path / "b.fq"
    rd.write_fastq(str(p1), r1)
    rd.write_fastq(str(p2), r2)
    assert p1.read_bytes() == p2.read_bytes()


def test_variable_lengths_fixed_across_seeds():
    spec = {"length": {"lognormal_mean": 400, "lognormal_sigma": 0.3,
                       "min": 100, "max": 900, "draw_seed": 3},
            "substitution_rate": 0.0, "n_rate": 0.0}
    g = rd.make_genome(20000, 1)
    a = rd.make_reads(g, spec, 4, 1, 0, "r")
    b = rd.make_reads(g, spec, 4, 2, 0, "r")
    assert sorted(a.lens.tolist()) == sorted(b.lens.tolist())
    assert a.bases >= 4 * 20000
    # reads are the genome or its reverse complement
    s = a.starts[0]
    read = a.codes[s:s + a.lens[0]]
    gs = rd.LETTERS[g].tobytes()
    rc = rd.LETTERS[read[::-1] ^ 2].tobytes()
    assert rd.LETTERS[read].tobytes() in gs or rc in gs


def test_qualities_follow_the_model(tmp_path):
    spec = {"length": {"fixed": 100}, "substitution_rate": 0.0,
            "n_rate": 0.0}
    model = {"symbols": "AB", "start": [1, 0], "end": [0, 3]}
    g = rd.make_genome(20000, 4)
    rs = rd.make_reads(g, spec, 20, 4, 0, "r")
    q = rd.make_qualities(rs, model, 4, 0)
    assert q.size == rs.bases
    assert np.array_equal(q, rd.make_qualities(rs, model, 4, 0))
    assert not np.array_equal(q, rd.make_qualities(rs, model, 5, 0))
    first, last = q[rs.starts], q[rs.starts + rs.lens - 1]
    assert (first == ord("A")).all() and (last == ord("B")).all()
    mid = np.concatenate([q[rs.starts + 49], q[rs.starts + 50]])
    assert 0.4 < np.mean(mid == ord("B")) < 0.6
    rd.write_fastq(str(tmp_path / "r.fq"), rs, q)
    lines = (tmp_path / "r.fq").read_bytes().split(b"\n")
    assert b"".join(lines[3::4]) == q.tobytes()
    with pytest.raises(ValueError, match="weight"):
        rd.make_qualities(rs, {"symbols": "AB", "start": [1],
                               "end": [1, 1]}, 4, 0)
    hifi = {"length": {"lognormal_mean": 400, "lognormal_sigma": 0.3,
                       "min": 100, "max": 900, "draw_seed": 3},
            "substitution_rate": 0.0, "n_rate": 0.0}
    with pytest.raises(ValueError, match="one length"):
        rd.make_qualities(rd.make_reads(g, hifi, 4, 4, 0, "r"), model, 4, 0)


def test_fastq_and_fasta_parse(tmp_path):
    from meryl_tpu_torch.io.sequence import iter_sequences
    g = rd.make_genome(1000, 9)
    rs = rd.make_reads(g, {"length": {"fixed": 30}, "substitution_rate": 0,
                           "n_rate": 0.05}, 2, 9, 0, "q")
    rd.write_fastq(str(tmp_path / "r.fq"), rs)
    got = list(iter_sequences(str(tmp_path / "r.fq")))
    assert [n for n, _, _ in got] == rs.names()
    assert b"".join(s for _, s, _ in got) == rd.LETTERS[rs.codes].tobytes()
    for n in (959, 960, 961):
        rd.write_fasta(str(tmp_path / "a.fa"), "asm", g[:n], 80)
        (name, s, _), = iter_sequences(str(tmp_path / "a.fa"))
        assert name == "asm" and s == rd.LETTERS[g[:n]].tobytes()


def test_reference_device_agnostic():
    c = np.concatenate([codes(s) for s in READS])
    lens = np.array([len(s) for s in READS], np.int64)
    key, valid = kmers.window_keys(torch.from_numpy(c), torch.from_numpy(
        lens), 3)
    assert key.dtype == torch.int64 and valid.sum().item() == \
        sum(brute(READS, 3).values())
