"""meryl2-torch (meryl_tpu_torch.v2.cli) against meryl2 (meryl_tpu.v2.cli)
on the CPU: the same words through both `main`s give the same exit
code, the same printed bytes, and byte-equal DBs, lists, histograms and
statistics; flat and row-packed layouts (Evaluator.ROWPACK_MIN set to
2^60 and to 1 on both); the v1 aliases also equal the port's own v1
CLI."""

import glob
import os
import random

import numpy as np
import pytest
import torch

from meryl_tpu import kmer as ref_km
from meryl_tpu import oracle
from meryl_tpu.db import MerylDB
from meryl_tpu.v2 import cli as ref_v2
from meryl_tpu_torch import cli as v1
from meryl_tpu_torch import counter
from meryl_tpu_torch.v2 import cli as v2

K = 9
LAYOUTS = {"flat": 1 << 60, "rows": 1}


def _seq(rng, n):
    return "".join(ref_km.ALPHABET[c] for c in rng.integers(0, 4, size=n))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Three labelled K=9 DBs (A, B, C) that share stretches of one
    sequence, a K=11 DB, a multiset DB, a k-mer list and two FASTA
    files."""
    root = tmp_path_factory.mktemp("v2cli")
    rng = np.random.default_rng(77)
    s = _seq(rng, 2000)
    seqs = {"A": s[:1500], "B": s[500:] + _seq(rng, 300),
            "C": s[200:1100] + _seq(rng, 400)}
    paths = {}
    for name, seq in seqs.items():
        hi, lo, _ = oracle.count_kmers([seq], K)
        c = rng.integers(1, 50, size=len(lo)).astype(np.uint32)
        lab = rng.integers(0, 1 << 20, size=len(lo)).astype(np.uint64)
        paths[name] = str(root / f"{name}.meryl")
        MerylDB.write(paths[name], K, hi, lo, c, labels=lab)
    hi, lo, c = oracle.count_kmers([_seq(rng, 500)], 11)
    paths["K11"] = str(root / "k11.meryl")
    MerylDB.write(paths["K11"], 11, hi, lo, c)
    hi, lo, c = oracle.count_kmers([_seq(rng, 600)], K)
    rep = np.sort(np.concatenate([np.arange(len(lo)), np.arange(0, len(lo), 4)]))
    paths["M"] = str(root / "m.meryl")
    MerylDB.write(paths["M"], K, hi[rep], lo[rep], c[rep], multiset=True)
    paths["L"] = str(root / "kmers.txt")
    with open(paths["L"], "w") as f:
        f.write("".join(f"{_seq(rng, K)} {v}\n"
                        for v in rng.integers(1, 9, size=200)))
    for name in ("FA", "FB"):
        paths[name] = str(root / f"{name}.fa")
        with open(paths[name], "w") as f:
            f.write("".join(f">s{i}\n{_seq(rng, 300)}\n" for i in range(12)))
    return paths


def _outputs(prefix):
    """Every file written under `prefix*` (DB directories file by file),
    keyed by name relative to the prefix."""
    got = {}
    for p in sorted(glob.glob(prefix + "*")):
        name = p[len(prefix):]
        if os.path.isdir(p):
            for f in sorted(os.listdir(p)):
                with open(os.path.join(p, f), "rb") as fh:
                    got[f"{name}/{f}"] = fh.read()
        else:
            with open(p, "rb") as fh:
                got[name] = fh.read()
    return got


def _both(capsysbinary, monkeypatch, tmp_path, data, words, layout="flat"):
    """Run the words (templates over `data` and {out}) through both
    mains -> (rc, stdout, stderr, outputs) of each, the port's stderr
    with its program name replaced by the reference's."""
    for mod in (ref_v2, v2):
        monkeypatch.setattr(mod.Evaluator, "ROWPACK_MIN", LAYOUTS[layout])
    res = {}
    for name, main, extra in (("ref", ref_v2.main, []),
                              ("port", v2.main, ["device=cpu"])):
        out = str(tmp_path / f"{name}_")
        argv = [w.format(out=out, **data) for w in words] + extra
        rc = main(argv)
        cap = capsysbinary.readouterr()
        res[name] = (rc, cap.out,
                     cap.err.replace(b"meryl2-torch:", b"meryl2:"),
                     _outputs(out))
    monkeypatch.delenv("MERYL_TPU_THREADS", raising=False)
    return res["ref"], res["port"]


MERGE_CMDS = [
    ["union-sum", "o:show", "{A}", "{B}"],
    ["intersect", "assign:value=min", "assign:label=xor", "o:show", "{A}",
     "{B}", "{C}"],
    ["union", "not", "select:input:@2", "o:show", "{A}", "{B}", "{C}"],
    ["union-max", "select:value:>=30", "or", "select:label:<1000h", "o:show",
     "{A}", "{B}", "{C}"],
    ["union", "select:bases:gc:>=5", "and", "not", "select:input:first",
     "o:show", "{A}", "{B}"],
    ["union-sum", "assign:value=mul#100000000", "assign:label=rotate-left#33",
     "o:show", "{A}", "{B}", "{C}"],
    ["union", "assign:value=divzero#3", "assign:label=shift-right#7",
     "select:input:2-all", "o:show", "{A}", "{B}", "{C}"],
    ["union", "value=mod#7", "label=heaviest", "o:show", "{A}", "{B}", "{C}"],
    ["[union-sum", "output:database={out}u.meryl", "o:show", "{A}",
     "[intersect", "{B}", "{C}]]"],
    ["[", "union-sum", "output:pipe=x", "{A}", "{B}", "]", "[",
     "greater-than", "30", "o:show", "input:pipe=x", "]"],
    ["union", "output:list={out}l.txt", "output:listACGT={out}a.txt",
     "{A}", "{B}"],
    ["union-sum", "output:list={out}##.txt", "{A}", "{C}"],
    ["union-sum", "output:histogram={out}h.txt",
     "output:statistics={out}s.txt", "{A}", "{B}"],
    ["histogram", "{A}"],
    ["statistics", "{B}"],
    ["union-sum", "o:show", "select:value:>=distinct=0.9", "{A}"],
    ["union", "o:show", "select:value:<word-frequency=0.003", "{B}"],
    ["union-sum", "o:show", "{A}", "{B}", "{C}", "{A}", "{B}", "{C}", "{A}"],
    ["union-sum", "o:show", "{M}", "{A}"],
    ["intersect-min", "o:show", "{A}", "{L}"],
    ["print", "[less-than", "20", "{A}]"],
]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("cmd", MERGE_CMDS, ids=lambda c: "_".join(c[:2]))
def test_commands_match_reference(data, capsysbinary, monkeypatch, tmp_path,
                                  cmd, layout):
    ref, port = _both(capsysbinary, monkeypatch, tmp_path, data, cmd, layout)
    assert port == ref
    assert ref[0] == 0 and (ref[1] or ref[3])


@pytest.mark.parametrize("cmd", [
    ["-k", "9", "count", "label=#5", "{FA}", "output:database={out}c.meryl"],
    ["-k", "9", "-l", "8", "count", "label=#1ffh", "{FA}", "o:db={out}c.meryl"],
    ["-k", "9", "count-forward", "value=#3", "{FA}", "o:show"],
    ["-k", "9", "compress", "count-reverse", "{FB}", "output={out}c.meryl",
     "histogram"],
    ["-k", "9", "union-sum", "o:show", "[count", "label=#1", "{FA}]",
     "[count", "label=#2", "{FB}]"],
    ["-k9", "-t", "2", "count", "{FA}", "print={out}p.txt"],
    ["union-sum", "output={out}u.meryl", "[count", "{FB}", "]", "{A}"],
], ids=lambda c: "_".join(c[2:4]))
def test_counting_matches_reference(data, capsysbinary, monkeypatch, tmp_path,
                                    cmd):
    ref, port = _both(capsysbinary, monkeypatch, tmp_path, data, cmd)
    assert port == ref
    assert ref[0] == 0 and (ref[1] or ref[3])


@pytest.mark.parametrize("cmd", [
    ["union", "o:show", "{A}", "{K11}"],
    ["union", "o:show", "bogus-word"],
    ["-m", "lots", "histogram"],
    ["-t", "many", "histogram"],
    ["-l", "99", "union", "{A}"],
    ["-k", "9", "count", "{FA}", "output"],
    ["union", "o:show", "{FA}"],
    ["count", "{FA}", "o:show"],
    ["o:show", "input:pipe=nope"],
], ids=lambda c: "_".join(c[:2]))
def test_errors_match_reference(data, capsysbinary, monkeypatch, tmp_path,
                                cmd):
    ref, port = _both(capsysbinary, monkeypatch, tmp_path, data, cmd)
    assert port == ref
    assert ref[0] == 1 and ref[2].startswith(b"meryl2: ")


def test_program_file_matches_reference(data, capsysbinary, monkeypatch,
                                        tmp_path):
    prog = tmp_path / "prog.txt"
    prog.write_text(f"# union-sum, shown\nunion-sum o:show  # trailing\n"
                    f"'{data['A']}' \"{data['B']}\"\n")
    ref, port = _both(capsysbinary, monkeypatch, tmp_path, data,
                      ["-f", str(prog)])
    assert port == ref and ref[1]


def test_memory_bound_counts_in_batches(data, capsysbinary, monkeypatch,
                                        tmp_path):
    """-m: a tiny bound takes the batched out-of-core count in the port
    as in the reference; equal DBs."""
    monkeypatch.setenv("MERYL_TPU_CHUNK", str(1 << 12))
    counter.LAST_BATCH_STATS.clear()
    ref, port = _both(capsysbinary, monkeypatch, tmp_path, data,
                      ["-k", "15", "-m", "0.000003", "count", "{FA}", "{FB}",
                       "output", "{out}m.meryl"])
    assert port == ref and ref[0] == 0
    assert counter.LAST_BATCH_STATS["batches"] > 1


V1_ALIASES = [["union"], ["union-min"], ["union-max"], ["union-sum"],
              ["intersect"], ["intersect-min"], ["intersect-max"],
              ["intersect-sum"], ["subtract"], ["difference"],
              ["symmetric-difference"],
              ["less-than", "20"], ["greater-than", "1"], ["at-least", "2"],
              ["at-most", "3"], ["equal-to", "1"], ["not-equal-to", "1"],
              ["increase", "5"], ["decrease", "3"], ["multiply", "3"],
              ["divide", "2"], ["divide-round", "2"], ["modulo", "7"]]


@pytest.mark.parametrize("i", range(len(V1_ALIASES)),
                         ids=lambda i: V1_ALIASES[i][0])
def test_v1_alias_matches_reference_and_v1(data, capsysbinary, monkeypatch,
                                           tmp_path, i):
    """Every v1 alias: the port's meryl2 equals the reference's meryl2
    byte for byte, and the port's own v1 CLI in k-mers and values (for
    divide-round, which meryl2 maps to divzero, in k-mers)."""
    op = V1_ALIASES[i]
    dbs = ["{A}", "{B}"] if len(op) == 1 else ["{A}"]
    ref, port = _both(capsysbinary, monkeypatch, tmp_path, data,
                      op + ["o:show"] + dbs, ("flat", "rows")[i % 2])
    assert port == ref and ref[0] == 0
    words = [w.format(**data) for w in dbs]
    assert v1.main(["print", "[" + op[0]] + op[1:] + words[:-1] +
                   [words[-1] + "]", "device=cpu"]) == 0
    want = dict(ln.split(b"\t") for ln in
                capsysbinary.readouterr().out.splitlines())
    got = {ln.split(b"\t")[0]: ln.split(b"\t")[1]
           for ln in port[1].splitlines()}
    if op[0] == "divide-round":
        assert set(got) == set(want)
    else:
        assert got == want


def test_composition_fuzz_matches_reference(data, capsysbinary, monkeypatch,
                                            tmp_path):
    """Random (value assign x label assign x input selector x value /
    label terms with and / or / not) programs over the three labelled
    DBs, flat and row-packed by turns."""
    rng = random.Random(101)
    vrules = ["first", "min", "max", "add", "sub", "mul", "div", "divzero",
              "mod", "count"]
    lrules = ["first", "or", "and", "xor", "min", "max", "difference",
              "lightest", "heaviest", "invert", "shift-left", "rotate-right"]
    isels = ["any", "all", "first", "@2", "2", "1-2", "@1-@2", "2-all"]
    rels = [">", "<", ">=", "<=", "==", "!="]
    for trial in range(12):
        vr, lr = rng.choice(vrules), rng.choice(lrules)
        words = [f"assign:value={vr}" + (f"#{rng.randrange(0, 60)}"
                                         if rng.random() < 0.5 else ""),
                 f"assign:label={lr}" + (f"#{rng.randrange(0, 1 << 16):x}h"
                                         if rng.random() < 0.5 else ""),
                 f"select:input:{rng.choice(isels)}"]
        for qty, hi in (("value", 80), ("label", 1 << 18)):
            if rng.random() < 0.7:
                words += [rng.choice(["and", "or"])] + \
                    (["not"] if rng.random() < 0.3 else []) + \
                    [f"select:{qty}:{rng.choice(rels)}{rng.randrange(0, hi)}"]
        ref, port = _both(capsysbinary, monkeypatch, tmp_path, data,
                          words + ["o:show", "{A}", "{B}", "{C}"],
                          ("flat", "rows")[trial % 2])
        assert port == ref and ref[0] == 0, (trial, words)


def _allones_db(path, k=16, count=3):
    """A forward DB holding only GGGG...G (the all-ones k-mer), written
    with the reference's writer."""
    MerylDB.write(path, k, np.zeros(1, np.uint64),
                  np.array([(1 << (2 * k)) - 1], np.uint64),
                  np.array([count], np.uint32), mode="forward")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_all_ones_kmer_first_in_row_is_kept(capsysbinary, monkeypatch,
                                            tmp_path, layout):
    """At k = 16 the all-ones k-mer (poly-G) aliases the padding
    sentinel.  When it opens a dispatch row, the reference's compute
    stage takes it for a continuation of padding and drops it; the port
    starts a run at column 0 and keeps it, equal to a brute force."""
    pg = str(tmp_path / "pg.meryl")
    _allones_db(pg)
    data = {"PG": pg}
    ref, port = _both(capsysbinary, monkeypatch, tmp_path, data,
                      ["union-sum", "o:show", "output:database={out}o.meryl",
                       "{PG}"], layout)
    want = b"G" * 16 + b"\t3\t0\n"
    assert port[0] == 0 and port[1] == want
    db = MerylDB.open(str(tmp_path / "port_o.meryl"))
    hi, lo, c = db.load_all()
    assert (list(hi), list(lo), list(c)) == ([0], [(1 << 32) - 1], [3])
    # the reference drops it (a plain assert: if the reference changes,
    # this test says so)
    assert ref[0] == 0 and ref[1] == b""
    hi, lo, c = MerylDB.open(str(tmp_path / "ref_o.meryl")).load_all()
    assert len(c) == 0


def test_cuda_default_without_cuda_fails(data, capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "x.meryl")
    for extra in ([], ["device=cuda"]):
        assert v2.main(["union-sum", data["A"], data["B"], "output", out,
                        *extra]) == 1
        err = capsys.readouterr().err
        assert err.startswith("meryl2-torch: ") and \
            "torch.cuda.is_available() is false" in err
    assert v2.main(["union", data["A"], "device=tpu"]) == 1
    assert capsys.readouterr().err.startswith("meryl2-torch: ")
    assert not os.path.exists(out)
