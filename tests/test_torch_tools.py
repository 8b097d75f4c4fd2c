"""The port's copies of the reference's auxiliary tools (oracle,
tools/analyze, tools/import_tool, tools/simple) against the originals:
the same code (docstrings aside, which name the reference's sources),
byte-equal outputs on the same inputs; and every launcher the port adds
under bin/ (the meryl2-*-torch ones too) runs and writes what the
reference writes."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from meryl_tpu import oracle as ref_oracle
from meryl_tpu.tools import analyze as ref_analyze
from meryl_tpu.tools import import_tool as ref_import
from meryl_tpu.tools import simple as ref_simple
from meryl_tpu_torch.db import MerylDB
from meryl_tpu_torch import oracle
from meryl_tpu_torch.tools import analyze, import_tool, simple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ["oracle.py", "tools/analyze.py", "tools/import_tool.py",
          "tools/simple.py"]


def _code(path):
    """The module's AST dump with every docstring removed."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_reference_code(rel):
    assert _code(os.path.join(ROOT, "meryl_tpu_torch", rel)) == \
        _code(os.path.join(ROOT, "meryl_tpu", rel))


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def _seq(rng, n):
    return "".join("ACTG"[c] for c in rng.integers(0, 4, n))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(8)
    with open(d / "in.fa", "w") as f:
        f.write(f">a\n{_seq(rng, 3000)}\n>b\n{_seq(rng, 500)}NN"
                f"{_seq(rng, 700)}\n")
    lines = [f"{_seq(rng, 11)} {int(v)}" for v in rng.integers(1, 50, 300)]
    lines += ["#7", "GGGGGGGGGGG", "ACGTACGTACGTAC 007"]
    with open(d / "kmers.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
    return d


@pytest.mark.parametrize("words", [[], ["-multiset"], ["-forward"],
                                   ["-multiset", "-forward"]])
def test_import_matches_reference(inputs, words):
    d = inputs
    outs = []
    for tag, mod in (("ref", ref_import), ("port", import_tool)):
        out = str(d / f"imp_{tag}_{len(words)}{''.join(words)}.meryl")
        assert mod.main(["-k", "11", "-kmers", str(d / "kmers.txt"),
                         "-output", out, *words]) == 0
        outs.append(_files(out))
    assert outs[0] == outs[1] and len(outs[0]) > 60


@pytest.mark.parametrize("k", [9, 21, 33])
def test_simple_matches_reference(inputs, k):
    d = inputs
    outs = []
    for tag, mod in (("ref", ref_simple), ("port", simple)):
        pre = str(d / f"s_{tag}_{k}")
        assert mod.main(["-k", str(k), "-S", str(d / "in.fa"),
                         "-D", pre + ".dump", "-H", pre + ".hist",
                         "-M", pre + ".meryl"]) == 0
        got = {x: open(pre + x, "rb").read() for x in (".dump", ".hist")}
        got.update(_files(pre + ".meryl"))
        outs.append(got)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("mode", ["-gc", "-ga", "-gt"])
def test_analyze_matches_reference(inputs, mode):
    d = inputs
    db = str(d / "an.meryl")
    if not os.path.exists(db):
        assert ref_import.main(["-k", "11", "-kmers", str(d / "kmers.txt"),
                                "-output", db]) == 0
    outs = []
    for tag, mod in (("ref", ref_analyze), ("port", analyze)):
        pre = str(d / f"an_{tag}")
        assert mod.main(["-mers", db, "-prefix", pre, mode]) == 0
        outs.append({n[len(f"an_{tag}"):]: open(d / n, "rb").read()
                     for n in sorted(os.listdir(d))
                     if n.startswith(f"an_{tag}.")})
    assert outs[0] == outs[1] and outs[0]


@pytest.mark.parametrize("mode", ["canonical", "forward", "reverse"])
def test_oracle_matches_reference(mode):
    rng = np.random.default_rng(3)
    seqs = [_seq(rng, 400), "NNACGTN" + _seq(rng, 90), "acgtTTGCA"]
    for k in (5, 17, 40):
        got = oracle.count_kmers(seqs, k, mode=mode)
        want = ref_oracle.count_kmers(seqs, k, mode=mode)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(oracle.histogram(got[2]), ref_oracle.histogram(want[2])):
            np.testing.assert_array_equal(a, b)


def _launch(name, args):
    r = subprocess.run([sys.executable, os.path.join(ROOT, "bin", name),
                        *args], capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, (name, r.stderr)
    return r


def test_launchers_write_what_the_reference_writes(inputs, tmp_path):
    """bin/meryl-import-torch, -simple-torch, -analyze-torch,
    meryl-lookup-torch and position-lookup-torch (-device cpu) against
    the reference's functions on the same inputs."""
    from meryl_tpu import lookup_cli as ref_lookup
    from meryl_tpu.tools import position_lookup as ref_pl

    d = inputs
    db = str(tmp_path / "imp.meryl")
    _launch("meryl-import-torch", ["-k", "11", "-kmers",
                                   str(d / "kmers.txt"), "-output", db])
    ref_db = str(tmp_path / "imp_ref.meryl")
    ref_import.main(["-k", "11", "-kmers", str(d / "kmers.txt"),
                     "-output", ref_db])
    assert _files(db) == _files(ref_db)
    for tag in ("ref", "port"):
        pre = str(tmp_path / f"simple_{tag}")
        args = ["-k", "11", "-S", str(d / "in.fa"), "-D", pre + ".dump",
                "-M", pre + ".meryl"]
        if tag == "port":
            _launch("meryl-simple-torch", args)
        else:
            ref_simple.main(args)
        pre = str(tmp_path / f"an_{tag}")
        args = ["-mers", db, "-prefix", pre, "-gc"]
        if tag == "port":
            _launch("meryl-analyze-torch", args)
        else:
            ref_analyze.main(args)
        out = str(tmp_path / f"lk_{tag}.bed")
        args = ["-bed", "-sequence", str(d / "in.fa"), "-mers",
                str(tmp_path / "simple_ref.meryl"), "-output", out]
        if tag == "port":
            _launch("meryl-lookup-torch", args + ["-device", "cpu"])
        else:
            ref_lookup.main(args)
        pre = str(tmp_path / f"pl_{tag}")
        args = ["-m", str(tmp_path / "simple_ref.meryl"), "-s",
                str(d / "in.fa"), "-hpq", pre + ".hpq", "-mpb", pre + ".mpb",
                str(d / "in.fa")]
        if tag == "port":
            _launch("position-lookup-torch", args + ["-device", "cpu"])
        else:
            ref_pl.main(args)
    for x in ("simple_{}.dump", "an_{}.GC.hist", "an_{}.AT.hist",
              "lk_{}.bed", "pl_{}.hpq", "pl_{}.mpb"):
        a = open(tmp_path / x.format("port"), "rb").read()
        b = open(tmp_path / x.format("ref"), "rb").read()
        assert a == b and a, x
    assert _files(str(tmp_path / "simple_port.meryl")) == \
        _files(str(tmp_path / "simple_ref.meryl"))


def test_meryl2_launchers_write_what_the_reference_writes(inputs, tmp_path):
    """bin/meryl2-import-torch (labels, -labelwidth), meryl2-lookup-torch
    -existence -device cpu on that label DB, meryl2-analyze-torch,
    meryl2-simple-torch and meryl2-torch (a labelled count, device=cpu)
    against the reference's functions on the same inputs."""
    from meryl_tpu import lookup_cli as ref_lookup
    from meryl_tpu.v2 import cli as ref_v2

    d = inputs
    kf = tmp_path / "k.txt"
    kf.write_text("value=5\nlabel=0x3\nAAAAAAAAC\nAAAAAAAAG 7\n"
                  "AAAAAAAGG 2 0x9\nAAAAAAAAC 1 0x4\n" +
                  "".join(f"{_seq(np.random.default_rng(i), 9)} {i} {i}\n"
                          for i in range(1, 40)))
    q = tmp_path / "q.fa"
    q.write_text(">q\nAAAAAAAACGGTACCA\n>r\n" + _seq(
        np.random.default_rng(2), 300) + "\n")
    for tag in ("ref", "port"):
        pre = str(tmp_path / tag)
        steps = [
            ("meryl2-import-torch", ref_import.main,
             ["-k", "9", "-kmers", str(kf), "-output", pre + ".meryl",
              "-forward", "-labelwidth", "8"]),
            ("meryl2-lookup-torch", ref_lookup.main,
             ["-existence", "-sequence", str(q), "-mers", pre + ".meryl",
              "-output", pre + ".exist"]),
            ("meryl2-analyze-torch", ref_analyze.main,
             ["-mers", pre + ".meryl", "-prefix", pre + "_an", "-gc"]),
            ("meryl2-simple-torch", ref_simple.main,
             ["-k", "11", "-S", str(d / "in.fa"), "-D", pre + ".dump"]),
            ("meryl2-torch", ref_v2.main,
             ["-k", "11", "count", "label=#3", str(d / "in.fa"),
              f"output:database={pre}_c.meryl"]),
        ]
        for launcher, ref_main, args in steps:
            if tag == "port":
                extra = {"meryl2-lookup-torch": ["-device", "cpu"],
                         "meryl2-torch": ["device=cpu"]}.get(launcher, [])
                _launch(launcher, args + extra)
            else:
                assert ref_main(args) == 0, launcher
    for x in ("{}.exist", "{}_an.GC.hist", "{}.dump"):
        a = open(tmp_path / x.format("port"), "rb").read()
        b = open(tmp_path / x.format("ref"), "rb").read()
        assert a == b and a, x
    for x in ("{}.meryl", "{}_c.meryl"):
        a, b = (_files(str(tmp_path / x.format(t))) for t in ("port", "ref"))
        assert a == b and len(a) > 60, x
    assert MerylDB.open(str(tmp_path / "port.meryl")).meta["labelBits"] == 8
