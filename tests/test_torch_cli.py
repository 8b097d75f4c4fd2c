"""meryl_tpu_torch command line against meryl_tpu's, and the port's
independence from JAX."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from meryl_tpu import cli as ref_cli
from meryl_tpu import kmer as km
from meryl_tpu.db import MerylDB, bucket_name
from meryl_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "meryl_tpu_torch")


def _db(path):
    hi, lo, c = MerylDB.open(path).load_all()
    return {(int(h) << 64) | int(l): int(v) for h, l, v in zip(hi, lo, c)}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(11)
    fq = str(root / "reads.fq")
    genome = rng.integers(0, 4, size=3000)
    with open(fq, "w") as f:
        for i in range(150):
            s = int(rng.integers(0, 3000 - 120))
            read = "".join(km.ALPHABET[c] for c in genome[s:s + 120])
            if i % 7 == 0:
                read = read[:50] + "N" + read[51:]
            if i % 11 == 0:
                read = read[:30] + "GGGGGG" + read[36:]
            f.write(f"@r{i}\n{read}\n+\n{'I' * len(read)}\n")
    return root, fq


@pytest.mark.parametrize("op,compress", [("count", False),
                                         ("count-forward", True),
                                         ("count-reverse", False)])
def test_cli_db_matches_reference(reads, monkeypatch, op, compress):
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    root, fq = reads
    extra = ["compress"] if compress else []
    ref_db = str(root / f"ref_{op}.meryl")
    assert ref_cli.main(["k=21", op, *extra, fq, "output", ref_db]) == 0
    db = str(root / f"port_{op}.meryl")
    assert cli.main([op, "k=21", *extra, fq, "output", db,
                     "device=cpu"]) == 0
    assert _db(db) == _db(ref_db)
    assert MerylDB.open(db).mode == MerylDB.open(ref_db).mode


def test_python_m_count_matches_reference(reads, monkeypatch):
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    root, fq = reads
    ref_db = str(root / "ref_m.meryl")
    assert ref_cli.main(["k=21", "count", fq, "output", ref_db]) == 0
    db = str(root / "port_m.meryl")
    env = dict(os.environ, MERYL_TPU_DEVICE_ACC="1", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "meryl_tpu_torch", "count",
                        "k=21", fq, "output", db, "device=cpu"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert _db(db) == _db(ref_db)


_NO_JAX = r"""
import os, sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["meryl_tpu"] = None    # nor of the reference package
import numpy as np
from meryl_tpu_torch.cli import main
from meryl_tpu_torch.db import MerylDB
fa, out = sys.argv[1], sys.argv[2]
seqs = [l.strip() for l in open(fa) if not l.startswith(">")]
comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
code = {"A": 0, "C": 1, "T": 2, "G": 3}
want = {}
for s in seqs:
    for i in range(len(s) - 20):
        w = s[i:i + 21]
        if "N" in w:
            continue
        f = r = 0
        for ch in w:
            f = f * 4 + code[ch]
        for ch in reversed(w):
            r = r * 4 + code[comp[ch]]
        want[min(f, r)] = want.get(min(f, r), 0) + 1
for acc in ("1", "0"):
    os.environ["MERYL_TPU_DEVICE_ACC"] = acc
    db = out + acc
    assert main(["count", "k=21", fa, "output", db, "device=cpu"]) == 0
    hi, lo, c = MerylDB.open(db).load_all()
    got = {(int(h) << 64) | int(l): int(v) for h, l, v in zip(hi, lo, c)}
    assert got == want, acc
assert not any(m.split(".")[0] in ("jax", "meryl_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("OK", len(want))
"""


def test_counts_with_jax_blocked(tmp_path):
    rng = np.random.default_rng(4)
    fa = str(tmp_path / "in.fa")
    with open(fa, "w") as f:
        for i in range(30):
            s = "".join(km.ALPHABET[c] for c in rng.integers(0, 4, 200))
            if i % 5 == 0:
                s = s[:90] + "NN" + s[92:]
            f.write(f">s{i}\n{s}\n")
    r = subprocess.run([sys.executable, "-c", _NO_JAX, fa,
                        str(tmp_path / "out")], capture_output=True,
                       text=True, timeout=300, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")


def _imports(path, package):
    """Absolute names of the modules `path` imports (and of the names
    it imports from them), relative imports resolved against
    `package`."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = package.split(".")
                base = ".".join(parts[:len(parts) - node.level + 1])
                mod = f"{base}.{node.module}" if node.module else base
            else:
                mod = node.module
            yield mod
            for a in node.names:
                yield f"{mod}.{a.name}"


LAUNCHERS = ["meryl-torch", "meryl-lookup-torch", "position-lookup-torch",
             "meryl-analyze-torch", "meryl-import-torch",
             "meryl-simple-torch", "meryl2-torch", "meryl2-lookup-torch",
             "meryl2-import-torch", "meryl2-analyze-torch",
             "meryl2-simple-torch"]


def _port_files():
    """(path, package) of every Python file of the port, chip_smoke.py
    and the port's launchers under bin/."""
    files = [(os.path.join(ROOT, "chip_smoke.py"), "")]
    files += [(os.path.join(ROOT, "bin", n), "") for n in LAUNCHERS]
    for d, _, names in os.walk(PORT):
        pkg = os.path.relpath(d, ROOT).replace(os.sep, ".")
        files += [(os.path.join(d, n), pkg) for n in names
                  if n.endswith(".py")]
    return files


def test_port_imports_no_jax():
    """Neither jax nor anything of meryl_tpu (whose __init__ imports jax
    where it is installed): the port keeps its own host modules."""
    files = _port_files()
    assert len(files) > 20
    seen = set()
    for path, pkg in files:
        for mod in _imports(path, pkg):
            top = mod.split(".")[0]
            assert top not in ("jax", "meryl_tpu"), (path, mod)
            seen.add(mod)
    # the relative imports of the copied host modules resolve inside
    # the port
    for mod in ("meryl_tpu_torch.kmer", "meryl_tpu_torch.native",
                "meryl_tpu_torch.resources", "meryl_tpu_torch.io.bam",
                "meryl_tpu_torch.io.cram", "meryl_tpu_torch.db",
                "meryl_tpu_torch.oracle", "meryl_tpu_torch.lookup",
                "meryl_tpu_torch.ops.bacjoin", "meryl_tpu_torch.v2.engine",
                "meryl_tpu_torch.v2.parser",
                "meryl_tpu_torch.parallel.shard_count",
                "meryl_tpu_torch.parallel.local_group",
                "meryl_tpu_torch.parallel.multihost",
                "meryl_tpu_torch.parallel.scaling",
                "meryl_tpu_torch.io.sequence.open_maybe_compressed"):
        assert mod in seen, mod
    # each launcher imports its tool's main from the port
    for mod in ("meryl_tpu_torch.cli.main", "meryl_tpu_torch.lookup_cli.main",
                "meryl_tpu_torch.tools.position_lookup.main",
                "meryl_tpu_torch.tools.analyze.main",
                "meryl_tpu_torch.tools.import_tool.main",
                "meryl_tpu_torch.tools.simple.main",
                "meryl_tpu_torch.v2.cli.main"):
        assert mod in seen, mod
    for rel in ("lookup.py", "lookup_cli.py", "ops/bacjoin.py",
                "tools/position_lookup.py", "oracle.py", "tools/analyze.py",
                "tools/import_tool.py", "tools/simple.py", "v2/engine.py",
                "v2/parser.py", "v2/cli.py", "parallel/shard_count.py",
                "parallel/multihost.py", "parallel/launch.py",
                "parallel/scaling.py", "parallel/dryrun.py"):
        assert os.path.join(PORT, rel) in {p for p, _ in files}, rel


def test_cuda_device_without_cuda_fails_clearly(reads, monkeypatch,
                                                capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, fq = reads
    for extra in ([], ["device=cuda"]):
        assert cli.main(["count", "k=21", fq, "output",
                         str(root / "x.meryl"), *extra]) == 1
        err = capsys.readouterr().err
        assert "torch.cuda.is_available() is false" in err
        assert "device=cpu" in err
    assert not os.path.exists(str(root / "x.meryl"))


@pytest.mark.parametrize("env", ["MERYL_TPU_SHARDED", "MERYL_TPU_COORD"])
def test_multi_device_words_count_like_one_device(reads, monkeypatch, env):
    """meryl_tpu's multi-device requests run in the port: MERYL_TPU_SHARDED=1
    counts on the sharded path in this process, and a MERYL_TPU_COORD job
    of 2 gloo ranks (the launcher's contract) counts its segments; both
    write the single-device DB."""
    root, fq = reads
    one = str(root / "one.meryl")
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    assert cli.main(["count", "k=21", fq, "output", one, "device=cpu"]) == 0
    out = str(root / f"{env}.meryl")
    if env == "MERYL_TPU_SHARDED":
        monkeypatch.setenv(env, "1")
        assert cli.main(["count", "k=21", fq, "output", out,
                         "device=cpu"]) == 0
        from meryl_tpu_torch.parallel import shard_count
        assert shard_count.LAST_SHARD_STATS["steps"] >= 1
    else:
        r = subprocess.run(
            [sys.executable, "-m", "meryl_tpu_torch.parallel.launch",
             "--nprocs", "2", "--", "count", "k=21", fq, "output", out,
             "device=cpu"], env=dict(os.environ, PYTHONPATH=ROOT),
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
    for a, b in zip(MerylDB.open(out).load_all(), MerylDB.open(one).load_all()):
        assert np.array_equal(a, b)


COUNT_WORD_CASES = [
    ["memory=0.00001"], ["memory=0.00001", "threads=2"], ["memory=64"],
    ["threads=3"], ["n=1000"], ["count-suffix=ACG"], ["count-suffix=T"],
    ["segment=1/2"], ["segment=2/3"], ["segment=1/2", "memory=0.00001"],
    ["count-suffix=GA", "memory=0.00001"], ["compress", "memory=0.00002"],
    ["n=5", "threads=1", "memory=0.00003", "segment=1/1"],
]


@pytest.mark.parametrize("op", ["count", "count-forward"])
@pytest.mark.parametrize("words", COUNT_WORD_CASES,
                         ids=lambda w: "_".join(w))
def test_count_words_match_reference(reads, tmp_path, monkeypatch, op,
                                     words):
    """memory= / threads= / n= / count-suffix= / segment= through both
    packages' cli.main: equal DBs.  MERYL_TPU_CHUNK keeps the chunks
    small so that a small memory= makes several batches."""
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    monkeypatch.setenv("MERYL_TPU_CHUNK", str(1 << 12))
    monkeypatch.delenv("MERYL_TPU_THREADS", raising=False)
    root, fq = reads
    from meryl_tpu_torch import counter
    counter.LAST_BATCH_STATS.clear()
    ref_db, db = str(tmp_path / "ref.meryl"), str(tmp_path / "port.meryl")
    assert ref_cli.main(["k=21", *words, op, fq, "output", ref_db]) == 0
    ref_threads = os.environ.get("MERYL_TPU_THREADS")
    monkeypatch.delenv("MERYL_TPU_THREADS", raising=False)
    assert cli.main(["k=21", *words, op, fq, "output", db,
                     "device=cpu"]) == 0
    assert os.environ.get("MERYL_TPU_THREADS") == ref_threads
    monkeypatch.delenv("MERYL_TPU_THREADS", raising=False)
    assert _db(db) == _db(ref_db) and _db(db)
    batched = any(w.startswith("memory=0.0000") for w in words) and \
        not any(w.startswith("count-suffix") for w in words)
    assert (counter.LAST_BATCH_STATS.get("batches", 0) >= 3) == batched
    assert not os.path.exists(db + ".manifest.json")


def test_count_suffix_on_a_node_inside_a_tree(reads, tmp_path, monkeypatch):
    """count-suffix= and segment= bind to the counting node they follow,
    not to the command."""
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    root, fq = reads
    outs = {}
    for name, main, extra in (("ref", ref_cli.main, []),
                              ("port", cli.main, ["device=cpu"])):
        db = str(tmp_path / f"{name}.meryl")
        assert main(["k=21", "union-sum", "[count", "count-suffix=AC", fq,
                     "]", "[count", "segment=1/2", fq, "]", "output", db,
                     *extra]) == 0
        outs[name] = _db(db)
    assert outs["port"] == outs["ref"] and outs["ref"]


def test_count_suffix_longer_than_k_fails_like_reference(reads, tmp_path,
                                                         capsys,
                                                         monkeypatch):
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    root, fq = reads
    words = ["k=5", "count", "count-suffix=ACGTAC", fq, "output",
             str(tmp_path / "x.meryl")]
    assert ref_cli.main(words) == 1
    ref_err = capsys.readouterr().err
    assert cli.main(words + ["device=cpu"]) == 1
    err = capsys.readouterr().err
    assert "count-suffix longer than k" in err
    assert err.replace("meryl-torch:", "meryl:") == ref_err


HOST_PLAN_KEYS = ("k", "expected_kmers", "host_bytes_per_kmer", "memory_gb",
                  "host_peak_bytes", "batches", "batch_bases")


def _plan_lines(err):
    return dict(ln.strip().split(": ", 1) for ln in err.splitlines()
                if ln.startswith("  ") and ": " in ln
                and not ln.startswith("  input"))


@pytest.mark.parametrize("words", [["-C", "memory=0.001"],
                                   ["memory=0.00001", "-C"],
                                   ["-C", "memory=64", "threads=2"]],
                         ids=lambda w: "_".join(w))
def test_configure_only_matches_reference(reads, tmp_path, capsys,
                                          monkeypatch, words):
    """-C: the tree and the plan on stderr, exit 0, nothing counted; the
    host keys equal the reference's, the device keys are the port's
    own, and both print a multi-device scaling table."""
    monkeypatch.delenv("MERYL_TPU_HBM_GB", raising=False)
    root, fq = reads
    out = str(tmp_path / "x.meryl")
    argv = ["k=21", *words, "count", fq, "output", out]
    assert ref_cli.main(argv) == 0
    ref_err = capsys.readouterr().err
    assert cli.main(argv + ["device=cpu"]) == 0
    got = capsys.readouterr()
    monkeypatch.delenv("MERYL_TPU_THREADS", raising=False)
    assert not os.path.exists(out) and got.out == ""
    # the action tree reads alike
    assert got.err.splitlines()[:2] == ref_err.splitlines()[:2]
    plan, ref_plan = _plan_lines(got.err), _plan_lines(ref_err)
    assert [k for k in ref_plan if not k[0].isdigit()][:13] == \
        [k for k in plan if not k[0].isdigit()]
    for key in HOST_PLAN_KEYS:
        assert plan[key] == ref_plan[key], key
    from meryl_tpu_torch import counter
    from meryl_tpu_torch.resources import physical_memory_bytes
    assert float(plan["hbm_gb"]) == physical_memory_bytes() / 1e9
    assert int(plan["device_bytes_per_base"]) == \
        counter.device_bytes_per_base(21)
    assert plan["devices"] == "1" and plan["sharded"] == "False"
    # both print the predicted scaling table over the same device counts
    # (the port's from its H100 stage costs and NVLink / InfiniBand)
    assert "predicted scaling" in ref_err and "predicted scaling (H100" \
        in got.err

    def rows(err):
        return [ln.split()[0] for ln in err.splitlines() if "devices (" in ln]
    assert rows(got.err) == rows(ref_err) == ["8", "64", "256"]


@pytest.mark.parametrize("tail", [["output"], ["print"],
                                  ["print", "output"], ["output", "print"],
                                  ["printACGT", "output"]],
                         ids=lambda t: "_".join(t))
def test_trailing_output_parses_like_reference(tmp_path, capsysbinary,
                                               monkeypatch, tail):
    """An argv that ends in `output` (no path) or `print` parses in the
    reference: the count goes to a temporary DB and exits 0."""
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    monkeypatch.chdir(tmp_path)  # `output print` writes a DB "print"
    fa = str(tmp_path / "r.fa")
    with open(fa, "w") as f:
        f.write(">s\nACGTTGCATGCCGATAGCTAGGATC\n>t\nACGTTGCATGNCGAT\n")
    argv = ["k=5", "count", fa, *tail]
    ref_b, b = ref_cli.build(argv), cli.build(argv + ["device=cpu"])
    assert [(r.op, r.output_path, r.print_path, r.print_acgt)
            for r in b.roots] == \
        [(r.op, r.output_path, r.print_path, r.print_acgt)
         for r in ref_b.roots]
    assert ref_cli.main(argv) == 0
    want = capsysbinary.readouterr().out
    assert cli.main(argv + ["device=cpu"]) == 0
    assert capsysbinary.readouterr().out == want
    # `output print` names the DB "print": nothing is printed
    assert bool(want) == any(r.print_path for r in ref_b.roots)


# ------------------------------------------------------------- set ops

@pytest.fixture(scope="module")
def two_dbs(reads, tmp_path_factory):
    """a: the module's reads; b: reads of the same genome region with
    substitutions, so the two DBs share most k-mers but not all."""
    root, fq = reads
    rng = np.random.default_rng(12)
    fq2 = str(root / "reads2.fq")
    with open(fq) as f:
        lines = f.read().split("\n")
    with open(fq2, "w") as f:
        for i in range(0, len(lines) - 1, 4):
            seq = list(lines[i + 1])
            for j in rng.integers(0, len(seq), size=2):
                seq[j] = "ACGT"[(("ACGT".find(seq[j]) + 1) % 4)]
            if i % 12 == 0:
                f.write(f"{lines[i]}\n{''.join(seq)}\n+\n{lines[i + 3]}\n")
            f.write(f"{lines[i]}\n{''.join(seq)}\n+\n{lines[i + 3]}\n")
    a, b = str(root / "a.meryl"), str(root / "b.meryl")
    assert ref_cli.main(["k=21", "count", fq, "output", a]) == 0
    assert ref_cli.main(["k=21", "count", fq2, "output", b]) == 0
    return a, b


SETOP_CMDS = [
    ["union-sum", "A", "B"],
    ["union", "A", "B", "A"],
    ["intersect-min", "A", "B"],
    ["intersect-sum", "A", "B"],
    ["difference", "A", "B"],
    ["symmetric-difference", "A", "B"],
    ["subtract", "A", "B"],
    ["greater-than", "1", "A"],
    ["at-least", "t=2", "B"],
    ["intersect", "[greater-than", "1", "A]", "[difference", "A", "B]"],
    ["union-max", "[divide-round", "3", "A]", "[multiply", "4294967295",
     "B]"],
    ["modulo", "3", "[increase", "4294967294", "A]"],
    ["equal-to", "2", "B", "printACGT"],
    ["at-least", "d=0.9", "A"],
    ["less-than", "f=0.0002", "B"],
]


def _sub(cmd, a, b):
    return [{"A": a, "B": b}.get(w, w.replace("A]", a + "]")
                                   .replace("B]", b + "]")) for w in cmd]


@pytest.mark.parametrize("cmd", SETOP_CMDS, ids=lambda c: "_".join(c[:2]))
def test_setop_commands_match_reference(two_dbs, tmp_path, capsysbinary,
                                        cmd):
    a, b = two_dbs
    words = _sub(cmd, a, b)
    outs = {}
    for name, main, extra in (("ref", ref_cli.main, []),
                              ("port", cli.main, ["device=cpu"])):
        db = str(tmp_path / f"{name}.meryl")
        printer = [] if "printACGT" in cmd else ["print"]
        assert main(words + ["output", db] + printer + extra) == 0
        outs[name] = (capsysbinary.readouterr().out, _db(db))
    assert outs["port"] == outs["ref"]
    assert outs["ref"][0] and outs["ref"][1]


@pytest.mark.parametrize("cmd", [["histogram", "A"], ["statistics", "B"],
                                 ["ploidy", "A"], ["noise", "B"],
                                 ["print", "A"], ["compare", "A", "B"],
                                 ["compare", "A", "A"],
                                 ["print", "[less-than", "3", "B]"]],
                         ids=lambda c: "_".join(c[:2]))
def test_report_commands_match_reference(two_dbs, capsysbinary, cmd):
    a, b = two_dbs
    words = _sub(cmd, a, b)
    assert ref_cli.main(words) == 0
    want = capsysbinary.readouterr().out
    assert cli.main(words + ["device=cpu"]) == 0
    assert capsysbinary.readouterr().out == want
    assert want or cmd == ["compare", "A", "A"]


def test_count_inside_a_tree_matches_reference(reads, tmp_path,
                                               capsysbinary, monkeypatch):
    """A counting node materialized inside a set-op tree."""
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    root, fq = reads
    a = str(root / "tree_a.meryl")
    assert ref_cli.main(["k=21", "count", fq, "output", a]) == 0
    for name, main, extra in (("ref", ref_cli.main, []),
                              ("port", cli.main, ["device=cpu"])):
        db = str(tmp_path / f"{name}.meryl")
        assert main(["k=21", "intersect-max", a, "[count", fq, "]",
                     "output", db, *extra]) == 0
    assert _db(str(tmp_path / "port.meryl")) == \
        _db(str(tmp_path / "ref.meryl"))


def test_dump_commands_match_reference(two_dbs, capsysbinary):
    a, _ = two_dbs
    for words in (["dumpIndex", a],
                  ["dumpFile", os.path.join(a, bucket_name(5))]):
        assert ref_cli.main(words) == 0
        want = capsysbinary.readouterr().out
        assert cli.main(words) == 0
        assert capsysbinary.readouterr().out == want and want


_MERQURY_NO_JAX = r"""
import contextlib, io, random, sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["meryl_tpu"] = None    # nor of the reference package
from meryl_tpu_torch.cli import main
K = 15
root = sys.argv[1]
rng = random.Random(5)
genome = "".join(rng.choices("ACGT", k=4000))
reads = []
for off in (0, 67, 134):
    p = off
    while p + 200 <= len(genome):
        reads.append(genome[p:p + 200])
        p += 200 - (K - 1)
    reads.append(genome[-200:])
pos = 2000
wrong = {"A": "C", "C": "G", "G": "T", "T": "A"}[genome[pos]]
assembly = genome[:pos] + wrong + genome[pos + 1:]
open(f"{root}/reads.fa", "w").write(
    "".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
open(f"{root}/asm.fa", "w").write(f">asm\n{assembly}\n")
rdb, adb = f"{root}/reads.meryl", f"{root}/asm.meryl"
dev = "device=cpu"
assert main([f"k={K}", "count", f"{root}/reads.fa", "output", rdb, dev]) == 0
assert main([f"k={K}", "count", f"{root}/asm.fa", "output", adb, dev]) == 0

def canon(s):
    rc = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
    o = {"A": 0, "C": 1, "T": 2, "G": 3}
    return s if [o[c] for c in s] <= [o[c] for c in rc] else rc

def kmers(s):
    return {canon(s[i:i + K]) for i in range(len(s) - K + 1)}

def printed(db):
    buf = io.BytesIO()
    out = io.TextIOWrapper(buf)
    with contextlib.redirect_stdout(out):
        assert main(["print", db, dev]) == 0
        out.flush()
    return {l.split("\t")[0] for l in buf.getvalue().decode().splitlines()}

solid, errs, found = (f"{root}/{n}.meryl" for n in ("solid", "errs", "found"))
assert main(["at-least", "2", rdb, "output", solid, dev]) == 0
cnt = {}
for r in reads:
    for i in range(len(r) - K + 1):
        cnt[canon(r[i:i + K])] = cnt.get(canon(r[i:i + K]), 0) + 1
assert printed(solid) == {k for k, v in cnt.items() if v >= 2}
assert main(["difference", adb, rdb, "output", errs, dev]) == 0
rk = set()
for r in reads:
    rk |= kmers(r)
got_err = printed(errs)
assert got_err == kmers(assembly) - rk and 1 <= len(got_err) <= K
assert main(["intersect", solid, adb, "output", found, dev]) == 0
completeness = len(printed(found)) / len(printed(solid))
assert 0.97 < completeness < 1.0, completeness
assert not any(m.split(".")[0] in ("jax", "meryl_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("OK", len(got_err), completeness)
"""


def test_merqury_workflow_with_jax_blocked(tmp_path):
    """tests/test_workflow_merqury.py's counting and set-op steps
    through the port's CLI, in a process where jax cannot be imported."""
    r = subprocess.run([sys.executable, "-c", _MERQURY_NO_JAX,
                        str(tmp_path)], capture_output=True, text=True,
                       timeout=300, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")


_CUT_LOOSE = r"""
import contextlib, gzip, io, os, random, struct, sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["meryl_tpu"] = None    # nor of the reference package
from meryl_tpu_torch.cli import main
from meryl_tpu_torch.db import MerylDB
K = 17
root = sys.argv[1]
rng = random.Random(21)

def reads(n):
    out = []
    for i in range(n):
        s = "".join(rng.choices("ACGT", k=rng.randint(30, 160)))
        if i % 6 == 0:
            p = rng.randrange(len(s))
            s = s[:p] + "N" + s[p + 1:]
        if i % 9 == 0:
            s += "G" * 25
        out.append(s)
    return out

seqs_fq, seqs_bam = reads(60), reads(50)
fq = f"{root}/reads.fq.gz"
with gzip.open(fq, "wt") as f:
    for i, s in enumerate(seqs_fq):
        f.write(f"@q{i}\n{s}\n+\n{'I' * len(s)}\n")
# a BAM of unmapped reads, written by hand (BGZF-free gzip, 4-bit bases)
SEQ16 = "=ACMGRSVTWYHKDBN"
bam = bytearray(b"BAM\x01")
text = b"@HD\tVN:1.6\n"
bam += struct.pack("<i", len(text)) + text + struct.pack("<i", 0)
for i, s in enumerate(seqs_bam):
    name = f"b{i}".encode() + b"\x00"
    packed = bytearray((len(s) + 1) // 2)
    for j, ch in enumerate(s):
        packed[j // 2] |= SEQ16.index(ch) << (4 if j % 2 == 0 else 0)
    rec = struct.pack("<iiBBHHHiiii", -1, -1, len(name), 0, 4680, 0, 4,
                      len(s), -1, -1, 0) + name + bytes(packed) \
        + b"\xff" * len(s)
    bam += struct.pack("<i", len(rec)) + rec
bam_path = f"{root}/reads.bam"
with gzip.open(bam_path, "wb") as f:
    f.write(bytes(bam))

CODE = {"A": 0, "C": 1, "T": 2, "G": 3}
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}

def brute(seqs):
    out = {}
    for s in seqs:
        for i in range(len(s) - K + 1):
            w = s[i:i + K]
            if "N" in w:
                continue
            rc = "".join(COMP[c] for c in reversed(w))
            f = r = 0
            for a, b in zip(w, rc):
                f, r = f * 4 + CODE[a], r * 4 + CODE[b]
            key = min(f, r)
            out[key] = out.get(key, 0) + 1
    return out

def load(db):
    hi, lo, c = MerylDB.open(db).load_all()
    return {(int(h) << 64) | int(l): int(v) for h, l, v in zip(hi, lo, c)}

def run(words):
    buf = io.BytesIO()
    out = io.TextIOWrapper(buf)
    with contextlib.redirect_stdout(out):
        assert main(words + ["device=cpu"]) == 0, words
        out.flush()
    return buf.getvalue().decode()

want_a, want_b = brute(seqs_fq), brute(seqs_bam)
for acc in ("1", "0"):             # device accumulator, host sort path
    os.environ["MERYL_TPU_DEVICE_ACC"] = acc
    for name, path, want in (("a", fq, want_a), ("b", bam_path, want_b)):
        db = f"{root}/{name}{acc}.meryl"
        run(["count", f"k={K}", path, "output", db])
        assert load(db) == want, (name, acc)
a, b, u = f"{root}/a1.meryl", f"{root}/b0.meryl", f"{root}/u.meryl"
run(["union-sum", a, b, "output", u])
want_u = {x: want_a.get(x, 0) + want_b.get(x, 0)
          for x in set(want_a) | set(want_b)}
assert load(u) == want_u
printed = {}
for line in run(["print", a]).splitlines():
    mer, cnt = line.split("\t")
    printed[sum(CODE[c] << (2 * (K - 1 - i)) for i, c in enumerate(mer))] \
        = int(cnt)
assert printed == want_a
occ = {}
for v in want_u.values():
    occ[v] = occ.get(v, 0) + 1
assert run(["histogram", u]) == "".join(f"{v}\t{occ[v]}\n" for v in sorted(occ))
assert not any(m.split(".")[0] in ("jax", "meryl_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("OK", len(want_a), len(want_b), len(want_u))
"""


def test_port_runs_with_meryl_tpu_and_jax_blocked(tmp_path):
    """count (device accumulator and host path) on a gzip FASTQ and a
    BAM, a set operation, print and histogram, in a process where
    neither meryl_tpu nor jax can be imported; every output against an
    inline brute force."""
    r = subprocess.run([sys.executable, "-c", _CUT_LOOSE, str(tmp_path)],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")


_LOOKUP_NO_JAX = r"""
import contextlib, io, os, random, sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["meryl_tpu"] = None    # nor of the reference package
from meryl_tpu_torch.cli import main as meryl
from meryl_tpu_torch.lookup_cli import main as lookup
from meryl_tpu_torch.tools.position_lookup import main as position_lookup
from meryl_tpu_torch.tools import import_tool, simple
K = 15
root = sys.argv[1]
rng = random.Random(5)
g = "".join(rng.choices("ACGT", k=5000))
q = g[1000:1400] + "N" + "".join(rng.choices("ACGT", k=400))
with open(f"{root}/g.fa", "w") as f:
    f.write(f">g\n{g}\n")
with open(f"{root}/q.fa", "w") as f:
    f.write(f">q\n{q}\n")
assert meryl(["count", f"k={K}", f"{root}/g.fa", "output", f"{root}/g.meryl",
              "device=cpu"]) == 0
CODE = {"A": 0, "C": 1, "T": 2, "G": 3}
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}

def canon(w):
    rc = "".join(COMP[c] for c in reversed(w))
    f = r = 0
    for a, b in zip(w, rc):
        f, r = f * 4 + CODE[a], r * 4 + CODE[b]
    return min(f, r)

have = {canon(g[i:i + K]) for i in range(len(g) - K + 1)}
found = [i for i in range(len(q) - K + 1)
         if "N" not in q[i:i + K] and canon(q[i:i + K]) in have]
out = f"{root}/q.bed"
assert lookup(["-bed", "-sequence", f"{root}/q.fa", "-mers",
               f"{root}/g.meryl", "-output", out, "-device", "cpu"]) == 0
assert open(out).read() == "".join(f"q\t{i}\t{i + K}\n" for i in found)
assert position_lookup(["-m", f"{root}/g.meryl", "-s", f"{root}/g.fa",
                        "-hpq", f"{root}/q.hpq", "-device", "cpu",
                        f"{root}/q.fa"]) == 0
assert open(f"{root}/q.hpq").read() == f"{len(found)}\t{len(found)}\t{len(q)}\tq\n"
with open(f"{root}/k.txt", "w") as f:
    f.write("ACGTACGTACGTACG 3\n")
assert import_tool.main(["-k", str(K), "-kmers", f"{root}/k.txt", "-output",
                         f"{root}/k.meryl"]) == 0
assert simple.main(["-k", str(K), "-S", f"{root}/q.fa", "-D",
                    f"{root}/q.dump"]) == 0
assert not any(m.split(".")[0] in ("jax", "meryl_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("OK", len(found))
"""


def test_lookup_tools_run_with_meryl_tpu_and_jax_blocked(tmp_path):
    """meryl-lookup -bed, position-lookup -hpq, import and simple in a
    process where neither meryl_tpu nor jax can be imported; the lookup
    outputs against an inline brute force."""
    r = subprocess.run([sys.executable, "-c", _LOOKUP_NO_JAX, str(tmp_path)],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")


_MERYL2_NO_JAX = r"""
import contextlib, io, random, sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["meryl_tpu"] = None    # nor of the reference package
from meryl_tpu_torch.v2.cli import main
K = 13
root = sys.argv[1]
rng = random.Random(8)
g = "".join(rng.choices("ACGT", k=3000))
seqs = {"a": g[:2000], "b": g[1000:]}
for n, s in seqs.items():
    open(f"{root}/{n}.fa", "w").write(f">{n}\n{s}\n")
    assert main(["-k", str(K), "count", f"label=#{1 if n == 'a' else 2}",
                 f"{root}/{n}.fa", f"output:database={root}/{n}.meryl",
                 "device=cpu"]) == 0
buf = io.BytesIO()
out = io.TextIOWrapper(buf)
with contextlib.redirect_stdout(out):
    assert main(["union-sum", "o:show", f"{root}/a.meryl", f"{root}/b.meryl",
                 "device=cpu"]) == 0
    out.flush()
CODE = {"A": 0, "C": 1, "T": 2, "G": 3}
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
want = {}
for n, s in seqs.items():
    for i in range(len(s) - K + 1):
        w = s[i:i + K]
        rc = "".join(COMP[c] for c in reversed(w))
        key = min(w, rc, key=lambda x: [CODE[c] for c in x])
        v, lab = want.get(key, (0, 0))
        want[key] = (v + 1, lab | (1 if n == "a" else 2))
got = {}
for line in buf.getvalue().decode().splitlines():
    mer, v, lab = line.split("\t")
    got[mer] = (int(v), int(lab))
assert got == want, (len(got), len(want))
assert 3 in {lab for _, lab in got.values()}
assert not any(m.split(".")[0] in ("jax", "meryl_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("OK", len(got))
"""


def test_meryl2_runs_with_meryl_tpu_and_jax_blocked(tmp_path):
    """meryl2-torch: a labelled count of two sequences and their
    union-sum o:show, in a process where neither meryl_tpu nor jax can
    be imported; the printed (k-mer, value, label) lines against an
    inline brute force."""
    r = subprocess.run([sys.executable, "-c", _MERYL2_NO_JAX, str(tmp_path)],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")
