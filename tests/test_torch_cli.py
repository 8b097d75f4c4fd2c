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
from meryl_tpu.db import MerylDB
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
import numpy as np
from meryl_tpu_torch.cli import main
from meryl_tpu.db import MerylDB
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
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
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


# meryl_tpu modules that import jax at module level
_JAX_BOUND = ("meryl_tpu.counter", "meryl_tpu.ops", "meryl_tpu.cli",
              "meryl_tpu.optree", "meryl_tpu.lookup", "meryl_tpu.parallel",
              "meryl_tpu.v2", "meryl_tpu.tools")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"


def test_port_imports_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "bin", "meryl-torch")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 8
    for path in files:
        for mod in _imports(path):
            assert not (mod == "jax" or mod.startswith("jax.")), (path, mod)
            assert not any(mod == b or mod.startswith(b + ".")
                           for b in _JAX_BOUND), (path, mod)


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


@pytest.mark.parametrize("word,item", [("memory=4", "A11"),
                                       ("count-suffix=ACG", "A13"),
                                       ("print", "A7"),
                                       ("union-sum", "A7")])
def test_unported_words_name_roadmap_item(reads, capsys, word, item):
    root, fq = reads
    assert cli.main(["count", "k=21", fq, word, "output",
                     str(root / "y.meryl"), "device=cpu"]) == 1
    err = capsys.readouterr().err
    assert "not yet ported in meryl_tpu_torch" in err and item in err
