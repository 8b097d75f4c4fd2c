"""What the benchmark may import: nothing under benchmark/ reaches JAX
or the JAX package, and the reference reaches nothing of the program.
Names are compared by their top-level part, whole: meryl_tpu_torch is
not meryl_tpu."""

import ast
import os
import sys

import pytest

from conftest import BENCH_DIR
from harness import runner

BANNED = {"jax", "jaxlib", "flax", "meryl_tpu"}


def imported(path):
    """Top-level names of every absolute import in a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def sources(sub=""):
    top = os.path.join(BENCH_DIR, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax(path):
    assert not set(imported(path)) & BANNED


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_reference_is_independent(path):
    names = set(imported(path))
    assert not names & (BANNED | {"meryl_tpu_torch", "harness"})


def test_entries_are_the_port():
    for mod, _, _ in runner.ENTRIES.values():
        assert mod.split(".")[0] == "meryl_tpu_torch"


def test_banned_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "meryl_tpu_torch_fake", object())
    assert runner.banned_modules() == []
    monkeypatch.setitem(sys.modules, "meryl_tpu.fake", object())
    assert runner.banned_modules() == ["meryl_tpu.fake"]
