"""The benchmark's CPU tests: `python -m pytest benchmark/tests -q`
(cards: `-m cuda`, on a machine with one)."""

import json
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)

# a size the CPU runs in seconds: the same shapes, a small genome
TINY_GENOME = 30000


def tiny(cell):
    """The cell at a small genome (read lengths cut to fit it)."""
    cell.config["genome"]["length_bp"] = TINY_GENOME
    spec = cell.config["reads"]["length"]
    if "fixed" not in spec:
        spec.update(lognormal_mean=3000, min=1000, max=6000)
    return cell


@pytest.fixture
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)

