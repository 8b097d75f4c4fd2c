"""Whole runs of the harness on the CPU at a small genome: the result
line, the check's numbers, and that the check catches a broken timed
path and the control.  (On the CPU, run_cell skips only the look for a
card: the program runs with device=cpu.)"""

import gzip
import importlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH_DIR, ROOT, tiny
from harness import registry, runner
from reference import dbfile

import control
import run as bench_run

CELLS = ["ecoli-k12-illumina-k21.count", "scer-s288c-hifi-k21.count",
         "ecoli-k12-illumina-k21.merqury", "ecoli-k12-illumina-k21.lookup",
         "ecoli-k12-illumina-k21.count-gz"]
SEED = 2 ** 31 + 99


def cell_of(bench, name):
    return tiny(registry.find_cell(bench, name))


def run_one(cell, tmp_path, trace=False, seconds=1.0):
    log = io.StringIO()
    res = bench_run.run_cell(cell, SEED, seconds, trace, "cpu",
                             str(tmp_path), log)
    return res, log.getvalue()


@pytest.mark.parametrize("name", CELLS)
def test_sound_run(bench, name, tmp_path):
    cell = cell_of(bench, name)
    res, log = run_one(cell, tmp_path)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert res["correct"] is True, log
    assert res["failed"] == 0 and res["attempted"] >= len(
        cell.traffic["job"])
    metric = cell.traffic["metric"]["name"]
    assert set(res["metrics"]) == {metric, "setup_s"}
    assert res["metrics"][metric]["value"] > 0
    assert list(res["check"]) == ["mismatch_first_job", "mismatch_last_job"]
    # the numbers compared are the last lines of standard error
    tail = log.splitlines()[-2:]
    assert [ln.split()[0] for ln in tail] == list(res["check"])
    assert all(ln.endswith("limit 0") for ln in tail)
    json.dumps(res)


@pytest.mark.parametrize("name", [CELLS[0], CELLS[2], CELLS[4]])
def test_traced_run(bench, name, tmp_path, monkeypatch):
    # the device-accumulator path, which the card takes, on the CPU
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", "1")
    cell = cell_of(bench, name)
    res, log = run_one(cell, tmp_path, trace=True)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "check"]
    assert res["correct"] is True, log
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0
    # no device here: the device's metrics find nothing to read; the
    # program's spans still do
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer
                                   if m["source"] == "program_span"}
    assert all(0 < m["value"] < 100 for m in res["metrics"].values())


# ------------------------------------------------------ the timed path broken

def _half_fastq(src, dst):
    opener = gzip.open if src.endswith(".gz") else open
    with opener(src, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    with opener(dst, "wb") as f:
        f.writelines(lines[:len(lines) // 8 * 4])


def _half_db(src, dst, k):
    got = dbfile.read(src, k)
    keep = np.arange(got.keys.size) % 2 == 0
    dbfile.write(dst, k, got.keys[keep], got.counts[keep])


def _alter(argv, k):
    """Change one answer where the command produced it."""
    if "output" in argv:
        path = argv[argv.index("output") + 1]
        got = dbfile.read(path, k)
        if got.keys.size:
            c = got.counts.copy()
            c[c.size // 2] += 1
            shutil.rmtree(path)
            dbfile.write(path, k, got.keys, c)
    elif "-output" in argv:
        path = argv[argv.index("-output") + 1]
        with open(path) as f:
            lines = f.read().splitlines()
        parts = lines[0].split("\t")
        parts[-1] = str(int(parts[-1]) + 1)
        lines[0] = "\t".join(parts)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


def broken(fault, real_main, tmp, k, untouched):
    """A command of the program with `fault` planted underneath, after
    the first `untouched` calls (the set-up and the warm job)."""
    calls = [0]

    def main(argv):
        argv = list(argv)
        calls[0] += 1
        if calls[0] <= untouched:
            return real_main(argv)
        if fault == "unchanged":          # returns without doing the work
            return 0
        if fault == "half":               # half of the input left out
            for i, w in enumerate(argv):
                half = os.path.join(tmp, f"half{i}-" + os.path.basename(w))
                if w.endswith((".fq", ".fq.gz")) and \
                        not os.path.exists(half):
                    _half_fastq(w, half)
                elif w.endswith(".meryl") and os.path.isdir(w) and \
                        "/slot-" not in w and not os.path.exists(half):
                    _half_db(w, half, k)
                if os.path.exists(half):
                    argv[i] = half
            return real_main(argv)
        rc = real_main(argv)              # "alter": one answer changed
        _alter(argv, k)
        return rc
    return main


@pytest.mark.parametrize("fault", ["unchanged", "half", "alter"])
@pytest.mark.parametrize("name", [CELLS[0], CELLS[2], CELLS[3], CELLS[4]])
def test_broken_path_is_not_correct(bench, name, fault, tmp_path,
                                    monkeypatch):
    cell = cell_of(bench, name)
    work = tmp_path / "w"
    work.mkdir()
    steps = cell.traffic.get("setup", []) + cell.traffic["job"]
    for command, (mod, fn, _) in runner.ENTRIES.items():
        module = importlib.import_module(mod)
        untouched = sum(s["command"] == command for s in steps)
        monkeypatch.setattr(module, fn, broken(
            fault, getattr(module, fn), str(tmp_path), cell.config["k"],
            untouched))
    res, log = run_one(cell, work)
    assert res["correct"] is False, log
    assert res["check"]["mismatch_last_job"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(bench, name, tmp_path):
    cell = cell_of(bench, name)
    out = control.control_run(cell, SEED, "cpu", str(tmp_path))
    assert out["mismatch"]["first"] > 0 and out["mismatch"]["last"] > 0


# ---------------------------------------------------------------- refusals

def _bench_copy(dst):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(BENCH_DIR, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))


def test_no_card_no_result(tmp_path):
    """Without CUDA the command exits nonzero and prints nothing."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _bench_copy(str(tmp_path))
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_benchmark_alone_no_result(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ only (no program):
    a run that got past the look for a card still prints no result."""
    _bench_copy(str(tmp_path))
    code = ("import sys, io, json; sys.path.insert(0, 'benchmark');"
            "import run; from harness import registry;"
            "sys.path.remove(run.ROOT) if run.ROOT in sys.path else None;"
            "run._environment();"
            "c = registry.find_cell(registry.load_benchmark(run.ROOT), "
            f"'{CELLS[0]}', run.ROOT);"
            "c.config['genome']['length_bp'] = 3000;"
            "res = run.run_cell(c, 1, 0.5, False, 'cpu', 'w');"
            "print(json.dumps(res)) if res else sys.exit(4)")
    os.mkdir(tmp_path / "w")
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode != 0 and r.stdout == "", (r.stdout, r.stderr)
    assert "meryl_tpu_torch" in r.stderr
