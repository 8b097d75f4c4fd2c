"""A cell, a configuration, a traffic mix and a per-layer metric added
as new files (and BENCHMARK.json entries) in a copy are found by name
and run, with no file that is there edited."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, ROOT
from harness import registry


@pytest.fixture
def copy(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_every_part_is_found(bench):
    for w in bench["workloads"]:
        cell = registry.find_cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert "job" in cell.traffic and "metric" in cell.traffic
        assert cell.traffic["metric"]["name"] in \
            [m["name"] for m in cell.end_to_end]
        assert {"setup_s", "peak_device_mib"} <= \
            {m["name"] for m in cell.end_to_end}
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(registry.metric_reader(m["name"]).read)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_added_files_are_found_and_run(copy):
    b = json.loads((copy / "BENCHMARK.json").read_text())
    cfg = json.loads((copy / "benchmark/configs/ecoli-k12-illumina-k21.json")
                     .read_text())
    cfg.update(name="new-config", k=17)
    (copy / "benchmark/configs/new-config.json").write_text(json.dumps(cfg))
    mix = json.loads((copy / "benchmark/traffic/count.json").read_text())
    mix["job"][0]["argv"] = ["count", "k={k}", "threads=2", "{reads.fq}",
                             "output", "{out}/r.meryl"]
    (copy / "benchmark/traffic/new-mix.json").write_text(json.dumps(mix))
    (copy / "benchmark/layer_metrics/new.jobs.py").write_text(
        "PROBES = []\n\ndef read(run):\n    return float(len(run.commands))\n")
    b["configs"].append({"name": "new-config", "source": "x",
                         "file": "benchmark/configs/new-config.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "new-config.new-mix",
                           "config": "new-config", "traffic": "new-mix",
                           "chips": 1, "why": "x"})
    b["end_to_end"][0]["workloads"].append("new-config.new-mix")
    b["per_layer"].append({"name": "new.jobs", "unit": "jobs",
                           "better": "higher", "source": "program_counter",
                           "layer": "x", "moves": "count_mbases_s",
                           "workloads": ["new-config.new-mix"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(b))

    cell = registry.find_cell(registry.load_benchmark(str(copy)),
                              "new-config.new-mix", str(copy))
    assert cell.config["k"] == 17 and cell.traffic == mix
    assert [m["name"] for m in cell.per_layer] == ["new.jobs"]
    mod = registry.metric_reader("new.jobs", str(copy))
    assert mod.read(type("R", (), {"commands": [1, 2]})) == 2.0

    # the copy's own harness runs it (its registry reads the copy)
    code = (
        "import io, json, sys; sys.path[:0] = [{b!r}, {r!r}]\n"
        "import run; from harness import registry\n"
        "c = registry.find_cell(registry.load_benchmark(), "
        "'new-config.new-mix')\n"
        "c.config['genome']['length_bp'] = 20000\n"
        "res = run.run_cell(c, 5, 0.5, True, 'cpu', {w!r}, io.StringIO())\n"
        "print(json.dumps(res))\n").format(
            b=str(copy / "benchmark"), r=ROOT, w=str(copy / "w"))
    os.mkdir(copy / "w")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(copy))
    assert r.returncode == 0, r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["new.jobs"]["value"] >= 1
