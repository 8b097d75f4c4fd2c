"""Finding a cell's parts by name.

`BENCHMARK.json` names each part, and each part is a file of its own:
  configs     the file its `file` key gives (a deployment's sizes)
  traffic     traffic/<traffic>.json (the jobs of a mix; data only)
  per-layer   layer_metrics/<metric>.py (a reader: `read(run)`)
So a later change adds a cell, a configuration, a mix or a metric by
adding files and entries, and edits nothing that is here.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class NotFound(LookupError):
    pass


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise NotFound(f"no workload {name!r} in BENCHMARK.json")
    cfg = next((c for c in bench["configs"] if c["name"] == w["config"]),
               None)
    if cfg is None:
        raise NotFound(f"no config {w['config']!r} in BENCHMARK.json")
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    traffic_path = os.path.join(root, "benchmark", "traffic",
                                w["traffic"] + ".json")
    if not os.path.isfile(traffic_path):
        raise NotFound(f"no traffic file {traffic_path}")
    with open(traffic_path) as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def metric_reader(name: str, root: str = ROOT):
    """The module of layer_metrics/<name>.py: `read(run)` gives the
    metric or None, `PROBES` the program counters it reads."""
    path = os.path.join(root, "benchmark", "layer_metrics", name + ".py")
    if not os.path.isfile(path):
        raise NotFound(f"no reader {path} for per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        "layer_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
