"""meryl_tpu_torch.trace: a command's host spans (self seconds and
counts in LAST_SPANS), their reset at each entry point, the reader
thread's fold, the spans' host events under torch.profiler,
LAST_WIRE_STATS computed from the spans, and the benchmark's
per-layer readers of them (benchmark/layer_metrics/*.py)."""

import contextlib
import importlib.util
import json
import os
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from meryl_tpu_torch import cli, counter, lookup_cli, trace
from meryl_tpu_torch.v2 import cli as v2_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")


def _span_metrics():
    """The per-layer metrics whose readers read the program's spans."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        names = [m["name"] for m in json.load(f)["per_layer"]]
    out = []
    for name in names:
        with open(os.path.join(BENCH, "layer_metrics", name + ".py")) as f:
            if "spans.span_share" in f.read():
                out.append(name)
    return out


SPAN_METRICS = _span_metrics()
# the first word of the commands each group of them reads
ARGV0 = {"count": "count", "setop": None, "lookup": "-existence"}


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", "1")
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    trace.reset()
    yield
    trace.reset()


def _clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(trace, "perf_counter", lambda: next(it))


def _run(tree):
    """tree: (name, [children]) -> enter, children in order, exit."""
    name, children = tree
    with trace.span(name):
        for c in children:
            _run(c)


# ------------------------------------------------------------ the spans

@pytest.mark.parametrize("tree,ticks,want", [
    (("a", []), [0, 5], {"a": 5}),
    (("a", [("b", [])]), [0, 1, 4, 10], {"a": 7, "b": 3}),
    (("a", [("c", []), ("c", [])]), [0, 1, 2, 3, 6, 10], {"a": 6, "c": 4}),
    (("a", [("b", [("c", [])])]), [0, 1, 2, 3, 5, 9],
     {"a": 5, "b": 3, "c": 1}),
])
def test_self_seconds(monkeypatch, tree, ticks, want):
    _clock(monkeypatch, ticks)
    _run(tree)
    assert {k[:-2]: v for k, v in trace.LAST_SPANS.items()
            if k.endswith("_s")} == want


@pytest.mark.parametrize("n,raises", [(1, False), (3, False), (4, True)])
def test_counts(n, raises):
    for i in range(n):
        with contextlib.suppress(KeyError):
            with trace.span("x") as sp:
                if raises and i % 2:
                    raise KeyError(i)
        assert sp.seconds >= 0
    assert trace.LAST_SPANS["x_n"] == n
    assert trace.LAST_SPANS["x_s"] >= 0
    assert trace._local.top is None


@pytest.mark.parametrize("main,argv", [
    (cli.main, ["help"]), (lookup_cli.main, []), (v2_cli.main, ["help"])])
def test_reset_at_each_entry_point(capsys, main, argv):
    trace.LAST_SPANS["stale_s"] = 1.0
    main(argv)
    assert "stale_s" not in trace.LAST_SPANS


@pytest.mark.parametrize("threads", [1, 4 * (os.cpu_count() or 1)])
def test_thread_spans_fold_at_the_end(threads):
    """Worker threads' spans reach LAST_SPANS only when each block ends,
    and no fold is lost when many end at once."""
    inside, spans_each = [], 50

    def work():
        with trace.thread_spans():
            for _ in range(spans_each):
                with trace.span("w"):
                    pass
            inside.append(trace.LAST_SPANS.get("w_n", 0))
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in ts)
    assert len(inside) == threads
    assert all(n <= spans_each * (threads - 1) for n in inside)
    assert trace.LAST_SPANS["w_n"] == spans_each * threads
    assert trace._local.sink is trace.LAST_SPANS


@pytest.mark.parametrize("profiled", [False, True])
def test_host_event_only_under_the_profiler(monkeypatch, profiled):
    def refuse(name):
        raise AssertionError(f"host event {name} without a profiler")
    monkeypatch.setattr(trace, "_HostEvent", refuse)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with (prof if profiled else contextlib.nullcontext()):
        if profiled:
            with pytest.raises(AssertionError):
                with trace.span("p"):
                    pass
        else:
            with trace.span("p"):
                pass
            assert trace.LAST_SPANS["p_n"] == 1


# ------------------------------------------------------------ the count

def _write_reads(path, rng, n, ln=150):
    g = "".join("ACGT"[c] for c in rng.integers(0, 4, 4000))
    with open(path, "w") as f:
        for i in range(n):
            s = int(rng.integers(0, len(g) - ln))
            f.write(f"@r{i}\n{g[s:s + ln]}\n+\n{'I' * ln}\n")
    return g


@pytest.fixture
def reads(tmp_path):
    p = str(tmp_path / "r.fq")
    _write_reads(p, np.random.default_rng(7), 400)
    return p


WIRE_KEYS = ["h2d_bytes", "d2h_bytes", "bases", "scan_stall_s",
             "reader_busy_s", "t_finalize_s", "n_h2d", "n_dispatch",
             "n_fetch", "t_h2d_s", "t_dispatch_s", "t_fetch_s",
             "host_pack_s", "host_finalize_s", "t_download_s", "chunks",
             "merges", "regrows", "recounts", "captured", "salvaged",
             "native_packs"]


@pytest.mark.parametrize("hatch", ["none", "recount", "salvage"])
def test_wire_stats_from_the_spans(tmp_path, monkeypatch, reads, hatch):
    paths, k, chunk, exp = [reads], 21, 1 << 13, 60000
    if hatch == "recount":
        fa = str(tmp_path / "a.fa")
        with open(fa, "w") as f:
            f.write(">a\n" + "A" * 5000 + "\n")
        paths, k = [fa, reads], 16
    elif hatch == "salvage":                 # distinct k-mers past 2 KB
        monkeypatch.setenv("MERYL_TPU_ACC_CAP_GB", "0.000002")
        rng = np.random.default_rng(17)
        fa = str(tmp_path / "r.fa")
        with open(fa, "w") as f:
            for i in range(80):
                f.write(f">s{i}\n" + "".join(
                    "ACGT"[c] for c in rng.integers(0, 4, 400)) + "\n")
        paths, exp = [fa], 64
    counter.count_to_arrays_device_acc(paths, k, "canonical", False, chunk,
                                       exp, device="cpu")
    ws, sp = counter.LAST_WIRE_STATS, trace.LAST_SPANS
    assert list(ws) == WIRE_KEYS
    assert ws["recounts"] > 0 if hatch == "recount" else True
    assert ws["salvaged"] == (hatch == "salvage")
    assert ws["reader_busy_s"] == pytest.approx(
        sp["count.reader_scan_s"] + sp["count.reader_pack_s"], abs=2e-4)
    assert ws["scan_stall_s"] == pytest.approx(sp["count.wait_reader_s"],
                                               abs=1e-4)
    for name in ("h2d", "dispatch", "fetch"):
        assert ws[f"n_{name}"] == sp.get(f"count.{name}_n", 0)
        assert ws[f"t_{name}_s"] == pytest.approx(
            sp.get(f"count.{name}_s", 0.0), abs=1e-4)
    assert ws["t_finalize_s"] >= ws["t_download_s"] >= 0
    # the reader thread's spans: one scan a chunk and the end of the file
    assert sp["count.reader_pack_n"] >= ws["chunks"] >= 1
    assert sp["count.reader_scan_n"] == sp["count.reader_pack_n"] + 1
    # each chunk packed natively once, a recounted one again
    assert ws["native_packs"] == sp["count.reader_pack_n"] + ws["recounts"]


def test_profiler_sees_the_main_thread_spans(tmp_path, reads):
    out = str(tmp_path / "a.meryl")
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with torch.profiler.record_function("bench:meryl count"):
            assert cli.main(["count", "k=21", reads, "output", out,
                             "device=cpu"]) == 0
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
            e.activity_type() if hasattr(e, "activity_type") else None)
           for e in prof.profiler.kineto_results.events()]
    (_, a, b, _), = [e for e in evs if e[0] == "bench:meryl count"]
    mine = [e for e in evs if e[0].startswith("meryl.")]
    names = {e[0] for e in mine}
    assert {"meryl.count.wait_reader", "meryl.count.h2d",
            "meryl.count.dispatch", "meryl.count.finalize",
            "meryl.count.download", "meryl.count.db_write"} <= names
    # the reader thread's spans are counters only
    assert not any("reader_" in n for n in names)
    assert trace.LAST_SPANS["count.reader_scan_n"] > 0
    assert all(a <= s and e <= b for _, s, e, _ in mine)
    # host operators, which kineto does not mirror onto a device
    assert {kind for *_, kind in mine} <= {"cpu_op", None}


# ------------------------------------------------- commands and readers

@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace_dbs")
    rng = np.random.default_rng(3)
    fq = str(d / "reads.fq")
    g = _write_reads(fq, rng, 600)
    fa = str(d / "asm.fa")
    with open(fa, "w") as f:
        f.write(">asm\n" + g[:2000] + "ACGT" * 30 + g[2000:] + "\n")
    mp = pytest.MonkeyPatch()
    mp.setenv("MERYL_TPU_DEVICE_ACC", "1")
    mp.setenv("MERYL_TPU_SHARDED", "0")
    for src, name in ((fq, "reads"), (fa, "asm")):
        assert cli.main(["count", "k=21", src, "output",
                         str(d / f"{name}.meryl"), "device=cpu"]) == 0
    mp.undo()
    return d


COMMANDS = {
    "count": (cli.main, lambda d: ["count", "k=21", str(d / "reads.fq"),
                                   "output", str(d / "out.meryl"),
                                   "device=cpu"]),
    "setop": (cli.main, lambda d: ["difference", str(d / "asm.meryl"),
                                   str(d / "reads.meryl"), "output",
                                   str(d / "out.meryl"), "device=cpu"]),
    "lookup": (lookup_cli.main, lambda d: [
        "-existence", "-sequence", str(d / "reads.fq"), "-mers",
        str(d / "reads.meryl"), str(d / "asm.meryl"), "-output",
        str(d / "out.tsv"), "-device", "cpu"]),
}


def _reader(name):
    if BENCH not in sys.path:
        sys.path.append(BENCH)
    spec = importlib.util.spec_from_file_location(
        "trace_reader_" + name.replace(".", "_"),
        os.path.join(BENCH, "layer_metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("what", sorted(COMMANDS))
def test_a_command_fills_its_metrics_keys(dbs, capsys, what):
    main, argv = COMMANDS[what]
    assert main(argv(dbs)) == 0
    keys = [key for m in SPAN_METRICS if m.split(".")[0] == what
            for key in _reader(m).KEYS]
    assert len(keys) >= 4
    assert all(trace.LAST_SPANS.get(key, 0) > 0 for key in keys), \
        {key: trace.LAST_SPANS.get(key) for key in keys}


def test_thirteen_span_metrics():
    assert len(SPAN_METRICS) == 13


def _cmd(argv0, spans):
    return SimpleNamespace(cmd=SimpleNamespace(argv=[argv0, "x"]),
                           probes={"meryl_tpu_torch.trace:LAST_SPANS":
                                   spans})


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_share_of_a_run(monkeypatch, name):
    mod = _reader(name)
    argv0 = ARGV0[name.split(".")[0]]
    own = argv0 or "difference"
    one = {key: 1.0 for key in mod.KEYS}
    three = {key: 3.0 for key in mod.KEYS}
    other = {key: 100.0 for key in mod.KEYS}
    run = SimpleNamespace(
        window_s=20.0, probes_start={},
        commands=[_cmd(own, one), _cmd("histogram", {}),
                  _cmd(own, three), _cmd("count" if argv0 != "count"
                                         else "-existence", other)])
    want = 100.0 * 4.0 * len(mod.KEYS) / 20.0
    if argv0 is None:         # every command of the window counts
        want += 100.0 * 100.0 * len(mod.KEYS) / 20.0
    assert mod.read(run) == pytest.approx(want)
    # a program without the spans: no probe, no value
    import harness.spans
    monkeypatch.setattr(harness.spans, "PROBES", [])
    assert mod.read(run) is None
