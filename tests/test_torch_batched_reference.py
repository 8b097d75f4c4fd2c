"""The batched (memory=) count of the ecoli-k12-illumina-k21-memory1
deployment against the benchmark's plain reference, and its spans and counters.

Reads come from the benchmark's generator (benchmark/reference/reads.py)
under the configuration's read model (150 bp, 30x, 0.2 % substitutions,
0.05 % N) at a 200 kbp genome.  `meryl count k=21 memory=<m>` through
cli.main, with a small chunk and the `memory=` that plans 6 batches of
the FASTQ's size as the cell's `memory=1` does of its 290.6 MB, cuts 3
real batches and must write the DB that the reference
(benchmark/reference/kmers) works out, key for key and count for count,
with the device accumulator on and off.  Each partial DB the final
union-sum merges holds what the reference counts over the windows of its
batch.  After a count the batched spans (count.batch_flush,
count.batch_merge, count.wait_reader) are in trace.LAST_SPANS, and
LAST_BATCH_STATS and LAST_WIRE_STATS hold the job's counters; the
benchmark's cell resolves, and its three new per-layer readers read a
CPU traced run and nothing where their probes find nothing."""

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from meryl_tpu_torch import cli, counter, optree, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness import devtrace, peaks, registry, runner  # noqa: E402
from reference import dbfile, kmers  # noqa: E402
from reference import reads as rd  # noqa: E402

CELL = "ecoli-k12-illumina-k21.count-batched"
ONE_PASS = "ecoli-k12-illumina-k21.count"
CONFIG = os.path.join(BENCH, "configs",
                      "ecoli-k12-illumina-k21-memory1.json")
ONE_PASS_CONFIG = os.path.join(BENCH, "configs",
                               "ecoli-k12-illumina-k21.json")
GENOME_BP = 200_000
SEED = 2 ** 31 + 2024
CHUNK = 1 << 18        # codes a chunk: 24 chunks, 8 a batch
K = 21
NEW_METRICS = ["batch.flush_share", "batch.merge_share",
               "batch.merge_rowsort_roofline"]
ENV = ("MERYL_TPU_SHARDED", "MERYL_TPU_CHUNK", "MERYL_TPU_DEVICE_ACC",
       "MERYL_TPU_COORD", "MERYL_TPU_LOCAL_DEVICES")


def _config(path=CONFIG):
    with open(path) as f:
        return json.load(f)


def _memory_gb(path: str) -> float:
    """The memory= that plans 6 batches of the file-size guess (20 B an
    expected k-mer), as memory=1 does of the cell's 290.6 MB FASTQ."""
    return round(counter.expected_kmers([path]) * 20 / 5.5e9, 8)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """(FASTQ path, read set, reference keys, reference counts)."""
    cfg = _config()
    genome = rd.make_genome(GENOME_BP, SEED)
    rs = rd.make_reads(genome, cfg["reads"], cfg["reads"]["depth"], SEED,
                       1, "r")
    fq = str(tmp_path_factory.mktemp("ecoli") / "reads.fq")
    rd.write_fastq(fq, rs)
    keys, counts = kmers.count(rs.codes, rs.lens, K, "cpu")
    return fq, rs, keys, counts


@pytest.fixture(autouse=True)
def batched(monkeypatch):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    monkeypatch.setenv("MERYL_TPU_CHUNK", str(CHUNK))
    trace.reset()
    yield
    trace.reset()


def _batch_reference(rs, n_batches: int, span: int):
    """The reference's counts over each batch's windows: a batch holds
    the windows whose start lies in its `span` codes of the stream the
    counter reads (every read followed by one separator)."""
    key, valid = kmers.window_keys(torch.from_numpy(rs.codes),
                                   torch.from_numpy(rs.lens), K)
    read_of = np.repeat(np.arange(rs.n_reads), rs.lens)
    batch = (np.arange(rs.bases) + read_of) // span
    key, valid = key.numpy(), valid.numpy()
    return [np.unique(key[valid & (batch == b)], return_counts=True)
            for b in range(n_batches)]


def _count(fq, out, monkeypatch, acc):
    """The batched count through cli.main -> the partial DBs as the
    final union-sum found them, decoded."""
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", acc)
    partials = []
    real = optree.execute_root

    def spy(node, k, **kw):
        if node.op == "union-sum":
            partials.extend(dbfile.read(i.path, k) for i in node.inputs)
        return real(node, k, **kw)

    monkeypatch.setattr(optree, "execute_root", spy)
    assert cli.main(["count", f"k={K}", f"memory={_memory_gb(fq)}", fq,
                     "output", out, "device=cpu"]) == 0
    return partials


# -------------------------------------------- the count against the reference

@pytest.mark.parametrize("acc", ["1", "0"])
def test_cli_count_matches_reference(reads, tmp_path, monkeypatch, acc):
    fq, rs, keys, counts = reads
    out = str(tmp_path / "reads.meryl")
    partials = _count(fq, out, monkeypatch, acc)
    st = counter.LAST_BATCH_STATS
    assert counter.configure_counting([fq], K, _memory_gb(fq),
                                      device="cpu")["batches"] == 6
    assert st["batches"] == 3 and len(partials) == 3
    assert [b["device_acc"] for b in st["counted"]] == [acc == "1"] * 3
    got = dbfile.read(out, K)
    np.testing.assert_array_equal(got.keys, keys.astype(np.uint64))
    np.testing.assert_array_equal(got.counts.astype(np.int64), counts)
    assert got.hi_nonzero == 0
    assert np.array_equal(dbfile.prefix6(got.keys, K), got.bucket)
    assert {f: int(got.index[f]) for f in dbfile.stats(counts)} == \
        dbfile.stats(counts)
    assert not [p for p in os.listdir(tmp_path) if p != "reads.meryl"]


@pytest.mark.parametrize("acc", ["1", "0"])
def test_partials_are_the_batches_reference(reads, tmp_path, monkeypatch,
                                            acc):
    """Partial i holds the reference's counts over the windows that
    start in batch i's chunks (chunk_len - k + 1 new windows a chunk)."""
    fq, rs, _, _ = reads
    partials = _count(fq, str(tmp_path / "r.meryl"), monkeypatch, acc)
    plan = counter.configure_counting([fq], K, _memory_gb(fq), device="cpu")
    per_batch = -(-plan["batch_bases"] // CHUNK)
    want = _batch_reference(rs, len(partials),
                            per_batch * (CHUNK - K + 1))
    for got, (wk, wc) in zip(partials, want):
        assert len(wk) > 0
        np.testing.assert_array_equal(got.keys, wk.astype(np.uint64))
        np.testing.assert_array_equal(got.counts.astype(np.int64), wc)


# ------------------------------------------------- spans and counters

@pytest.mark.parametrize("acc", ["1", "0"])
def test_spans_and_counters_after_a_count(reads, tmp_path, monkeypatch, acc):
    fq, rs, _, _ = reads
    partials = _count(fq, str(tmp_path / "r.meryl"), monkeypatch, acc)
    st, sp = counter.LAST_BATCH_STATS, trace.LAST_SPANS
    assert sp["count.batch_flush_n"] == st["batches"] == 3
    assert sp["count.batch_merge_n"] == 1
    assert sp["count.wait_reader_n"] == st["chunks"] + 1
    assert sp["count.db_write_n"] == 3          # the partials
    assert sp["setop.db_write_n"] > 0           # the merge's output
    assert st["partial_entries"] == [len(p.keys) for p in partials]
    assert st["partial_entries"] == [b["kmers"] for b in st["counted"]]
    assert st["merge_entries"] == sum(st["partial_entries"])
    assert st["t_flush_s"] > 0 and st["t_merge_s"] > 0
    wire = counter.LAST_WIRE_STATS
    # the codes shipped, as the one-pass count reports them: each chunk
    # whole (the reads, a separator after each, the k - 1 codes two
    # chunks share, the last chunk's padding)
    assert wire["bases"] == st["chunks"] * CHUNK
    assert st["chunks"] * (CHUNK - K + 1) >= rs.bases + rs.n_reads
    assert wire["chunks"] == st["chunks"]
    assert wire["t_finalize_s"] > 0 and wire["reader_busy_s"] > 0
    assert wire["scan_stall_s"] == round(sp["count.wait_reader_s"], 4)
    assert wire["salvaged"] is False
    assert (wire["merges"] > 0) == (acc == "1")
    assert (wire["d2h_bytes"] > 0) == (acc == "1")


def test_wire_stats_match_the_one_pass_count(reads, tmp_path, monkeypatch):
    """The batched count's summed LAST_WIRE_STATS read the same input as
    the one-pass count's: the same codes and chunks."""
    fq = reads[0]
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", "1")
    assert cli.main(["count", f"k={K}", fq, "output",
                     str(tmp_path / "one.meryl"), "device=cpu"]) == 0
    one = dict(counter.LAST_WIRE_STATS)
    _count(fq, str(tmp_path / "b.meryl"), monkeypatch, "1")
    wire = counter.LAST_WIRE_STATS
    assert set(wire) == set(one)
    assert wire["bases"] == one["bases"] and wire["chunks"] == one["chunks"]
    assert wire["native_packs"] == one["native_packs"]


# ------------------------------------------------------ the benchmark

def test_cell_resolves_on_one_chip():
    bench = registry.load_benchmark(ROOT)
    cell = registry.find_cell(bench, CELL, ROOT)
    assert cell.chips == 1
    assert cell.traffic["metric"]["name"] == "count_mbases_s"
    assert cell.traffic["job"][0]["argv"][:3] == ["count", "k={k}",
                                                  "memory=1"]
    assert {"count_mbases_s", "peak_device_mib", "setup_s"} == \
        {m["name"] for m in cell.end_to_end}
    assert set(NEW_METRICS + [
        "extract_roofline", "device_idle.count", "count.reader_scan_share",
        "count.scan_stall_share", "count.finalize_share"]) == \
        {m["name"] for m in cell.per_layer}
    assert cell.config["name"] == "ecoli-k12-illumina-k21-memory1"
    assert cell.config["reduced"] == []
    budget = f"memory={cell.config['memory_gb']}"
    assert budget in cell.traffic["job"][0]["argv"]


def test_deployment_counts_the_one_pass_cells_reads():
    """The memory-bounded deployment differs from the one-pass ecoli
    deployment by its budget alone: the same k, genome and read model."""
    batched, one_pass = _config(), _config(ONE_PASS_CONFIG)
    for key in ("k", "mode", "genome", "reads", "assembly"):
        assert batched[key] == one_pass[key]
    assert "memory_gb" not in one_pass


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "batched_reader_" + name.replace(".", "_"),
        os.path.join(BENCH, "layer_metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _traced(tmp_path_factory, name, memory=None):
    """A traced window of a cell on the CPU at a small genome (a small
    chunk; `memory` in place of the mix's memory=1, which a small FASTQ
    would count in one batch): the run its readers see."""
    spec = importlib.util.spec_from_file_location(
        "batched_bench_run", os.path.join(BENCH, "run.py"))
    bench_run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_run)
    cell = registry.find_cell(registry.load_benchmark(ROOT), name, ROOT)
    cell.config["genome"]["length_bp"] = 60_000
    if memory is not None:
        argv = cell.traffic["job"][0]["argv"]
        argv[argv.index("memory=1")] = f"memory={memory}"
    saved = {key: os.environ.pop(key, None) for key in ENV}
    os.environ.update(MERYL_TPU_SHARDED="0", MERYL_TPU_CHUNK=str(1 << 16))
    try:
        r = runner.Runner(cell, SEED, 0.5, True, "cpu",
                          str(tmp_path_factory.mktemp("traced")))
        r.setup()
        probes = sorted({p for m in cell.per_layer
                         for p in _reader(m["name"]).PROBES})
        window_s = r.window(probes)
    finally:
        for key, v in saved.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
    return bench_run.LayerRun(r, window_s)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    # 60 kbp at 30x: 1.8 Mbases, 3.8 MB of FASTQ; 6 planned batches
    return _traced(tmp_path_factory, CELL, memory=0.0138)


@pytest.fixture(scope="module")
def traced_one_pass(tmp_path_factory):
    return _traced(tmp_path_factory, ONE_PASS)


def test_traced_run_is_batched(traced):
    for d in traced.commands:
        st = d.probes["meryl_tpu_torch.counter:LAST_BATCH_STATS"]
        assert d.rc == 0 and st["batches"] >= 3
        assert st["merge_entries"] == sum(st["partial_entries"])


@pytest.mark.parametrize("name", NEW_METRICS + [
    "count.scan_stall_share", "count.finalize_share",
    "count.reader_scan_share"])
def test_reader_reads_a_traced_cpu_run(traced, name):
    """The span shares read the run; the row sort's roofline finds no
    device operation on the CPU, and reads one when the trace holds the
    kernel."""
    mod = _reader(name)
    v = mod.read(traced)
    if name != "batch.merge_rowsort_roofline":
        assert v is not None and 0 < v <= 100, v
        return
    assert v is None
    entries = sum(d.probes[mod.PROBES[0]]["merge_entries"]
                  for d in traced.commands)
    assert entries > 0
    t = devtrace.Trace(traced.window_s, 2e-3,
                       [("void bitonic_keys_kernel<21>(...)", 0.0, 1e-3),
                        ("extract_kernel", 0.0, 1e-3)], [])
    run = SimpleNamespace(**{**vars(traced), "trace": t})
    assert mod.read(run) == pytest.approx(
        100.0 * 40 * entries / peaks.HBM_BYTES_PER_S / 1e-3)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_none_on_a_one_pass_count(traced_one_pass, name):
    t = devtrace.Trace(1.0, 1e-3, [("bitonic_keys_kernel", 0.0, 1e-3)], [])
    run = SimpleNamespace(**{**vars(traced_one_pass), "trace": t})
    assert _reader(name).read(run) is None


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_none_without_the_new_counters(traced, name):
    """A program whose LAST_BATCH_STATS lacks the new keys (the
    parent's) gives nothing to read."""
    mod = _reader(name)
    probe = "meryl_tpu_torch.counter:LAST_BATCH_STATS"
    new = ("t_flush_s", "t_merge_s", "merge_entries", "partial_entries")
    old = [SimpleNamespace(
        cmd=d.cmd, rc=d.rc, probes={probe: {k: v for k, v in
                                            d.probes[probe].items()
                                            if k not in new}})
        for d in traced.commands]
    t = devtrace.Trace(1.0, 1e-3, [("bitonic_keys_kernel", 0.0, 1e-3)], [])
    assert mod.read(SimpleNamespace(**{**vars(traced), "trace": t,
                                       "commands": old})) is None
