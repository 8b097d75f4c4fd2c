"""The sharded count of the human-illumina-k21 deployment against the
benchmark's plain reference, and its spans and counters.

Reads come from the benchmark's generator (benchmark/reference/reads.py)
under the configuration's read model (150 bp, 30x, 0.2 % substitutions,
0.05 % N) at a 200 kbp genome.  `meryl count` through cli.main on the
sharded path with 1, 2 and 4 CPU members and a small step must write
the DB that the reference (benchmark/reference/kmers.count) works out,
key for key and count for count, and each member's owner range is its
share of that uncut reference; the insertion that takes an owner's few
captured windows into its run is the merge.  After a count the members'
spans (shard.*) are in trace.LAST_SPANS and LAST_SHARD_STATS holds
`members` and `peer_bytes`; the benchmark's cell resolves, and its five new
per-layer readers read a CPU traced run and nothing where their probes
find nothing."""

import contextlib
import importlib.util
import json
import os
import sys
import threading
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import pytest

from meryl_tpu_torch import cli, counter, trace
from meryl_tpu_torch.parallel import local_group
from meryl_tpu_torch.parallel import shard_count as sc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness import devtrace, registry, runner, shard_spans  # noqa: E402
from reference import dbfile, kmers  # noqa: E402
from reference import reads as rd  # noqa: E402

CELL = "human-illumina-k21.sharded4"
CONFIG = os.path.join(BENCH, "configs", "human-illumina-k21.json")
GENOME_BP = 200_000
SEED = 2 ** 31 + 2021
CHUNK = 1 << 15        # bases a member feeds a step: many steps
K = 21
NEW_METRICS = ["shard.wait_dealer_share", "shard.exchange_share",
               "shard.step_share", "shard.finalize_share",
               "exchange_link_roofline"]
SPANS = ["shard.wait_dealer", "shard.exchange", "shard.step",
         "shard.settle", "shard.owner_parts"]
ENV = ("MERYL_TPU_SHARDED", "MERYL_TPU_LOCAL_DEVICES", "MERYL_TPU_COORD",
       "MERYL_TPU_SHARD_CHUNK", "MERYL_TPU_SHARD_ACC_CAP", "MERYL_TPU_CHUNK")


def _config():
    with open(CONFIG) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """(FASTQ path, read set, reference keys, reference counts)."""
    cfg = _config()
    genome = rd.make_genome(GENOME_BP, SEED)
    rs = rd.make_reads(genome, cfg["reads"], cfg["reads"]["depth"], SEED,
                       1, "r")
    fq = str(tmp_path_factory.mktemp("human") / "reads.fq")
    rd.write_fastq(fq, rs)
    keys, counts = kmers.count(rs.codes, rs.lens, K, "cpu")
    return fq, rs, keys, counts


@pytest.fixture(autouse=True)
def sharded(monkeypatch):
    monkeypatch.setattr(local_group, "GROUP_TIMEOUT",
                        timedelta(seconds=60))
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("MERYL_TPU_SHARDED", "1")
    monkeypatch.setenv("MERYL_TPU_SHARD_CHUNK", str(CHUNK))
    trace.reset()
    yield
    trace.reset()


def _count(fq, out, n, monkeypatch):
    monkeypatch.setenv("MERYL_TPU_LOCAL_DEVICES", str(n))
    assert cli.main(["count", f"k={K}", fq, "output", out,
                     "device=cpu"]) == 0


# -------------------------------------------- the count against the reference

@pytest.mark.parametrize("n", [1, 2, 4])
def test_cli_count_matches_reference(reads, tmp_path, monkeypatch, n):
    fq, rs, keys, counts = reads
    out = str(tmp_path / "reads.meryl")
    _count(fq, out, n, monkeypatch)
    assert sc.LAST_SHARD_STATS["members"] == n
    assert sc.LAST_SHARD_STATS["steps"] >= 40 // n
    assert sc.LAST_SHARD_STATS["spills"] == 0
    got = dbfile.read(out, K)
    np.testing.assert_array_equal(got.keys, keys.astype(np.uint64))
    np.testing.assert_array_equal(got.counts.astype(np.int64), counts)
    assert got.hi_nonzero == 0
    assert np.array_equal(dbfile.prefix6(got.keys, K), got.bucket)
    assert {f: int(got.index[f]) for f in dbfile.stats(counts)} == \
        dbfile.stats(counts)


@pytest.mark.parametrize("n", [2, 4])
def test_owner_parts_share_the_reference(reads, n):
    """Each member's owner range is ascending, disjoint from the
    others', and holds the keys the device's row map gives it; the
    ranges in member order are the uncut reference."""
    fq, _, keys, counts = reads
    counters = counter._count_sharded(
        [fq], K, mode="canonical", hpc=False, chunk_len=CHUNK,
        progress=None, segment=None, device="cpu", devices=["cpu"] * n)
    parts = []
    for r, c in enumerate(counters):
        mine = list(c.owner_parts())
        assert [p[0] for p in mine] == [r]
        _, hi, lo, cnt = mine[0]
        assert not hi.any()
        assert np.all(np.diff(lo.astype(np.uint64)) > 0)
        owners = sc.owner_of_keys(hi, lo, K, c.bits, c.B, c.rpo, True)
        assert np.all(owners == r)
        parts.append((lo, cnt))
    for (a, _), (b, _) in zip(parts, parts[1:]):
        assert not len(a) or not len(b) or a[-1] < b[0]
    np.testing.assert_array_equal(
        np.concatenate([lo for lo, _ in parts]), keys.astype(np.uint64))
    np.testing.assert_array_equal(
        np.concatenate([c for _, c in parts]).astype(np.int64), counts)


def _sorted_run(rng, n, hi_bits, cmax):
    hi = rng.integers(0, 1 << hi_bits, n).astype(np.uint64) if hi_bits \
        else np.zeros(n, np.uint64)
    lo = rng.integers(0, 1 << 12, n).astype(np.uint64)
    hi, lo, _ = counter._unique_run(hi, lo)
    return hi, lo, rng.integers(1, cmax, len(lo)).astype(np.uint64)


@pytest.mark.parametrize("hi_bits", [0, 3, 63])
@pytest.mark.parametrize("cmax", [9, 1 << 33])
def test_insert_runs_is_the_merge(hi_bits, cmax):
    """An owner's few captured windows go into its run by insertion:
    the same keys and counts (clamped alike) as the merge, for one-word
    keys (hi zero) and two-word keys, with keys new to the run, keys it
    holds, and keys before and after all of it."""
    rng = np.random.default_rng(hi_bits * 7 + cmax % 5)
    for _ in range(40):
        big = _sorted_run(rng, int(rng.integers(1, 3000)), hi_bits, cmax)
        at = np.sort(rng.choice(len(big[2]), min(3, len(big[2])),
                                replace=False))
        held = (big[0][at], big[1][at], np.full(len(at), cmax, np.uint64))
        ends = (np.array([0, (1 << 64) - 1], np.uint64),
                np.array([0, (1 << 64) - 1], np.uint64),
                np.ones(2, np.uint64))
        if not hi_bits:
            ends = (np.zeros(2, np.uint64), np.array([0, 1 << 13],
                                                     np.uint64), ends[2])
        small = [_sorted_run(rng, int(rng.integers(1, 30)), hi_bits, cmax)
                 for _ in range(int(rng.integers(1, 4)))] + [held, ends]
        want = counter.merge_runs([big] + small)
        got = counter.insert_runs(big, small)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------- spans and counters

def test_every_shard_span_after_a_count(reads, tmp_path, monkeypatch):
    _count(reads[0], str(tmp_path / "r.meryl"), 4, monkeypatch)
    for name in SPANS:
        assert trace.LAST_SPANS.get(name + "_s", 0) > 0, name
        assert trace.LAST_SPANS.get(name + "_n", 0) > 0, name
    assert trace.LAST_SPANS["shard.settle_n"] == 4
    assert trace.LAST_SPANS["shard.owner_parts_n"] == 4
    assert trace.LAST_SPANS["shard.step_n"] == \
        4 * sc.LAST_SHARD_STATS["steps"]
    # the reader's and the DB write's spans, which the single-card
    # count's metrics read, are there too
    assert trace.LAST_SPANS["count.reader_scan_n"] > 0
    assert trace.LAST_SPANS["count.db_write_n"] == 1


def test_exchange_counts_whole_collectives_alike(reads, tmp_path,
                                                 monkeypatch):
    """Every member makes the same collectives: shard.exchange_n is
    equal on every member's thread, at least two a step (the
    all-to-all and the stats' all_reduce), and the members' sum is what
    LAST_SPANS holds."""
    own = {}
    real = trace.thread_spans

    @contextlib.contextmanager
    def spy():
        with real():
            sink = trace._local.sink
            try:
                yield
            finally:
                own[threading.current_thread().name] = dict(sink)

    monkeypatch.setattr(trace, "thread_spans", spy)
    _count(reads[0], str(tmp_path / "r.meryl"), 4, monkeypatch)
    members = {t: s for t, s in own.items()
               if t.startswith("meryl-member-")}
    assert len(members) == 4
    steps = sc.LAST_SHARD_STATS["steps"]
    n_ex = {s["shard.exchange_n"] for s in members.values()}
    assert len(n_ex) == 1 and n_ex.pop() >= 2 * steps
    assert {s["shard.step_n"] for s in members.values()} == {steps}
    assert sum(s["shard.exchange_n"] for s in members.values()) == \
        trace.LAST_SPANS["shard.exchange_n"]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_members_and_peer_bytes(reads, tmp_path, monkeypatch, n):
    """peer_bytes: each step, each member sends n - 1 of the n equal
    blocks of its (B, Wc) int64 cell grid to another member."""
    _count(reads[0], str(tmp_path / "r.meryl"), n, monkeypatch)
    stats = sc.LAST_SHARD_STATS
    g = sc.plan_shard_route(CHUNK, K, n)
    want = n * stats["steps"] * (n - 1) * (g["B"] // n) * g["Wc"] * 8
    assert stats["members"] == n
    assert stats["peer_bytes"] == want
    assert (want > 0) == (n > 1)


# ------------------------------------------------------ the benchmark

def test_cell_resolves_on_four_chips():
    bench = registry.load_benchmark(ROOT)
    cell = registry.find_cell(bench, CELL, ROOT)
    assert cell.chips == 4
    assert cell.traffic["metric"]["name"] == "count_mbases_s"
    assert {"count_mbases_s", "peak_device_mib", "setup_s"} <= \
        {m["name"] for m in cell.end_to_end}
    names = [m["name"] for m in cell.per_layer]
    assert set(NEW_METRICS + ["count.reader_scan_share",
                              "count.db_write_share"]) == set(names)
    cfg = cell.config
    assert cfg["genome"]["length_bp"] == 46_709_983
    assert cfg["k"] == K and cfg["mode"] == "canonical"
    assert cfg["reads"] == {"length": {"fixed": 150}, "depth": 30,
                            "substitution_rate": 0.002, "n_rate": 0.0005}
    entry = next(c for c in bench["configs"] if c["name"] == cfg["name"])
    assert entry["reduced"] == cfg["reduced"] == ["genome"]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "shard_reader_" + name.replace(".", "_"),
        os.path.join(BENCH, "layer_metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A traced window of the cell on the CPU at a small genome (four
    members): the harness's runner and the run its readers see."""
    spec = importlib.util.spec_from_file_location(
        "shard_bench_run", os.path.join(BENCH, "run.py"))
    bench_run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_run)
    cell = registry.find_cell(registry.load_benchmark(ROOT), CELL, ROOT)
    cell.config["genome"]["length_bp"] = 60_000
    env = {"MERYL_TPU_SHARDED": "1", "MERYL_TPU_LOCAL_DEVICES": "4",
           "MERYL_TPU_SHARD_CHUNK": str(CHUNK)}
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
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


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_reads_a_traced_cpu_run(traced, name):
    """The span shares read the members' spans of the run; the link's
    roofline finds no peer copy on the CPU, and reads one when the
    trace holds peer copies."""
    mod = _reader(name)
    v = mod.read(traced)
    if name != "exchange_link_roofline":
        assert v is not None and 0 < v <= 100, v
        return
    assert v is None
    nbytes = sum(d.probes[shard_spans.STATS]["peer_bytes"]
                 for d in traced.commands)
    assert nbytes > 0
    t = devtrace.Trace(traced.window_s, 1e-3,
                       [("Memcpy PtoP (Device -> Device)", 0.0, 1e-3),
                        ("Memcpy HtoD (Pinned -> Device)", 0.0, 5.0)], [])
    run = SimpleNamespace(**{**vars(traced), "trace": t})
    assert mod.read(run) == pytest.approx(
        100.0 * nbytes / mod.LINK_BYTES_PER_S / 1e-3)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_none_without_its_probes(traced, monkeypatch, name):
    mod = _reader(name)
    ptop = devtrace.Trace(1.0, 1e-3, [("Memcpy PtoP", 0.0, 1e-3)], [])
    run = SimpleNamespace(**{**vars(traced), "trace": ptop})
    # a program whose counters lack the new keys (the parent's)
    old = [SimpleNamespace(
        cmd=d.cmd, rc=d.rc, probes={
            shard_spans.SPANS: {k: v for k, v in
                                d.probes[shard_spans.SPANS].items()
                                if not k.startswith("shard.")},
            shard_spans.STATS: {k: v for k, v in
                                d.probes[shard_spans.STATS].items()
                                if k not in ("members", "peer_bytes")}})
        for d in traced.commands]
    assert mod.read(SimpleNamespace(**{**vars(run), "commands": old})) \
        is None
    # a program without the modules: no probe
    monkeypatch.setattr(shard_spans, "PROBES", [])
    assert mod.read(run) is None
