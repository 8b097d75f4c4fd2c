"""meryl_tpu_torch's counting plan, memory route and out-of-core batched
counting against meryl_tpu's (tests/test_batched.py and
tests/test_memory_plan.py mirrored): the same FASTA bytes go to both
packages, the decoded DBs must be equal, and the host half of the plan
is equal key by key.  A run begun by one package is finished by the
other."""

import json
import os

import numpy as np
import pytest

from meryl_tpu import counter as ref_counter
from meryl_tpu import kmer as km
from meryl_tpu import oracle
from meryl_tpu.db import MerylDB as RefDB
from meryl_tpu_torch import counter
from meryl_tpu_torch.db import MerylDB

K = 9
HOST_KEYS = ("k", "expected_kmers", "host_bytes_per_kmer", "memory_gb",
             "host_peak_bytes", "batches", "batch_bases", "devices",
             "sharded")


@pytest.fixture(autouse=True)
def single_device(monkeypatch):
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")


def _fasta(tmp_path, seqs, name="r.fa"):
    p = tmp_path / name
    p.write_text("".join(f">q{i}\n{s}\n" for i, s in enumerate(seqs)))
    return str(p)


def _mkseqs(n, count, seed=0):
    rng = np.random.default_rng(seed)
    return ["".join(km.ALPHABET[c] for c in rng.integers(0, 4, size=n))
            for _ in range(count)]


def _load(db):
    return [np.asarray(x) for x in db.load_all()]


def _assert_oracle(db, seqs, k=K):
    hi, lo, c = _load(db)
    ohi, olo, oc = oracle.count_kmers(seqs, k)
    np.testing.assert_array_equal(hi, ohi)
    np.testing.assert_array_equal(lo, olo)
    np.testing.assert_array_equal(c, oc)


def _assert_same(db, ref_db):
    for a, b in zip(_load(db), _load(ref_db)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("acc", ["0", "1"])
def test_batched_matches_oracle_and_reference(tmp_path, monkeypatch, acc):
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", acc)
    seqs = _mkseqs(700, 6)
    fa = _fasta(tmp_path, seqs)
    out = str(tmp_path / "b.meryl")
    db = counter.count_to_db_batched([fa], out, K, chunk_len=1 << 11,
                                     batch_bases=1500, device="cpu")
    _assert_oracle(db, seqs)
    ref = ref_counter.count_to_db_batched(
        [fa], str(tmp_path / "ref.meryl"), K, chunk_len=1 << 11,
        batch_bases=1500)
    _assert_same(db, ref)
    assert counter.LAST_BATCH_STATS["batches"] >= 3
    assert len(counter.LAST_BATCH_STATS["counted"]) == \
        counter.LAST_BATCH_STATS["batches"]
    assert all(b["device_acc"] == (acc == "1")
               for b in counter.LAST_BATCH_STATS["counted"])
    # partials and manifest cleaned up
    assert not os.path.exists(out + ".manifest.json")
    assert not os.path.exists(out + ".batch0")


def test_batched_single_batch(tmp_path):
    """One batch: its partial DB is renamed into place, no merge."""
    seqs = _mkseqs(400, 2)
    fa = _fasta(tmp_path, seqs)
    out = str(tmp_path / "s.meryl")
    os.makedirs(out)  # an older output is replaced
    db = counter.count_to_db_batched([fa], out, K, chunk_len=1 << 11,
                                     batch_bases=10 ** 9, device="cpu")
    _assert_oracle(db, seqs)
    assert counter.LAST_BATCH_STATS["batches"] == 1
    assert not os.path.exists(out + ".batch0")
    assert not os.path.exists(out + ".manifest.json")


def test_batched_empty_input(tmp_path):
    fa = _fasta(tmp_path, [])
    out = str(tmp_path / "e.meryl")
    with open(out + ".manifest.json", "w") as f:
        json.dump({"k": K}, f)
    db = counter.count_to_db_batched([fa], out, K, chunk_len=1 << 11,
                                     batch_bases=1500, device="cpu")
    assert all(len(x) == 0 for x in db.load_all())
    assert not os.path.exists(out + ".manifest.json")
    ref = ref_counter.count_to_db_batched(
        [fa], str(tmp_path / "ref.meryl"), K, chunk_len=1 << 11,
        batch_bases=1500)
    _assert_same(db, ref)


def _plant(out, write_db, done=(0,), **over):
    """A manifest saying `done` batches are counted, each with an EMPTY
    partial DB: a resume that trusts it loses those batches' k-mers."""
    manifest = {"k": K, "mode": "canonical", "hpc": False,
                "batch_bases": 1500, "chunk_len": 1 << 11,
                "segment": None, "done": list(done)}
    manifest.update(over)
    with open(out + ".manifest.json", "w") as f:
        json.dump(manifest, f)
    z = np.zeros(0, np.uint64)
    for i in done:
        write_db(f"{out}.batch{i}", K, z, z.copy(), np.zeros(0, np.uint32))


def test_batched_resume_skips_done(tmp_path):
    seqs = _mkseqs(700, 6, seed=3)
    fa = _fasta(tmp_path, seqs)
    out = str(tmp_path / "r.meryl")
    _plant(out, MerylDB.write)
    db = counter.count_to_db_batched([fa], out, K, chunk_len=1 << 11,
                                     batch_bases=1500, resume=True,
                                     device="cpu")
    hi, lo, c = _load(db)
    ohi, olo, oc = oracle.count_kmers(seqs, K)
    full = {(int(h) << 64) | int(v) for h, v in zip(ohi, olo)}
    got = {(int(h) << 64) | int(v) for h, v in zip(hi, lo)}
    assert got and got < full  # batch 0 is missing by construction
    st = counter.LAST_BATCH_STATS
    assert st["skipped"] == [0]
    assert [b["batch"] for b in st["counted"]] == \
        list(range(1, st["batches"]))
    # the chunks of the skipped batch still count towards the total
    assert st["chunks"] == len(list(counter.SequenceChunker(
        [fa], K, 1 << 11)))
    # the reference, resumed from the same planted state, agrees
    out2 = str(tmp_path / "r2.meryl")
    _plant(out2, RefDB.write)
    ref = ref_counter.count_to_db_batched([fa], out2, K, chunk_len=1 << 11,
                                          batch_bases=1500, resume=True)
    _assert_same(db, ref)


def test_batched_resume_false_ignores_manifest(tmp_path):
    seqs = _mkseqs(700, 6, seed=3)
    fa = _fasta(tmp_path, seqs)
    out = str(tmp_path / "n.meryl")
    _plant(out, MerylDB.write)
    db = counter.count_to_db_batched([fa], out, K, chunk_len=1 << 11,
                                     batch_bases=1500, resume=False,
                                     device="cpu")
    _assert_oracle(db, seqs)


@pytest.mark.parametrize("over", [
    {"chunk_len": 1 << 12}, {"segment": [1, 2]}, {"k": K + 2},
    {"mode": "forward"}, {"batch_bases": 3000}, {"hpc": True}],
    ids=lambda o: next(iter(o)))
def test_batched_no_resume_on_changed_identity(tmp_path, over):
    """A manifest from a run with another chunk size, segment, k, mode,
    batch size or compression names other bases by "batch 0": it is not
    resumed, and every batch is counted."""
    seqs = _mkseqs(700, 6, seed=4)
    fa = _fasta(tmp_path, seqs)
    out = str(tmp_path / "c.meryl")
    _plant(out, MerylDB.write, **over)
    db = counter.count_to_db_batched([fa], out, K, chunk_len=1 << 11,
                                     batch_bases=1500, resume=True,
                                     device="cpu")
    _assert_oracle(db, seqs)
    assert counter.LAST_BATCH_STATS["skipped"] == []


def test_batched_respects_segment(tmp_path):
    seqs = _mkseqs(700, 6, seed=5)
    fa = _fasta(tmp_path, seqs)
    tot = {}
    for a in (1, 2):
        out = str(tmp_path / f"seg{a}.meryl")
        db = counter.count_to_db_batched([fa], out, K, chunk_len=1 << 11,
                                         batch_bases=1500, segment=(a, 2),
                                         device="cpu")
        ref = ref_counter.count_to_db_batched(
            [fa], str(tmp_path / f"ref{a}.meryl"), K, chunk_len=1 << 11,
            batch_bases=1500, segment=(a, 2))
        _assert_same(db, ref)
        hi, lo, c = _load(db)
        for h, v, n in zip(hi, lo, c):
            kk = (int(h) << 64) | int(v)
            tot[kk] = tot.get(kk, 0) + int(n)
    ohi, olo, oc = oracle.count_kmers(seqs, K)
    want = {(int(h) << 64) | int(v): int(n)
            for h, v, n in zip(ohi, olo, oc)}
    assert tot == want  # union-sum of the two segments == full count
    assert int(c.sum()) < int(oc.sum())  # a segment alone is a part


def _seqs_file(tmp_path, n, ln, seed):
    rng = np.random.default_rng(seed)
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, ln))
            for _ in range(n)]
    fa = tmp_path / "r.fa"
    fa.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    return str(fa), seqs


def test_batched_device_acc_matches(tmp_path, monkeypatch):
    """Each batch on the device accumulator (forced): partial DBs and
    final union equal to the host-path batches and to the reference."""
    fa, _ = _seqs_file(tmp_path, 60, 400, 33)
    kw = dict(chunk_len=1 << 14, batch_bases=6000)
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", "0")
    db1 = counter.count_to_db_batched([fa], str(tmp_path / "host.meryl"),
                                      21, device="cpu", **kw)
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", "1")
    db2 = counter.count_to_db_batched([fa], str(tmp_path / "acc.meryl"),
                                      21, device="cpu", **kw)
    assert all(b["device_acc"] for b in
               counter.LAST_BATCH_STATS["counted"])
    ref = ref_counter.count_to_db_batched(
        [fa], str(tmp_path / "ref.meryl"), 21, **kw)
    _assert_same(db1, db2)
    _assert_same(db2, ref)


def test_batched_device_acc_salvage_midbatch(tmp_path, monkeypatch):
    """AccCapacity mid-batch: the batch salvages exactly and finishes
    on the host path; the next batch tries the accumulator again."""
    fa, seqs = _seqs_file(tmp_path, 40, 500, 34)
    kw = dict(chunk_len=1 << 13, batch_bases=9000)
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", "0")
    db1 = counter.count_to_db_batched([fa], str(tmp_path / "host.meryl"),
                                      21, device="cpu", **kw)
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", "1")
    monkeypatch.setenv("MERYL_TPU_ACC_CAP_GB", "0.000002")  # ~2 KB
    made = []
    real = counter.DeviceAccCounter

    def spy(*a, **k):
        made.append(1)
        return real(*a, **k)

    monkeypatch.setattr(counter, "DeviceAccCounter", spy)
    db2 = counter.count_to_db_batched([fa], str(tmp_path / "acc.meryl"),
                                      21, device="cpu", **kw)
    st = counter.LAST_BATCH_STATS
    assert len(made) == st["batches"] >= 2
    assert not all(b["device_acc"] for b in st["counted"])  # salvaged
    _assert_same(db1, db2)
    _assert_oracle(db2, seqs, 21)


@pytest.mark.parametrize("first,acc", [("reference", "0"),
                                       ("reference", "1"), ("port", "0")])
def test_cross_package_resume(tmp_path, monkeypatch, first, acc):
    """A run begun by one package (stopped after its first two batches,
    their partial DBs and the manifest on disk) is finished by the
    other to the DB of an uninterrupted run."""
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", acc)
    seqs = _mkseqs(700, 8, seed=6)
    fa = _fasta(tmp_path, seqs)
    out = str(tmp_path / "x.meryl")
    kw = dict(chunk_len=1 << 11, batch_bases=1500)

    class Stop(Exception):
        pass

    def stop_after_two(n):
        if os.path.exists(out + ".batch1"):
            raise Stop

    begin, finish = (
        (lambda **k: ref_counter.count_to_db_batched([fa], out, K, **k),
         lambda **k: counter.count_to_db_batched([fa], out, K,
                                                 device="cpu", **k))
        if first == "reference" else
        (lambda **k: counter.count_to_db_batched([fa], out, K,
                                                 device="cpu", **k),
         lambda **k: ref_counter.count_to_db_batched([fa], out, K, **k)))
    with pytest.raises(Stop):
        begin(progress=stop_after_two, **kw)
    with open(out + ".manifest.json") as f:
        done = json.load(f)["done"]
    assert done == [0, 1] and os.path.isdir(out + ".batch0")
    db = finish(**kw)
    _assert_oracle(db, seqs)
    if first == "reference":
        st = counter.LAST_BATCH_STATS
        assert st["skipped"] == [0, 1] and st["counted"][0]["batch"] == 2
    assert not os.path.exists(out + ".manifest.json")
    assert not os.path.exists(out + ".batch0")


# ------------------------------------------------------------ the plan

@pytest.fixture()
def fasta(tmp_path):
    rng = np.random.default_rng(3)
    seqs = ["".join(km.ALPHABET[c] for c in rng.integers(0, 4, size=4000))]
    fa = str(tmp_path / "r.fa")
    with open(fa, "w") as f:
        f.write(">s\n" + seqs[0] + "\n")
    return fa, seqs


@pytest.mark.parametrize("k", [11, 21, 33])
@pytest.mark.parametrize("memory_gb", [20e-6, 0.001, 64, None])
@pytest.mark.parametrize("chunk_len", [None, 1024])
def test_plan_host_half_equals_reference(fasta, k, memory_gb, chunk_len):
    """With hbm_gb (and n_devices=1) passed, everything the plan says
    of the host equals the reference's; the device half is the port's
    own layout."""
    fa, _ = fasta
    plan = counter.configure_counting(fa, k, memory_gb, chunk_len,
                                      hbm_gb=80.0, device="cpu")
    ref = ref_counter.configure_counting(fa, k, memory_gb, chunk_len,
                                         hbm_gb=80.0, n_devices=1)
    assert list(plan) == list(ref)
    for key in HOST_KEYS + ("chunk_len", "hbm_gb"):
        assert plan[key] == ref[key], key
    assert plan["device_bytes_per_base"] == \
        counter.device_bytes_per_base(k)
    assert plan["device_chunk_hbm_bytes"] == \
        plan["chunk_len"] * plan["device_bytes_per_base"]


@pytest.mark.parametrize("ext,factor", [("", 1), (".gz", 3), (".bz2", 3.5),
                                        (".xz", 4)])
def test_expected_kmers_guess_by_format(tmp_path, ext, factor):
    import bz2
    import gzip
    import lzma
    data = b">s\n" + b"ACGT" * 5000 + b"\n"
    path = str(tmp_path / ("r.fa" + ext))
    opener = {"": open, ".gz": gzip.open, ".bz2": bz2.open,
              ".xz": lzma.open}[ext]
    with opener(path, "wb") as f:
        f.write(data)
    want = ref_counter.configure_counting(path, 21, hbm_gb=1.0,
                                          n_devices=1)["expected_kmers"]
    assert counter.expected_kmers(path) == want == \
        int(os.path.getsize(path) * factor)


def test_plan_hbm_bounds_device_chunk(fasta):
    fa, _ = fasta
    plan_big = counter.configure_counting(fa, 21, hbm_gb=80.0,
                                          device="cpu")
    plan_small = counter.configure_counting(fa, 21, hbm_gb=0.01,
                                            device="cpu")
    assert plan_small["chunk_len"] < plan_big["chunk_len"]
    # the chosen chunk's modeled footprint fits half the budget
    assert plan_small["device_chunk_hbm_bytes"] <= 0.01e9 * 0.5
    # wider k-mers cost more device memory a base (a second word)
    assert counter.device_bytes_per_base(33) > \
        counter.device_bytes_per_base(21) == \
        counter.device_bytes_per_base(16)


def test_plan_device_memory_source(fasta, monkeypatch):
    """hbm_gb: the override, else (device=cpu) the host's physical
    memory; never a fixed figure of another device."""
    fa, _ = fasta
    from meryl_tpu_torch.resources import physical_memory_bytes
    monkeypatch.delenv("MERYL_TPU_HBM_GB", raising=False)
    plan = counter.configure_counting(fa, 21, device="cpu")
    assert plan["hbm_gb"] == physical_memory_bytes() / 1e9
    monkeypatch.setenv("MERYL_TPU_HBM_GB", "3.5")
    assert counter.configure_counting(fa, 21, device="cpu")["hbm_gb"] == 3.5
    assert counter.configure_counting(fa, 21, hbm_gb=7.0,
                                      device="cpu")["hbm_gb"] == 7.0
    monkeypatch.delenv("MERYL_TPU_HBM_GB")
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        counter.configure_counting(fa, 21)  # cuda by default, no fallback


def test_plan_memory_bounds_host_batches(fasta):
    fa, _ = fasta
    budget = 20e-6  # 20 kB
    plan = counter.configure_counting(fa, 11, memory_gb=budget,
                                      device="cpu")
    assert plan["batches"] > 1
    assert plan["host_peak_bytes"] <= budget * 1e9 + \
        plan["host_bytes_per_kmer"]
    assert counter.configure_counting(fa, 11, memory_gb=64,
                                      device="cpu")["batches"] == 1


@pytest.mark.parametrize("acc", ["0", "1"])
def test_count_memory_routes_batched(fasta, tmp_path, monkeypatch, acc):
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", acc)
    fa, seqs = fasta
    calls = []
    real = counter.count_to_db_batched

    def spy(*a, **kw):
        calls.append(kw.get("memory_gb"))
        return real(*a, **kw)

    monkeypatch.setattr(counter, "count_to_db_batched", spy)
    out = str(tmp_path / "m.meryl")
    db = counter.count_to_db(fa, out, 11, chunk_len=1024, memory_gb=20e-6,
                             device="cpu")
    assert calls == [20e-6], "memory= did not engage the batched path"
    assert counter.LAST_BATCH_STATS["batches"] >= 3
    _assert_oracle(db, seqs, 11)
    ref = ref_counter.count_to_db(fa, str(tmp_path / "ref.meryl"), 11,
                                  chunk_len=1024, memory_gb=20e-6)
    _assert_same(db, ref)


def test_count_memory_one_batch_uses_plan_chunk(fasta, tmp_path,
                                                monkeypatch):
    """A memory= that one batch satisfies counts unbatched, with the
    plan's chunk size; a count-suffix never takes the batched path."""
    fa, seqs = fasta
    monkeypatch.setenv("MERYL_TPU_HBM_GB", "0.004")  # plan chunk 2^16
    seen = []
    real = counter.count_to_arrays
    monkeypatch.setattr(counter, "count_to_arrays", lambda *a, **kw: (
        seen.append(kw["chunk_len"]) or real(*a, **kw)))
    monkeypatch.setattr(counter, "count_to_db_batched", None)
    db = counter.count_to_db(fa, str(tmp_path / "o.meryl"), 11,
                             memory_gb=64, device="cpu")
    _assert_oracle(db, seqs, 11)
    counter.count_to_db(fa, str(tmp_path / "s.meryl"), 11, memory_gb=20e-6,
                        count_suffix="AC", chunk_len=1 << 12, device="cpu")
    assert seen == [1 << 16, 1 << 12]


@pytest.mark.parametrize("env,value", [("MERYL_TPU_SHARDED", "1"),
                                       ("MERYL_TPU_COORD", "host:1234")])
def test_multi_device_requests_count_like_one_device(fasta, tmp_path,
                                                     monkeypatch, env, value):
    """What meryl_tpu runs on several devices runs in the port and counts
    what one device counts: MERYL_TPU_SHARDED=1 on the sharded path in this
    process (count_to_arrays, count_to_db, and the sharded memory= branch
    that spills to disk), a MERYL_TPU_COORD job of 2 gloo ranks through
    count_to_db.  A job of one process is a local count."""
    from tests import torch_dist
    fa, seqs = fasta
    want = counter.count_to_arrays([fa], 11, device="cpu")
    monkeypatch.setenv("MERYL_TPU_SHARD_CHUNK", "1024")
    if env == "MERYL_TPU_SHARDED":
        monkeypatch.setenv(env, value)
        got = counter.count_to_arrays([fa], 11, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for mem in (None, 1e-6):
            db = counter.count_to_db([fa], str(tmp_path / f"x{mem}"), 11,
                                     memory_gb=mem, device="cpu")
            _assert_oracle(db, seqs, 11)
    else:
        out = str(tmp_path / "job.meryl")
        torch_dist.run_ranks(2, torch_dist.count_db_rank,
                             ({"MERYL_TPU_CHUNK": "1024"}, [fa], out, 11),
                             tmp_path)
        _assert_oracle(MerylDB.open(out), seqs, 11)
        monkeypatch.setenv(env, value)
        monkeypatch.setenv("MERYL_TPU_NPROCS", "1")
        got = counter.count_to_arrays([fa], 11, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
