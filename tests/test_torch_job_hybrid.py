"""meryl_tpu_torch's jobs of several-device processes: a JobGroup
(parallel/local_group.py) of D threads in each of P gloo processes, held
against torch.distributed's semantics and the reference's mesh of P * D
virtual CPU devices (conftest.py), bit for bit.

Held equal: the two-level collectives' results at P x D = 1x3, 2x2,
2x3 (with a failing member and a failing leader); each owner's
finalized parts of every scenario of tests/torch_shard_cases.py at 2x2
and 2x4 against the reference's mesh; the DB, its stats and its
histogram of `launch --nprocs P --devices-per-proc D -- count` at (2, 4)
and (4, 2) against the reference's single count; the keep-alive at 2x2
with one process reading nothing; the sharded memory= branch in a 2x2
job (a spill directory a member); `--nprocs 1 --devices-per-proc 4`;
the dryrun's job form with D = 2.  Every spawn runs under a timeout."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from meryl_tpu import cli as ref_cli
from meryl_tpu.db import MerylDB as RefDB
from meryl_tpu_torch import cli, counter
from meryl_tpu_torch.db import MerylDB
from meryl_tpu_torch.parallel import dryrun, local_group, multihost
from meryl_tpu_torch.parallel import shard_count as sc
from tests import torch_dist
from tests import torch_shard_cases as cases
from tests.test_torch_shard_count import _port, assert_matches_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300

ENV = ("MERYL_TPU_SHARDED", "MERYL_TPU_LOCAL_DEVICES", "MERYL_TPU_COORD",
       "MERYL_TPU_NPROCS", "MERYL_TPU_PROCID", "MERYL_TPU_SHARD_CHUNK",
       "MERYL_TPU_SHARD_ACC_CAP", "MERYL_TPU_CHUNK", "MERYL_TPU_MH_DEBUG")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=REPO, **kw)
    for key in ENV:
        if key not in kw:
            env.pop(key, None)
    return env


def _launch(nprocs, per, argv, env):
    return subprocess.run(
        [sys.executable, "-m", "meryl_tpu_torch.parallel.launch",
         "--nprocs", str(nprocs), "--devices-per-proc", str(per), "--"]
        + argv + ["device=cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)


def _write_reads(path, rng, n_reads=10, length=400):
    with open(path, "w") as f:
        for i in range(n_reads):
            seq = "".join("ACGT"[b] for b in rng.integers(0, 4, size=length))
            if i % 3 == 0:  # N runs exercise the breakers
                seq = seq[:50] + "NNN" + seq[53:]
            f.write(f">r{i}\n{seq}\n")


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _ref_single(monkeypatch, fa, k, db):
    """The reference's single-device CLI count."""
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    monkeypatch.setenv("MERYL_TPU_CHUNK", "512")
    assert ref_cli.main(["count", f"k={k}", fa, "output", db]) == 0
    monkeypatch.delenv("MERYL_TPU_SHARDED")
    monkeypatch.delenv("MERYL_TPU_CHUNK")
    return RefDB.open(db)


def _same_db(got, want):
    _same(got.load_all(), want.load_all())
    assert got.stats() == want.stats()
    _same(got.histogram(), want.histogram())


# --------------------------------------------- the two-level collectives

@pytest.mark.parametrize("P,D", [(1, 3), (2, 2), (2, 3)])
def test_collectives_have_the_distributed_semantics(tmp_path, P, D):
    torch_dist.run_ranks(P, torch_dist.job_collectives_rank,
                         (D, str(tmp_path)), tmp_path, timeout=120)
    n = P * D
    base = np.arange(2 * n * 3).reshape(2 * n, 3)
    for p in range(P):
        z = np.load(tmp_path / f"p{p}.npz")
        for g in range(p * D, (p + 1) * D):
            assert int(z[f"size{g}"]) == n
            # block s of member g's output: rows [2g, 2g + 2) of member s
            want = np.concatenate([base[2 * g:2 * g + 2] + 1000 * s
                                   for s in range(n)])
            np.testing.assert_array_equal(z[f"out{g}"], want)
            tot = sum(range(n))
            assert z[f"red{g}"].tolist() == [[tot, -tot, 7 * n],
                                             [n - 1, 0, 7], [0, 1 - n, 7]]
            assert z[f"got{g}"][:, 0, 0].tolist() == list(range(n))
        with open(tmp_path / f"p{p}.json") as f:
            fails = json.load(f)
        # each process re-raises its own failing member's exception, at
        # once, and its group (and the job's) runs again afterwards
        assert fails["member"] == f"member {p * D + D - 1} fails"
        assert fails["leader"] == f"leader {p * D} fails"
        assert fails["member_s"] < 10 and fails["leader_s"] < 10
        assert fails["again"] == [float(n)] * D


def test_job_group_refuses_a_missing_or_wrong_group():
    with pytest.raises(RuntimeError, match="process group"):
        local_group.JobGroup(["cpu"] * 2)
    with sc.one_rank_group("cpu"):
        with pytest.raises(RuntimeError, match="is_available"):
            local_group.JobGroup(["cuda"] * 2)  # never gloo instead


def test_leader_budget_counts_its_exchange_buffers(monkeypatch):
    """Four members of a 1-process job on one device split its budget
    after the leader's send and receive buffers (2 x D cell grids)."""
    monkeypatch.setenv("MERYL_TPU_ACC_CAP_GB", "1")
    g = sc.plan_shard_route(1024, 21, 4)
    grids = 8 * g["B"] * g["Wc"] * 8
    staged = sc.ShardedCounter.MERGE_EVERY * g["B"] * g["Wc"]
    with sc.one_rank_group("cpu"):
        group = local_group.JobGroup(["cpu"] * 4)
        caps = group.run(lambda m: sc.ShardedCounter(
            21, chunk_len=1024, group=m).acc_cap)
    assert [m.exchange_grids for m in group.members] == [8] * 4
    assert caps == [((10 ** 9 - grids) // 4 // counter.acc_bytes_per_unique(
        21) - staged) // 2] * 4


# ------------------------------------------- against the reference's mesh

@pytest.fixture(scope="module")
def job_runs(tmp_path_factory):
    """{(P, D): out_dir} of the port's jobs, each spawned once."""
    runs = {}

    def get(P, D):
        if (P, D) not in runs:
            out = tmp_path_factory.mktemp(f"job_{P}x{D}")
            torch_dist.run_ranks(P, cases.job_scenarios,
                                 (D, str(out), list(cases.SCENARIOS)),
                                 out)
            runs[P, D] = str(out)
        return runs[P, D]
    return get


@pytest.mark.parametrize("P,D", [(2, 2), (2, 4)])
@pytest.mark.parametrize("name", list(cases.SCENARIOS))
def test_job_group_matches_reference_mesh(job_runs, tmp_path, name, P, D):
    assert_matches_reference(_port(job_runs(P, D), name, P * D), name,
                             P * D, tmp_path)


# ----------------------------------------------------- launcher jobs

@pytest.mark.parametrize("P,D", [(2, 4), (4, 2)])
def test_launcher_count_matches_reference(tmp_path, monkeypatch, P, D):
    rng = np.random.default_rng(42)
    fa = str(tmp_path / "reads.fa")
    _write_reads(fa, rng)
    db = str(tmp_path / "mh.meryl")
    r = _launch(P, D, ["count", "k=21", fa, "output", db],
                _env(MERYL_TPU_CHUNK="512"))
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    assert not os.path.exists(db + multihost.PART_DIR_SUFFIX)
    _same_db(MerylDB.open(db),
             _ref_single(monkeypatch, fa, 21, str(tmp_path / "ref.meryl")))


def test_uneven_input_keepalive(tmp_path, monkeypatch):
    """One process's sequence-modulo segment is EMPTY (one long
    sequence, 2 processes of 2 members): its members feed only the
    keep-alive pad, and the debug files show the split."""
    rng = np.random.default_rng(7)
    fa = str(tmp_path / "one_seq.fa")
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, size=6000))
    with open(fa, "w") as f:
        f.write(f">only\n{seq}\n")
    db = str(tmp_path / "mh.meryl")
    dbg = str(tmp_path / "mhdebug")
    r = _launch(2, 2, ["count", "k=21", fa, "output", db],
                _env(MERYL_TPU_CHUNK="512", MERYL_TPU_MH_DEBUG=dbg))
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    procs = {}
    for fn in os.listdir(dbg):
        with open(os.path.join(dbg, fn)) as f:
            j = json.load(f)
        procs[j["proc"]] = j
    assert set(procs) == {0, 1}, procs
    assert procs[0]["read_bases"] >= len(seq) and procs[1]["read_bases"] == 0
    # both processes stepped alike: 12 chunks of process 0, 2 a step
    assert procs[0]["shard_stats"]["steps"] == \
        procs[1]["shard_stats"]["steps"] >= 6
    _same(MerylDB.open(db).load_all(), _ref_single(
        monkeypatch, fa, 21, str(tmp_path / "ref.meryl")).load_all())


def test_sharded_memory_branch_in_a_job(tmp_path, monkeypatch):
    """memory= that the plan splits, in a 2 x 2 job: every member spills
    its accumulator to a directory of its own under `<out>.spills`, which
    is gone after; the DB equals the reference's single count."""
    rng = np.random.default_rng(11)
    fa = str(tmp_path / "reads.fa")
    _write_reads(fa, rng, n_reads=40, length=500)
    out = str(tmp_path / "s.meryl")
    rec = tmp_path / "rec"
    rec.mkdir()
    torch_dist.run_ranks(
        2, torch_dist.count_db_rank,
        ({"MERYL_TPU_CHUNK": "1024", "MERYL_TPU_SHARD_ACC_CAP": "2048",
          "MERYL_TPU_LOCAL_DEVICES": "2"}, [fa], out, 13, 1e-6, str(rec)),
        tmp_path)
    seen = []
    for p in range(2):
        with open(rec / f"rank{p}.json") as f:
            j = json.load(f)
        assert j["stats"]["spills"] > 0
        seen += j["spill_dirs"]
    assert sorted(seen) == [os.path.join(out + ".spills", f"m{g}")
                            for g in range(4)]
    assert not os.path.exists(out + ".spills")
    assert not os.path.exists(out + multihost.PART_DIR_SUFFIX)
    _same_db(MerylDB.open(out), _ref_single(
        monkeypatch, fa, 13, str(tmp_path / "ref.meryl")))


def test_one_process_of_four_devices(tmp_path, monkeypatch):
    """`--nprocs 1 --devices-per-proc 4` is no multihost job (as in the
    reference): its sharded count runs a JobGroup of 4 members over a
    1-rank group, and the DB equals the reference's
    MERYL_TPU_LOCAL_DEVICES=4 count."""
    rng = np.random.default_rng(5)
    fa = str(tmp_path / "reads.fa")
    _write_reads(fa, rng, n_reads=12)
    db = str(tmp_path / "job.meryl")
    r = _launch(1, 4, ["count", "k=21", fa, "output", db],
                _env(MERYL_TPU_SHARDED="1", MERYL_TPU_SHARD_CHUNK="512"))
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    monkeypatch.setenv("MERYL_TPU_LOCAL_DEVICES", "4")
    want = _ref_single(monkeypatch, fa, 21, str(tmp_path / "ref.meryl"))
    _same_db(MerylDB.open(db), want)

    # the same job's process in this one: the group it counts over
    groups = []
    real = local_group.JobGroup.__init__

    def init(self, devices):
        real(self, devices)
        groups.append((len(self.members), self.size, self.nprocs))
    monkeypatch.setattr(local_group.JobGroup, "__init__", init)
    for key, val in (("MERYL_TPU_COORD", "127.0.0.1:1"),
                     ("MERYL_TPU_NPROCS", "1"), ("MERYL_TPU_PROCID", "0"),
                     ("MERYL_TPU_SHARDED", "1"),
                     ("MERYL_TPU_SHARD_CHUNK", "512")):
        monkeypatch.setenv(key, val)
    db2 = str(tmp_path / "inproc.meryl")
    assert cli.main(["count", "k=21", fa, "output", db2,
                     "device=cpu"]) == 0
    assert groups == [(4, 4, 1)]
    assert sc.LAST_SHARD_STATS["steps"] >= 2
    _same_db(MerylDB.open(db2), want)

    # its sharded memory= branch: a spill directory a member, removed
    monkeypatch.setenv("MERYL_TPU_SHARD_ACC_CAP", "1024")
    monkeypatch.setenv("MERYL_TPU_CHUNK", "512")
    seen = set()
    real_store = sc.ShardedCounter._store_run
    monkeypatch.setattr(sc.ShardedCounter, "_store_run", lambda self, d, run: (
        seen.add(self.spill_dir) or real_store(self, d, run)))
    db3 = str(tmp_path / "mem.meryl")
    assert cli.main(["count", "k=21", "memory=0.000001", fa, "output", db3,
                     "device=cpu"]) == 0
    assert groups[-1] == (4, 4, 1) and sc.LAST_SHARD_STATS["spills"] > 0
    assert seen == {os.path.join(db3 + ".spills", f"m{g}") for g in range(4)}
    assert not os.path.exists(db3 + ".spills")
    _same_db(MerylDB.open(db3), want)


def test_auto_shards_a_job_process_of_several_cards(monkeypatch):
    """auto in a launcher job: on for cuda when the process has more
    than one device (MERYL_TPU_LOCAL_DEVICES), off at one.  Only the
    decision: nothing runs on cuda."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("MERYL_TPU_COORD", "127.0.0.1:1")
    assert not counter._use_sharded(None, "cuda")
    monkeypatch.setenv("MERYL_TPU_LOCAL_DEVICES", "2")
    assert counter._use_sharded(None, "cuda")
    assert not counter._use_sharded(None, "cpu")
    monkeypatch.setenv("MERYL_TPU_PROCID", "1")
    assert multihost.local_devices("cuda") == [torch.device("cuda", 2),
                                               torch.device("cuda", 3)]
    monkeypatch.setenv("MERYL_TPU_LOCAL_DEVICES", "3")
    with pytest.raises(ValueError, match="sees 4 CUDA"):
        multihost.local_devices("cuda")


def test_dryrun_job_form_with_two_devices_a_process():
    t0 = time.monotonic()
    stats = dryrun.dryrun_multichip(2, "cpu", job=True, devices_per_proc=2)
    assert stats["spills"] > 0 and stats["recount_chunks"] > 0 \
        and stats["captured_windows"] > 0
    assert time.monotonic() - t0 < TIMEOUT
    assert "MERYL_TPU_LOCAL_DEVICES" not in os.environ
