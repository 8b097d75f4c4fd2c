"""meryl_tpu_torch's multi-process counting: the launcher starts a real
job of gloo ranks (one process each) driving the CLI, and the assembled
DB must decode equal to the port's single-device count and to the
reference's MERYL_TPU_SHARDED=1 count (8 virtual devices in this
process).  Also: the keep-alive pad on an uneven split, stale parts
directories, the sharded memory= branch that spills to disk, the
launcher's refusals and its ending of the other ranks, and the port's
dryrun_multichip at 1 and 2 ranks."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from meryl_tpu import cli as ref_cli
from meryl_tpu import counter as ref_counter
from meryl_tpu.db import MerylDB as RefDB
from meryl_tpu_torch import counter
from meryl_tpu_torch.db import MerylDB
from meryl_tpu_torch.parallel import dryrun, launch, multihost
from meryl_tpu_torch.parallel import shard_count as sc
from tests import torch_dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def _write_reads(path, rng, n_reads=10, length=400):
    with open(path, "w") as f:
        for i in range(n_reads):
            seq = "".join("ACGT"[b] for b in rng.integers(0, 4, size=length))
            if i % 3 == 0:  # N runs exercise the breakers
                seq = seq[:50] + "NNN" + seq[53:]
            f.write(f">r{i}\n{seq}\n")


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=REPO, **kw)
    for key in ("MERYL_TPU_COORD", "MERYL_TPU_SHARDED",
                "MERYL_TPU_SHARD_ACC_CAP", "MERYL_TPU_MH_DEBUG"):
        if key not in kw:
            env.pop(key, None)
    return env


def _launch(nprocs, argv, env):
    return subprocess.run(
        [sys.executable, "-m", "meryl_tpu_torch.parallel.launch",
         "--nprocs", str(nprocs), "--"] + argv + ["device=cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("nprocs", [2, 3])
def test_launcher_count_matches_single_and_reference(tmp_path, monkeypatch,
                                                     nprocs):
    rng = np.random.default_rng(42)
    fa = str(tmp_path / "reads.fa")
    _write_reads(fa, rng)
    db_mh = str(tmp_path / "mh.meryl")
    r = _launch(nprocs, ["count", "k=21", fa, "output", db_mh],
                _env(MERYL_TPU_CHUNK="512"))
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    assert not os.path.exists(db_mh + multihost.PART_DIR_SUFFIX)

    monkeypatch.setenv("MERYL_TPU_CHUNK", "512")
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    one = counter.count_to_arrays([fa], 21, device="cpu")
    monkeypatch.setenv("MERYL_TPU_SHARDED", "1")
    db_ref = str(tmp_path / "ref.meryl")
    assert ref_cli.main(["count", "k=21", fa, "output", db_ref]) == 0

    got = MerylDB.open(db_mh)
    assert _same(got.load_all(), one)
    assert _same(got.load_all(), RefDB.open(db_ref).load_all())
    assert got.stats() == RefDB.open(db_ref).stats()
    assert _same(got.histogram(), RefDB.open(db_ref).histogram())


def test_uneven_input_keepalive(tmp_path, monkeypatch):
    """One rank's sequence-modulo segment is EMPTY (one long sequence,
    2 ranks): the keep-alive pad steps carry the collectives.  The debug
    files show the split really was uneven."""
    rng = np.random.default_rng(7)
    fa = str(tmp_path / "one_seq.fa")
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, size=6000))
    with open(fa, "w") as f:
        f.write(f">only\n{seq}\n")
    db_mh = str(tmp_path / "mh.meryl")
    dbg = str(tmp_path / "mhdebug")
    r = _launch(2, ["count", "k=21", fa, "output", db_mh],
                _env(MERYL_TPU_CHUNK="512", MERYL_TPU_MH_DEBUG=dbg))
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    reads = {}
    for fn in os.listdir(dbg):
        with open(os.path.join(dbg, fn)) as f:
            j = json.load(f)
        reads[j["proc"]] = j["read_bases"]
    assert set(reads) == {0, 1}, reads
    assert reads[0] >= len(seq) and reads[1] == 0
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    assert _same(MerylDB.open(db_mh).load_all(),
                 counter.count_to_arrays([fa], 21, device="cpu"))


def test_coord_job_counts_like_one_device(tmp_path, monkeypatch):
    """count_to_db in each rank of a MERYL_TPU_COORD job (the library
    entry, no CLI) gives the single-device DB."""
    rng = np.random.default_rng(3)
    fa = str(tmp_path / "reads.fa")
    _write_reads(fa, rng, n_reads=12)
    out = str(tmp_path / "job.meryl")
    torch_dist.run_ranks(2, torch_dist.count_db_rank,
                         ({"MERYL_TPU_CHUNK": "1024"}, [fa], out, 15),
                         tmp_path)
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    assert _same(MerylDB.open(out).load_all(),
                 counter.count_to_arrays([fa], 15, device="cpu"))


def test_stale_parts_dir_is_refused(tmp_path):
    """write_parts clears an earlier run's parts directory; assemble_db
    refuses one written by a job of another size, or missing a rank."""
    k = 13
    parts = [(0, np.zeros(2, np.uint64), np.array([3, 9], np.uint64),
              np.array([1, 2], np.uint32))]
    out = str(tmp_path / "x.meryl")
    pdir = out + multihost.PART_DIR_SUFFIX
    os.makedirs(pdir)
    with open(os.path.join(pdir, "proc7.json"), "w") as f:
        json.dump({"k": k, "nprocs": 8, "parts": []}, f)
    with sc.one_rank_group("cpu"):
        multihost.write_parts(out, k, parts)
        assert sorted(os.listdir(pdir)) == ["part_r00000.npz", "proc0.json"]
        with open(os.path.join(pdir, "proc1.json"), "w") as f:
            json.dump({"k": k, "nprocs": 2, "parts": []}, f)
        with pytest.raises(RuntimeError, match="stale parts dir"):
            multihost.assemble_db(out, k)
        os.remove(os.path.join(pdir, "proc1.json"))
        os.remove(os.path.join(pdir, "proc0.json"))
        with pytest.raises(RuntimeError, match="0 proc manifests"):
            multihost.assemble_db(out, k)
        multihost.write_parts(out, k, parts)
        db = multihost.assemble_db(out, k)
    assert not os.path.exists(pdir)
    _, lo, c = db.load_all()
    assert lo.tolist() == [3, 9] and c.tolist() == [1, 2]


def test_sharded_memory_branch_spills_to_disk(tmp_path, monkeypatch):
    """MERYL_TPU_SHARDED=1 with a memory= the plan splits: the sharded
    count spills its accumulator to `<out>.spills`, streams the owner
    range into the DB and removes the spills; the DB equals the
    single-device count and the reference's own sharded memory= DB."""
    rng = np.random.default_rng(11)
    fa = str(tmp_path / "reads.fa")
    _write_reads(fa, rng, n_reads=40, length=500)
    monkeypatch.setenv("MERYL_TPU_SHARD_CHUNK", "1024")
    monkeypatch.setenv("MERYL_TPU_CHUNK", "1024")
    monkeypatch.setenv("MERYL_TPU_SHARD_ACC_CAP", "4096")
    monkeypatch.setenv("MERYL_TPU_SHARDED", "1")
    out = str(tmp_path / "s.meryl")
    seen = []
    real = sc.ShardedCounter._store_run
    monkeypatch.setattr(sc.ShardedCounter, "_store_run", lambda self, d, run: (
        seen.append(self.spill_dir) or real(self, d, run)))
    db = counter.count_to_db(fa, out, 13, memory_gb=1e-6, device="cpu")
    assert sc.LAST_SHARD_STATS["spills"] > 0
    assert set(seen) == {os.path.join(out + ".spills", "m0")}
    assert not os.path.exists(out + ".spills")
    ref_out = str(tmp_path / "ref.meryl")
    ref_counter.count_to_db(fa, ref_out, 13, memory_gb=1e-6)
    assert _same(db.load_all(), RefDB.open(ref_out).load_all())
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    assert _same(db.load_all(), counter.count_to_arrays(fa, 13, device="cpu"))


def test_launcher_refusals(tmp_path, monkeypatch, capsys):
    argv = ["count", "k=21", "x.fa", "output", str(tmp_path / "o.meryl")]
    # cuda (the default): no more ranks than cards, never gloo instead
    assert launch.main(["--nprocs", "2", "--"] + argv) == 2
    assert "0 CUDA device(s)" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert launch.main(["--nprocs", "2", "--"] + argv
                       + ["device=cuda"]) == 2
    assert "1 CUDA device(s)" in capsys.readouterr().err
    # P * D past the cards is refused alike, with no gloo or CPU instead
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert launch.main(["--nprocs", "1", "--devices-per-proc", "5",
                        "--"] + argv) == 2
    assert "4 CUDA device(s)" in capsys.readouterr().err
    assert launch.main(["--nprocs", "2", "--devices-per-proc", "4",
                        "--"] + argv + ["device=cuda"]) == 2
    err = capsys.readouterr().err
    assert "4 CUDA device(s)" in err and "8 devices" in err
    assert launch.main(["--bogus", "--"] + argv) == 2
    assert not os.path.exists(str(tmp_path / "o.meryl"))
    # MERYL_TPU_LOCAL_DEVICES in a job: D CPU members a process
    monkeypatch.setenv("MERYL_TPU_COORD", "127.0.0.1:1")
    monkeypatch.setenv("MERYL_TPU_NPROCS", "1")
    monkeypatch.setenv("MERYL_TPU_PROCID", "0")
    monkeypatch.setenv("MERYL_TPU_LOCAL_DEVICES", "4")
    assert multihost.init_from_env("cpu") == (0, 1)
    assert multihost.local_devices("cpu") == [torch.device("cpu")] * 4


def test_launcher_ends_the_other_ranks():
    """A rank that exits non-zero ends the rest (they would wait in a
    collective): the launcher's wait returns its code at once."""
    import time
    sleeper = subprocess.Popen([sys.executable, "-c",
                                "import time; time.sleep(120)"])
    failer = subprocess.Popen([sys.executable, "-c",
                               "import sys; sys.exit(3)"])
    t0 = time.monotonic()
    assert launch._wait_all([sleeper, failer]) == 3
    assert time.monotonic() - t0 < 60
    assert sleeper.poll() is not None


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip_walks_every_hatch(n, monkeypatch):
    """The dryrun's job form: a 1-rank group in this process, or a
    launcher job of 2 ranks (tests/test_torch_local_shard.py runs the
    in-process form)."""
    monkeypatch.delenv("MERYL_TPU_SHARDED", raising=False)
    stats = dryrun.dryrun_multichip(n, "cpu", job=True)
    assert stats["spills"] > 0 and stats["recount_chunks"] > 0 \
        and stats["captured_windows"] > 0
    assert "MERYL_TPU_SHARD_ACC_CAP" not in os.environ
