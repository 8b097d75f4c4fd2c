"""meryl_tpu_torch's sharded counting on several devices of ONE process
(parallel/local_group.py, one thread a member) against meryl_tpu's
in-process mesh, bit for bit.

The reference runs on jax.devices()[:n], the suite's virtual CPU devices
(conftest.py); the port on ["cpu"] * n members, n in 1, 2, 4 and 8.
Held equal: each owner's finalized (hi, lo, counts) of the scenarios of
tests/torch_shard_cases.py; count_to_arrays_sharded(devices=) against
the reference's count_to_arrays_sharded(mesh=) on files made from those
scenarios; LAST_SHARD_STATS (spills and steps of one member, captured
windows and recounted chunks summed over the members); the CLI's DB
with MERYL_TPU_SHARDED=1 MERYL_TPU_LOCAL_DEVICES=8, also on the memory=
branch that spills to disk.  Also: the group's collectives, a failing
member ending the group at once, the merge buffers under threads, the
auto decision and the in-process dryrun."""

import os
import sys
import threading
import time
from datetime import timedelta

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from meryl_tpu import cli as ref_cli
from meryl_tpu import counter as ref_counter
from meryl_tpu.db import MerylDB as RefDB
from meryl_tpu.parallel import shard_count as ref_sc
from meryl_tpu_torch import cli, counter
from meryl_tpu_torch.db import MerylDB
from meryl_tpu_torch.parallel import dryrun, local_group
from meryl_tpu_torch.parallel import shard_count as sc
from tests import torch_shard_cases as cases

NS = (1, 2, 4, 8)
TIMEOUT_S = 60  # a rendezvous of these tests' groups

ENV = ("MERYL_TPU_SHARDED", "MERYL_TPU_LOCAL_DEVICES", "MERYL_TPU_COORD",
       "MERYL_TPU_SHARD_CHUNK", "MERYL_TPU_SHARD_ACC_CAP", "MERYL_TPU_CHUNK")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setattr(local_group, "GROUP_TIMEOUT",
                        timedelta(seconds=TIMEOUT_S))
    for key in ENV:
        monkeypatch.delenv(key, raising=False)


def _members_alive():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("meryl-member-")]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("d",))


def _hatches(stats, n):
    """LAST_SHARD_STATS' hatch counters (the reference's keys), after
    checking the port's own two: n members, and peer_bytes, zero only
    when one member sends nothing to another."""
    assert stats["members"] == n
    assert (stats["peer_bytes"] > 0) == (n > 1 and stats["steps"] > 0)
    return {key: v for key, v in stats.items()
            if key not in ("members", "peer_bytes")}


# ------------------------------------------------- the group's collectives

@pytest.mark.parametrize("n", [1, 3, 4])
def test_collectives_have_the_distributed_semantics(n):
    group = local_group.LocalGroup(["cpu"] * n)

    def body(m):
        r = m.rank
        inp = torch.arange(2 * n * 3, dtype=torch.int64).reshape(2 * n, 3) \
            + 1000 * r
        out = torch.empty_like(inp)
        m.all_to_all_single(out, inp)
        red = {op: torch.tensor([r, -r, 7], dtype=torch.int64)
               for op in (local_group.SUM, local_group.MAX, local_group.MIN)}
        for op, t in red.items():
            m.all_reduce(t, op)
        got = [torch.zeros((2, 2), dtype=torch.int64) for _ in range(n)]
        m.all_gather(got, torch.full((2, 2), r, dtype=torch.int64))
        m.barrier()
        return out, red, got

    for r, (out, red, got) in enumerate(group.run(body)):
        # block s of member r's output: rows [2r, 2r + 2) of member s
        want = torch.cat([torch.arange(2 * n * 3).reshape(2 * n, 3)
                          [2 * r:2 * r + 2] + 1000 * s for s in range(n)])
        assert torch.equal(out, want)
        tot = sum(range(n))
        assert red[local_group.SUM].tolist() == [tot, -tot, 7 * n]
        assert red[local_group.MAX].tolist() == [n - 1, 0, 7]
        assert red[local_group.MIN].tolist() == [0, 1 - n, 7]
        assert [g[0, 0].item() for g in got] == list(range(n))
    assert not _members_alive()


def test_collectives_under_thread_stress():
    """More members than cores and a tiny switch interval: every round's
    all_reduce and all_to_all see every member's tensor of that round
    and no other (a buffer reused too early would break the sums)."""
    n, rounds = 16, 120
    group = local_group.LocalGroup(["cpu"] * n)

    def body(m):
        bad = 0
        for i in range(rounds):
            t = torch.tensor([m.rank + i], dtype=torch.int64)
            m.all_reduce(t, local_group.SUM)
            bad += int(t.item() != sum(range(n)) + n * i)
            inp = torch.full((n,), m.rank * rounds + i, dtype=torch.int64)
            out = torch.empty_like(inp)
            m.all_to_all_single(out, inp)
            bad += int(out.tolist() != [s * rounds + i for s in range(n)])
        return bad

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t0 = time.monotonic()
    try:
        assert group.run(body) == [0] * n
    finally:
        sys.setswitchinterval(old)
    assert time.monotonic() - t0 < TIMEOUT_S
    assert not _members_alive()


def test_failing_member_ends_the_group_at_once():
    group = local_group.LocalGroup(["cpu"] * 4)

    def body(m):
        for i in range(10 ** 6):
            if m.rank == 2 and i == 3:
                raise ValueError("member 2 fails")
            m.all_reduce(torch.ones(1), local_group.SUM)

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="member 2 fails"):
        group.run(body)
    assert time.monotonic() - t0 < 10
    assert not _members_alive()
    # the group is whole again afterwards
    assert group.run(lambda m: m.rank) == [0, 1, 2, 3]


def test_failing_member_fails_the_count(tmp_path, monkeypatch):
    """A member that raises mid-count ends the count with its exception
    within seconds: no member thread and no reader thread is left."""
    fa = str(tmp_path / "reads.fa")
    rng = np.random.default_rng(5)
    with open(fa, "w") as f:
        for i in range(60):
            f.write(f">r{i}\n" + "".join(
                "ACGT"[b] for b in rng.integers(0, 4, 600)) + "\n")
    real = sc.ShardedCounter.add_codes

    def add_codes(self, codes):
        if self.rank == 1 and self.stats["steps"] == 2:
            raise OSError("member 1 lost its device")
        real(self, codes)
    monkeypatch.setattr(sc.ShardedCounter, "add_codes", add_codes)
    before = threading.active_count()
    t0 = time.monotonic()
    with pytest.raises(OSError, match="member 1 lost"):
        counter.count_to_arrays_sharded([fa], 21, chunk_len=512,
                                        devices=["cpu"] * 4)
    assert time.monotonic() - t0 < 10
    assert not _members_alive()
    assert threading.active_count() <= before


def test_merge_buffers_are_per_thread():
    """The members merge on threads of their own at once (finalize, the
    hatch extras): each thread's merge has its own staging buffers."""

    def runs(seed):
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(3):
            lo = np.unique(rng.integers(0, 1 << 40, 20000,
                                        dtype=np.uint64))
            out.append((np.zeros(len(lo), np.uint64), lo,
                        rng.integers(1, 9, len(lo)).astype(np.uint64)))
        return out

    inputs = [runs(s) for s in range(8)]
    want = [counter.merge_runs(r) for r in inputs]
    got = [None] * 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, [counter.merge_runs(inputs[i]) for _ in range(4)]))
            for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for w, g in zip(want, got):
        for one in g:
            _same(one, w)


# ------------------------------------- ShardedCounter against the mesh

LOCAL_SCENARIOS = ["k15", "k21_three_steps", "k33", "k16_forward_allones",
                   "separators_empty_shard", "capture", "bad_source",
                   "spill", "spill_dir"]


def _reference(name, n, tmp_path):
    k, mode, chunk, _, acc_cap, spill, _, _ = cases.SCENARIOS[name]
    c = ref_sc.ShardedCounter(
        _mesh(n), k, chunk_len=chunk, mode=mode, acc_cap=acc_cap,
        spill_dir=str(tmp_path / "ref_spills") if spill else None)
    for codes in cases.step_codes(name, n):
        c.add_codes(codes)
    return c.finalize_parts(), dict(c.stats)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", LOCAL_SCENARIOS)
def test_local_group_matches_reference_mesh(tmp_path, name, n):
    group = local_group.LocalGroup(["cpu"] * n)
    out = tmp_path / "port"
    out.mkdir()
    ranks = group.run(lambda m: cases.run_scenario(name, n, m.rank,
                                                   str(out), group=m))
    parts, stats = _reference(name, n, tmp_path)
    assert all(r["error"] is None for r, _ in ranks), ranks
    want = {int(d): (hi, lo, c) for d, hi, lo, c in parts}
    for rank, (res, arrays) in enumerate(ranks):
        assert res["rows"] in ([], [rank])
        if not res["rows"]:
            assert rank not in want or not len(want[rank][2])
            continue
        _same([arrays["hi0"], arrays["lo0"], arrays["c0"]], want[rank])
        assert arrays["c0"].dtype == np.uint32
        assert all("already finalized" in e for e in res["again"])
    member_stats = [r["stats"] for r, _ in ranks]
    for key in ("spills", "steps"):
        assert [s[key] for s in member_stats] == [stats[key]] * n, key
    assert sc.combine_stats(member_stats) == stats
    if name == "spill_dir":
        assert all(r["spill_files"] for r, _ in ranks if r["rows"])
    assert not _members_alive()


# ------------------------------- count_to_arrays_sharded against mesh=

FILE_CASES = ["k15", "k21_three_steps", "k33", "k16_forward_allones",
              "separators_empty_shard", "capture", "bad_source", "spill",
              "spill_dir"]
HATCH = {"capture": "captured_windows", "bad_source": "recount_chunks",
         "spill": "spills", "spill_dir": "spills"}
# where the reference cannot count the scenario's file at the scenario's
# chunk (test_regrow_past_the_merged_width), the parity test counts it
# at this one
FILE_CHUNK = {"k21_three_steps": 1024, "k33": 1024,
              "k16_forward_allones": 1024}


def _fasta_from_scenario(name, path):
    """The scenario's codes for 4 sources as a FASTA: one record a run
    of bases between separators."""
    codes = np.concatenate(cases.step_codes(name, 4))
    text = np.frombuffer(b"ACTG", np.uint8)[np.minimum(codes, 3)]
    recs = [r for r in np.split(text, np.flatnonzero(codes == 255))]
    with open(path, "w") as f:
        for i, r in enumerate(recs):
            seq = r[1:] if i else r   # the separator that opened it
            if len(seq):
                f.write(f">s{i}\n{seq.tobytes().decode()}\n")


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", FILE_CASES)
def test_count_to_arrays_sharded_matches_reference(tmp_path, name, n):
    """The scenario's k, mode and chunk; its tiny acc_cap only where the
    scenario is about spilling (test_spill_then_regrow_in_one_merge says
    why)."""
    k, mode, chunk, _, acc_cap, spill, _, _ = cases.SCENARIOS[name]
    chunk = FILE_CHUNK.get(name, chunk)
    fa = str(tmp_path / "in.fa")
    _fasta_from_scenario(name, fa)
    kw = {"acc_cap": acc_cap if HATCH.get(name) == "spills" else None}
    got = counter.count_to_arrays_sharded(
        [fa], k, mode=mode, chunk_len=chunk, devices=["cpu"] * n,
        spill_dir=str(tmp_path / "port_spills") if spill else None, **kw)
    stats = dict(sc.LAST_SHARD_STATS)
    want = ref_counter.count_to_arrays_sharded(
        [fa], k, mode=mode, chunk_len=chunk, mesh=_mesh(n),
        spill_dir=str(tmp_path / "ref_spills") if spill else None, **kw)
    _same(got, want)
    assert got[2].dtype == np.uint32
    assert _hatches(stats, n) == ref_sc.LAST_SHARD_STATS
    if name in HATCH:
        assert stats[HATCH[name]] > 0
    if spill:  # a member spills into a directory of its own
        made = set(os.listdir(tmp_path / "port_spills"))
        assert made and made <= {f"m{r}" for r in range(n)}
    assert not _members_alive()


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", list(FILE_CHUNK))
def test_regrow_past_the_merged_width(tmp_path, name, n):
    """The scenario's file at its own chunk: at n = 1 a merge's largest
    row outgrows its first room, and the regrown room (rounded up to an
    eighth) is wider than the rows it merges.  The port's count equals
    the single-device count at every n.  The reference's
    count_to_arrays_sharded raises here at n = 1 (its merge_cells slices
    the merged rows past their width, a shape error), so the parity
    test above counts these files at FILE_CHUNK."""
    k, mode, chunk, _, acc_cap, _, _, _ = cases.SCENARIOS[name]
    fa = str(tmp_path / "in.fa")
    _fasta_from_scenario(name, fa)
    got = counter.count_to_arrays_sharded(
        [fa], k, mode=mode, chunk_len=chunk, devices=["cpu"] * n,
        acc_cap=acc_cap)
    _same(got, counter.count_to_arrays([fa], k, mode=mode, device="cpu"))


# ------------------------------------------------------------- the CLI

@pytest.mark.parametrize("words", [[], ["memory=0.000001"]])
def test_cli_eight_members_match_reference_cli(tmp_path, monkeypatch,
                                               words):
    """MERYL_TPU_SHARDED=1 MERYL_TPU_LOCAL_DEVICES=8 count ... device=cpu
    against the reference's MERYL_TPU_SHARDED=1 count on its 8 devices;
    with memory= both take the sharded branch that spills to disk and
    remove <out>.spills."""
    rng = np.random.default_rng(21)
    fa = str(tmp_path / "reads.fa")
    with open(fa, "w") as f:
        f.write(">polyA\n" + "A" * 1400 + "\n")
        for i in range(120):
            s = "".join("ACGT"[b] for b in rng.integers(0, 4, 500))
            if i % 4 == 0:
                s = s[:100] + "NN" + s[102:]
            f.write(f">r{i}\n{s}\n")
    monkeypatch.setenv("MERYL_TPU_SHARDED", "1")
    monkeypatch.setenv("MERYL_TPU_SHARD_CHUNK", "512")
    if words:  # the memory= plan chunks by MERYL_TPU_CHUNK
        monkeypatch.setenv("MERYL_TPU_CHUNK", "512")
        monkeypatch.setenv("MERYL_TPU_SHARD_ACC_CAP", "1200")
    ref = str(tmp_path / "ref.meryl")
    assert ref_cli.main(["count", "k=21", fa, *words, "output", ref]) == 0
    ref_stats = dict(ref_sc.LAST_SHARD_STATS)
    monkeypatch.setenv("MERYL_TPU_LOCAL_DEVICES", "8")
    out = str(tmp_path / "port.meryl")
    assert cli.main(["count", "k=21", fa, *words, "output", out,
                     "device=cpu"]) == 0
    assert _hatches(sc.LAST_SHARD_STATS, 8) == ref_stats
    assert sc.LAST_SHARD_STATS["steps"] >= 1
    assert sc.LAST_SHARD_STATS["recount_chunks"] > 0
    if words:
        assert sc.LAST_SHARD_STATS["spills"] > 0
    got, want = MerylDB.open(out), RefDB.open(ref)
    _same(got.load_all(), want.load_all())
    assert got.stats() == want.stats()
    _same(got.histogram(), want.histogram())
    assert not os.path.exists(out + ".spills")
    assert not _members_alive()


# ------------------------------------------------ the auto decision

def _cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_auto_shards_on_a_multi_gpu_host_only(monkeypatch):
    """auto (unset) is on for cuda with more than one card and no job;
    off at one card, on the CPU, with a count-suffix and in a job.  Only
    the decision: nothing runs on cuda."""
    use = counter._use_sharded
    _cards(monkeypatch, 2)
    assert use(None, "cuda") and use(None, torch.device("cuda"))
    assert not use("ACG", "cuda")
    assert not use(None, "cpu")
    monkeypatch.setenv("MERYL_TPU_SHARDED", "auto")
    assert use(None, "cuda")
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    assert not use(None, "cuda")
    monkeypatch.setenv("MERYL_TPU_SHARDED", "1")
    assert use(None, "cpu") and not use("A", "cpu")
    monkeypatch.delenv("MERYL_TPU_SHARDED")
    monkeypatch.setenv("MERYL_TPU_COORD", "127.0.0.1:1")
    assert not use(None, "cuda")
    monkeypatch.delenv("MERYL_TPU_COORD")
    with sc.one_rank_group("cpu"):  # a group the caller made
        assert not use(None, "cuda")
    assert use(None, "cuda")
    _cards(monkeypatch, 1)
    assert not use(None, "cuda")
    _cards(monkeypatch, 0)
    assert not use(None, "cuda")


def test_shard_devices(monkeypatch):
    assert counter.shard_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setenv("MERYL_TPU_LOCAL_DEVICES", "3")
    assert counter.shard_devices("cpu") == [torch.device("cpu")] * 3
    _cards(monkeypatch, 2)
    with pytest.raises(ValueError, match="MERYL_TPU_LOCAL_DEVICES"):
        counter.shard_devices("cuda")
    monkeypatch.delenv("MERYL_TPU_LOCAL_DEVICES")
    assert counter.shard_devices("cuda") == [torch.device("cuda", 0),
                                             torch.device("cuda", 1)]


def test_members_sharing_a_device_share_its_budget(monkeypatch):
    """Four members on one device split its accumulator budget; the
    counter takes its member's device and refuses another."""
    monkeypatch.setenv("MERYL_TPU_ACC_CAP_GB", "1")
    group = local_group.LocalGroup(["cpu"] * 4)
    caps = group.run(lambda m: sc.ShardedCounter(
        21, chunk_len=1024, group=m).acc_cap)
    c1 = group.members[0]
    g = sc.plan_shard_route(1024, 21, 4)
    staged = sc.ShardedCounter.MERGE_EVERY * g["B"] * g["Wc"]
    assert caps == [(10 ** 9 // 4 // counter.acc_bytes_per_unique(21)
                     - staged) // 2] * 4
    assert c1.share == 4
    with pytest.raises(RuntimeError, match="is_available"):
        sc.ShardedCounter(21, chunk_len=1024, group=c1, device="cuda")


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_in_one_process(n):
    stats = dryrun.dryrun_multichip(n, "cpu")
    assert stats["spills"] > 0 and stats["recount_chunks"] > 0 \
        and stats["captured_windows"] > 0
    assert "MERYL_TPU_LOCAL_DEVICES" not in os.environ
    assert not _members_alive()


def test_dryrun_devices_repeated():
    stats = dryrun.dryrun_devices(["cpu"] * 2)
    assert stats["spills"] > 0 and stats["recount_chunks"] > 0 \
        and stats["captured_windows"] > 0
