"""Dryrun of multi-GPU counting through the product CLI (counterpart of
__graft_entry__.dryrun_multichip / _dryrun_body).

    python -m meryl_tpu_torch.parallel.dryrun N [cuda|cpu] [job [D]]

`meryl-torch count` runs sharded over N members and again on one
device, and the two DBs must decode equal: first on a happy-path input,
then on one that forces the three exactness hatches (a poly-A read
overflows its capture region: the source is masked out of the exchange
and its chunk recounted; a 16-periodic motif overflows cells but not
the capture region: captured windows; a tiny MERYL_TPU_SHARD_ACC_CAP:
the accumulator spills).  The hatch counters (LAST_SHARD_STATS) are
summed over the members.

By default the sharded count runs in this process, as the reference's
does (MERYL_TPU_SHARDED=1): on cpu over MERYL_TPU_LOCAL_DEVICES=N
members, on cuda over every visible card (N may not pass their count).
`job` runs it as a launcher job of N processes instead
(parallel/launch.py) with D devices each (default 1; on cuda that needs
N * D cards), or at N = 1 in this process over a 1-rank
torch.distributed group (NCCL on cuda): its rank alone, or D members.
dryrun_devices(devices) runs the same scenarios through
counter.count_to_arrays_sharded(devices=), where devices may repeat;
with job=True through multihost.count_to_db_multihost(devices=) in a
1-rank group: the two-level group of a job's process.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

# the reference's scenario sizes: tiny per-rank chunks, so the input
# spans many steps, and an accumulator budget the hatch input outgrows
HAPPY_CHUNK, HATCH_CHUNK, HATCH_ACC_CAP = 1024, 512, 1200
SINGLE_CHUNK = 256


def _with_env(env, fn):
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


def _cli_count(cli, argv, env, tag):
    if _with_env(env, lambda: cli.main(argv)) != 0:
        raise AssertionError(f"sharded CLI count failed ({tag})")


def _sharded_in_process(cli, n, device):
    """The CLI's sharded count in this process, over n members."""
    from . import shard_count as sc

    def run(fa, db, env, tag):
        env = dict(env, MERYL_TPU_SHARDED="1")
        if device == "cpu":
            env["MERYL_TPU_LOCAL_DEVICES"] = str(n)
        _cli_count(cli, ["count", "k=21", fa, "output", db,
                         f"device={device}"], env, tag)
        return dict(sc.LAST_SHARD_STATS)
    return run


def _sharded_job(cli, n, device, per):
    """The CLI's sharded count as n processes of a torch.distributed
    group with `per` devices each: a 1-rank group in this process, or a
    launcher job."""
    from . import shard_count as sc

    def run(fa, db, env, tag):
        argv = ["count", "k=21", fa, "output", db, f"device={device}"]
        if n == 1:
            with sc.one_rank_group(device):
                _cli_count(cli, argv, dict(
                    env, MERYL_TPU_SHARDED="1",
                    MERYL_TPU_LOCAL_DEVICES=str(per)), tag)
            return dict(sc.LAST_SHARD_STATS)
        # a launcher job: its processes chunk by MERYL_TPU_CHUNK and
        # write their members' hatch counters to MERYL_TPU_MH_DEBUG
        from .launch import main as launch
        dbg = os.path.join(os.path.dirname(db), f"ranks_{tag}")
        renv = dict(env, MERYL_TPU_CHUNK=env["MERYL_TPU_SHARD_CHUNK"],
                    MERYL_TPU_MH_DEBUG=dbg)
        rc = _with_env(renv, lambda: launch(
            ["--nprocs", str(n), "--devices-per-proc", str(per), "--"]
            + argv))
        if rc != 0:
            raise AssertionError(f"{n}-process CLI count exited {rc} "
                                 f"({tag})")
        procs = []
        for fn in sorted(os.listdir(dbg)):
            with open(os.path.join(dbg, fn)) as f:
                procs.append(json.load(f)["shard_stats"])
        if len(procs) != n:
            raise AssertionError(f"{len(procs)} of {n} processes reported")
        return sc.combine_stats(procs)
    return run


def _sharded_job_api(devices):
    """multihost.count_to_db_multihost over `devices` in a 1-rank group
    (the job's chunk is MERYL_TPU_CHUNK)."""
    from . import multihost
    from . import shard_count as sc

    def run(fa, db, env, tag):
        with sc.one_rank_group(devices[0]):
            _with_env(dict(env, MERYL_TPU_CHUNK=env["MERYL_TPU_SHARD_CHUNK"]),
                      lambda: multihost.count_to_db_multihost(
                          [fa], db, 21, device=devices[0], devices=devices))
        return dict(sc.LAST_SHARD_STATS)
    return run


def _sharded_api(devices):
    """count_to_arrays_sharded over `devices`, written as a DB."""
    from .. import counter
    from ..db import MerylDB
    from . import shard_count as sc

    def run(fa, db, env, tag):
        arrays = _with_env(env, lambda: counter.count_to_arrays_sharded(
            [fa], 21, devices=devices))
        MerylDB.write(db, 21, *arrays)
        return dict(sc.LAST_SHARD_STATS)
    return run


def _count_both(cli, MerylDB, sharded, device, td, fa, tag, env):
    """Sharded (`sharded(fa, db, env, tag)` -> its hatch stats) and
    single-device CLI counts of fa; they must decode equal.  ->
    (uniques, total, hatch stats summed over the members)."""
    db_s = os.path.join(td, f"sharded_{tag}.meryl")
    db_1 = os.path.join(td, f"single_{tag}.meryl")
    stats = sharded(fa, db_s, env, tag)
    if _with_env({"MERYL_TPU_SHARDED": "0"}, lambda: cli.main(
            ["count", "k=21", fa, "output", db_1, f"device={device}"])) != 0:
        raise AssertionError(f"single-device CLI count failed ({tag})")
    s = MerylDB.open(db_s).load_all()
    one = MerylDB.open(db_1).load_all()
    if not all(np.array_equal(a, b) for a, b in zip(s, one)):
        raise AssertionError(
            f"sharded CLI count != single-device CLI count ({tag})")
    if not len(s[2]):
        raise AssertionError(f"empty count ({tag})")
    return len(s[2]), int(s[2].sum()), stats


def _scenarios(cli, MerylDB, sharded, n, device):
    """-> (happy uniques, happy total, hatch scenario's stats)."""
    rng = np.random.default_rng(7)
    bases = "ACGT"
    with tempfile.TemporaryDirectory() as td:
        # scenario 1: the happy path at tiny shapes
        fa = os.path.join(td, "reads.fa")
        with open(fa, "w") as f:
            for i in range(6):
                f.write(f">r{i}\n")
                f.write("".join(bases[b] for b in
                                rng.integers(0, 4, size=700)) + "\n")
        n_unique, n_total, _ = _count_both(
            cli, MerylDB, sharded, device, td, fa, "happy",
            {"MERYL_TPU_SHARD_CHUNK": str(HAPPY_CHUNK)})

        # scenario 2: the three hatches through the same CLI
        fa2 = os.path.join(td, "hatch.fa")
        with open(fa2, "w") as f:
            f.write(">polyA\n" + "A" * 1400 + "\n")
            f.write(">motif\n" + "ACGTAACTGGTCAGTT" * 80 + "\n")
            # reads scale with the members, so that the budget both fits
            # one merge and is outgrown by the uniques
            for i in range(max(16, 4 * n)):
                f.write(f">r{i}\n")
                f.write("".join(bases[b] for b in
                                rng.integers(0, 4, size=700)) + "\n")
        _, _, stats = _count_both(
            cli, MerylDB, sharded, device, td, fa2, "hatch",
            {"MERYL_TPU_SHARD_CHUNK": str(HATCH_CHUNK),
             "MERYL_TPU_SHARD_ACC_CAP": str(HATCH_ACC_CAP)})
    return n_unique, n_total, stats


def _walk(sharded, n, device, what):
    from .. import cli
    from ..db import MerylDB

    n_unique, n_total, stats = _with_env(
        {"MERYL_TPU_CHUNK": str(SINGLE_CHUNK)},
        lambda: _scenarios(cli, MerylDB, sharded, n, device))
    walked = [key for key in ("spills", "recount_chunks",
                              "captured_windows") if stats.get(key)]
    for key, name in (("spills", "spill"), ("recount_chunks",
                                            "mask+recount"),
                      ("captured_windows", "capture")):
        if key not in walked:
            raise AssertionError(f"{name} hatch not exercised: {stats}")
    print(f"dryrun_multichip ok: {what}, k=21, sharded == single "
          f"({n_unique} unique / {n_total} total); hatches walked exactly: "
          f"{ {key: stats[key] for key in walked} }")
    return stats


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     job: bool = False, devices_per_proc: int = 1) -> dict:
    """Drive `meryl-torch count` sharded over n_devices members against
    the single-device count; -> the hatch scenario's stats (summed over
    the members).  In this process by default; job=True as n_devices
    processes of a torch.distributed group, each with devices_per_proc
    devices.  Raises when a DB differs or a hatch was not walked."""
    from .. import cli, resolve_device

    dev = resolve_device(device)
    if job:
        per = devices_per_proc
        return _walk(_sharded_job(cli, n_devices, device, per),
                     n_devices * per, device,
                     f"{n_devices} processes x {per} devices of a job on "
                     f"{dev.type}")
    if dev.type == "cuda":
        import torch
        have = torch.cuda.device_count()
        if n_devices > have:
            raise ValueError(f"dryrun_multichip({n_devices}, cuda): this "
                             f"process sees {have} card(s)")
        n_devices = have  # the CLI takes every visible card
    return _walk(_sharded_in_process(cli, n_devices, device), n_devices,
                 device, f"{n_devices} members in one process on "
                 f"{dev.type}")


def dryrun_devices(devices, job: bool = False) -> dict:
    """The dryrun's scenarios through count_to_arrays_sharded over
    `devices` (which may repeat), or with job=True through
    count_to_db_multihost(devices=) in a 1-rank group, against the
    single-device CLI count on the first device's type; -> the hatch
    scenario's stats."""
    import torch
    devs = [torch.device(d) for d in devices]
    what = "count_to_db_multihost in a 1-rank group" if job \
        else "count_to_arrays_sharded"
    return _walk(_sharded_job_api(devs) if job else _sharded_api(devs),
                 len(devs), devs[0].type,
                 f"{len(devs)} members over {sorted({str(d) for d in devs})}"
                 f" through {what}")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 1,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda",
                     job=sys.argv[3:4] == ["job"],
                     devices_per_proc=int(sys.argv[4])
                     if len(sys.argv) > 4 else 1)
