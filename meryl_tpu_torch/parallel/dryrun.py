"""Dryrun of multi-GPU counting through the product CLI (counterpart of
__graft_entry__.dryrun_multichip / _dryrun_body).

    python -m meryl_tpu_torch.parallel.dryrun N [cuda|cpu]

`meryl-torch count` runs sharded over N ranks and again on one device,
and the two DBs must decode equal: first on a happy-path input, then on
one that forces the three exactness hatches (a poly-A read overflows
its capture region: the source is masked out of the exchange and its
chunk recounted; a 16-periodic motif overflows cells but not the
capture region: captured windows; a tiny MERYL_TPU_SHARD_ACC_CAP: the
accumulator spills).  The hatch counters (LAST_SHARD_STATS) are summed
over the ranks.  At N = 1 the sharded count runs in this process
(MERYL_TPU_SHARDED=1, a 1-rank group); at N > 1 it runs as a launcher
job of N ranks (parallel/launch.py), one device each: on cuda that
needs N cards.
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


def _count_both(cli, MerylDB, n, device, td, fa, tag, env):
    """Sharded (n ranks) and single-device CLI counts of fa; they must
    decode equal.  -> (uniques, total, hatch stats summed over ranks)."""
    from . import shard_count as sc
    db_s = os.path.join(td, f"sharded_{tag}.meryl")
    db_1 = os.path.join(td, f"single_{tag}.meryl")
    argv = ["count", "k=21", fa, "output", db_s, f"device={device}"]
    if n == 1:
        if _with_env(dict(env, MERYL_TPU_SHARDED="1"),
                     lambda: cli.main(argv)) != 0:
            raise AssertionError(f"sharded CLI count failed ({tag})")
        stats = dict(sc.LAST_SHARD_STATS)
    else:
        # a launcher job: its ranks chunk by MERYL_TPU_CHUNK and write
        # their hatch counters to MERYL_TPU_MH_DEBUG
        from .launch import main as launch
        dbg = os.path.join(td, f"ranks_{tag}")
        renv = dict(env, MERYL_TPU_CHUNK=env["MERYL_TPU_SHARD_CHUNK"],
                    MERYL_TPU_MH_DEBUG=dbg)
        rc = _with_env(renv, lambda: launch(
            ["--nprocs", str(n), "--"] + argv))
        if rc != 0:
            raise AssertionError(f"{n}-rank CLI count exited {rc} ({tag})")
        ranks = []
        for fn in sorted(os.listdir(dbg)):
            with open(os.path.join(dbg, fn)) as f:
                ranks.append(json.load(f)["shard_stats"])
        if len(ranks) != n:
            raise AssertionError(f"{len(ranks)} of {n} ranks reported")
        # spills and steps are equal on every rank; the rest is summed
        stats = {key: (ranks[0][key] if key in ("spills", "steps") else
                       sum(r[key] for r in ranks)) for key in ranks[0]}
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


def _scenarios(cli, MerylDB, n, device):
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
            cli, MerylDB, n, device, td, fa, "happy",
            {"MERYL_TPU_SHARD_CHUNK": str(HAPPY_CHUNK)})

        # scenario 2: the three hatches through the same CLI
        fa2 = os.path.join(td, "hatch.fa")
        with open(fa2, "w") as f:
            f.write(">polyA\n" + "A" * 1400 + "\n")
            f.write(">motif\n" + "ACGTAACTGGTCAGTT" * 80 + "\n")
            # reads scale with the ranks, so that the budget both fits
            # one merge and is outgrown by the uniques
            for i in range(max(16, 4 * n)):
                f.write(f">r{i}\n")
                f.write("".join(bases[b] for b in
                                rng.integers(0, 4, size=700)) + "\n")
        _, _, stats = _count_both(
            cli, MerylDB, n, device, td, fa2, "hatch",
            {"MERYL_TPU_SHARD_CHUNK": str(HATCH_CHUNK),
             "MERYL_TPU_SHARD_ACC_CAP": str(HATCH_ACC_CAP)})
    return n_unique, n_total, stats


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Drive `meryl-torch count` sharded over n_devices ranks against the
    single-device count; -> the hatch scenario's stats (summed over the
    ranks).  Raises when a DB differs or a hatch was not walked."""
    from .. import cli, resolve_device
    from ..db import MerylDB

    dev = resolve_device(device)
    n_unique, n_total, stats = _with_env(
        {"MERYL_TPU_CHUNK": str(SINGLE_CHUNK)},
        lambda: _scenarios(cli, MerylDB, n_devices, device))
    walked = [key for key in ("spills", "recount_chunks",
                              "captured_windows") if stats.get(key)]
    for key, what in (("spills", "spill"), ("recount_chunks",
                                            "mask+recount"),
                      ("captured_windows", "capture")):
        if key not in walked:
            raise AssertionError(f"{what} hatch not exercised: {stats}")
    print(f"dryrun_multichip ok: {n_devices} ranks on {dev.type}, k=21, "
          f"CLI count sharded == single ({n_unique} unique / {n_total} "
          f"total); hatches walked exactly: "
          f"{ {key: stats[key] for key in walked} }")
    return stats


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 1,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
