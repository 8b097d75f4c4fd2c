"""Scenarios of the ShardedCounter parity tests (tests/test_shard_count.py
and tests/test_sharded_counter.py mirrored), shared by the JAX reference
in the test process, the port's gloo ranks, which import this module
and no JAX, the port's members of one process (LocalGroup) and the
port's members of a job's processes (JobGroup).

A scenario's input is a list of steps, each the (n * chunk,) uint8 codes
of n sources; source s's chunk is codes[s * chunk:(s + 1) * chunk]."""

import json
import os

import numpy as np

# name: (k, mode, chunk, steps, acc_cap, spill_dir, input kind, seed)
SCENARIOS = {
    "k15": (15, "canonical", 512, 1, None, False, "random", 3),
    "k21_three_steps": (21, "canonical", 256, 3, 8 * 1024, False,
                        "random", 12),
    "k31": (31, "canonical", 256, 1, None, False, "random", 3),
    "k33": (33, "canonical", 256, 2, None, False, "random", 33),
    "k48": (48, "canonical", 192, 1, None, False, "random", 48),
    "k16_polyG": (16, "canonical", 128, 1, None, False, "polyG", 11),
    "k16_forward_allones": (16, "forward", 128, 2, None, False, "polyG",
                            16),
    "k32_forward_allones": (32, "forward", 256, 1, None, False, "polyG",
                            32),
    "k64_forward_allones": (64, "forward", 256, 1, None, False, "polyG",
                            64),
    "separators_empty_shard": (11, "canonical", 256, 1, 4 * 1024, False,
                               "separators", 5),
    "capture": (13, "canonical", 256, 1, None, False, "motif", 0),
    "bad_source": (13, "canonical", 2048, 1, None, False, "polyA", 9),
    "spill": (13, "canonical", 256, 5, 512, False, "random", 77),
    "spill_dir": (13, "canonical", 256, 5, 512, True, "random", 3),
    "overflow": (13, "canonical", 256, 1, 64, False, "random", 1),
    "finalize_once": (9, "canonical", 128, 1, 4 * 1024, False, "random", 5),
}


def step_codes(name, n):
    """The scenario's input for n sources: a list of (n * chunk,) uint8
    code arrays, one a step (255 = separator)."""
    k, _, chunk, steps, _, _, kind, seed = SCENARIOS[name]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        codes = rng.integers(0, 4, size=n * chunk).astype(np.uint8)
        if kind == "polyG":
            codes[20:20 + 2 * k] = 3      # G: forward all-ones k-mers
        elif kind == "separators":
            codes[rng.integers(0, len(codes), size=30)] = 255
            codes[:chunk] = 255           # source 0: nothing but separators
        elif kind == "motif":
            motif = np.array([0, 1, 2, 3, 0, 0, 1, 3], np.uint8)
            codes = np.tile(motif, n * chunk // len(motif))
        elif kind == "polyA":
            codes[:chunk] = 0             # source 0 overflows its capture
        out.append(codes)
    return out


def run_scenario(name, n, rank, out_dir, group=None):
    """Rank `rank` of n runs the named scenario through the port's
    ShardedCounter on the CPU: over `group` (a LocalGroup or JobGroup
    member) or, by default, the default torch.distributed group.  -> (result dict,
    arrays of its finalized parts)."""
    from meryl_tpu_torch.parallel.shard_count import ShardedCounter
    k, mode, chunk, _, acc_cap, spill, _, _ = SCENARIOS[name]
    spill_dir = os.path.join(out_dir, f"{name}_spill_r{rank}") \
        if spill else None
    res = {"error": None}
    arrays = {}
    try:
        sc = ShardedCounter(k, chunk_len=chunk, mode=mode, acc_cap=acc_cap,
                            spill_dir=spill_dir, device="cpu", group=group)
        for codes in step_codes(name, n):
            sc.add_codes(codes[rank * chunk:(rank + 1) * chunk])
        parts = sc.finalize_parts()
        res["rows"] = [int(p[0]) for p in parts]
        for i, (_, hi, lo, c) in enumerate(parts):
            arrays.update({f"hi{i}": hi, f"lo{i}": lo, f"c{i}": c})
        res["stats"] = dict(sc.stats)
        res["masked_steps"] = sc.masked_steps
        res["spill_files"] = sorted(os.listdir(spill_dir)) \
            if spill_dir and os.path.isdir(spill_dir) else []
        again = []
        for fn in (sc.finalize, sc.finalize_parts):
            try:
                fn()
            except RuntimeError as e:
                again.append(str(e))
        res["again"] = again
    except RuntimeError as e:
        res["error"] = str(e)
    return res, arrays


def rank_scenarios(rank, n, out_dir, names, group=None):
    """Rank `rank` of n runs every named scenario (run_scenario, over
    `group`) and writes what it finalized (<out_dir>/<name>_r<rank>.npz
    and .json)."""
    for name in names:
        res, arrays = run_scenario(name, n, rank, out_dir, group=group)
        np.savez(os.path.join(out_dir, f"{name}_r{rank}.npz"), **arrays)
        with open(os.path.join(out_dir, f"{name}_r{rank}.json"), "w") as f:
            json.dump(res, f)


def job_scenarios(proc, nprocs, d, out_dir, names):
    """Process `proc` of a gloo job runs every named scenario over d CPU
    members of a JobGroup (global rank proc * d + l of nprocs * d)."""
    from meryl_tpu_torch.parallel.local_group import JobGroup
    JobGroup(["cpu"] * d).run(lambda m: rank_scenarios(
        m.rank, m.size, out_dir, names, group=m))
