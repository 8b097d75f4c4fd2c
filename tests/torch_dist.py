"""Run a function on n gloo ranks for the port's multi-rank tests.

Each rank is a process started with the spawn method; it joins a gloo
group over a FileStore in the test's temporary directory (so no two
tests race for a port), calls target(rank, n, *args), and leaves the
group.  A rank that fails, or a job that outlives its timeout, ends
every rank.  Imports no JAX: the ranks import only torch, numpy and
meryl_tpu_torch."""

import multiprocessing as mp
import os
import time
import uuid
from datetime import timedelta

# a collective waits this long for the other ranks before it fails
GROUP_TIMEOUT_S = 120


def _rank_entry(target, rank, n, store, args):
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, n), rank=rank, world_size=n,
        timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        target(rank, n, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(n, target, args, tmp, timeout=240):
    """Run target on n ranks; raise unless every rank exits 0 in time."""
    ctx = mp.get_context("spawn")
    store = os.path.join(str(tmp), f"store_{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_entry,
                         args=(target, r, n, store, tuple(args)))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    assert codes == [0] * n, f"ranks exited {codes}"


def count_db_rank(rank, n, env, paths, out_path, k, memory_gb=None,
                  record=None):
    """A rank of a MERYL_TPU_COORD job calling count_to_db, as the CLI
    of each rank does (the group already exists, so init_from_env only
    reads the contract).  record: a directory where the rank writes the
    spill directories its members stored runs in and LAST_SHARD_STATS
    (rank<r>.json)."""
    import json
    os.environ.update(env, MERYL_TPU_COORD="127.0.0.1:1",
                      MERYL_TPU_NPROCS=str(n), MERYL_TPU_PROCID=str(rank))
    from meryl_tpu_torch import counter
    from meryl_tpu_torch.parallel import shard_count as sc
    seen = set()
    real = sc.ShardedCounter._store_run

    def store_run(self, d, run):
        seen.add(self.spill_dir)
        return real(self, d, run)
    sc.ShardedCounter._store_run = store_run
    counter.count_to_db(paths, out_path, k, device="cpu",
                        memory_gb=memory_gb)
    if record:
        with open(os.path.join(record, f"rank{rank}.json"), "w") as f:
            json.dump({"spill_dirs": sorted(seen),
                       "stats": dict(sc.LAST_SHARD_STATS)}, f)


def job_collectives_rank(rank, n, d, out_dir):
    """Process `rank` of n runs a JobGroup of d CPU members: each member
    makes the four collectives on tensors made from its global rank,
    then a member and then a leader fails at the same step in every
    process (so every process makes the same distributed calls), and
    the group runs again.  Writes what it saw to <out_dir>/p<rank>.npz
    and .json."""
    import json
    import time

    import numpy as np
    import torch

    from meryl_tpu_torch.parallel import local_group as lg
    group = lg.JobGroup(["cpu"] * d)
    size = n * d

    def body(m):
        g = m.rank
        inp = torch.arange(2 * size * 3, dtype=torch.int64).reshape(
            2 * size, 3) + 1000 * g
        out = torch.empty_like(inp)
        m.all_to_all_single(out, inp)
        red = [torch.tensor([g, -g, 7], dtype=torch.int64) for _ in range(3)]
        for op, t in zip((lg.SUM, lg.MAX, lg.MIN), red):
            m.all_reduce(t, op)
        got = [torch.zeros((2, 2), dtype=torch.int64) for _ in range(size)]
        m.all_gather(got, torch.full((2, 2), g, dtype=torch.int64))
        m.barrier()
        return (g, m.size, out.numpy(), np.stack([t.numpy() for t in red]),
                np.stack([t.numpy() for t in got]))

    arrays = {}
    for g, sz, out, red, got in group.run(body):
        arrays.update({f"out{g}": out, f"red{g}": red, f"got{g}": got,
                       f"size{g}": np.array(sz)})
    fails = {}
    for who, local in (("member", d - 1), ("leader", 0)):
        def failing(m, local=local):
            for i in range(10 ** 6):
                if m.local == local and i == 3:
                    raise ValueError(f"{who} {m.rank} fails")
                m.all_reduce(torch.ones(1), lg.SUM)
        t0 = time.monotonic()
        try:
            group.run(failing)
            fails[who] = "no error"
        except ValueError as e:
            fails[who] = str(e)
        fails[who + "_s"] = time.monotonic() - t0
    # whole again: one more round of every member, across processes
    again = group.run(lambda m: (m.all_reduce(t := torch.ones(1), lg.SUM),
                                 t.item())[1])
    fails["again"] = again
    np.savez(os.path.join(out_dir, f"p{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"p{rank}.json"), "w") as f:
        json.dump(fails, f)
