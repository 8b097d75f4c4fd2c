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


def count_db_rank(rank, n, env, paths, out_path, k):
    """A rank of a MERYL_TPU_COORD job calling count_to_db, as the CLI
    of each rank does (the group already exists, so init_from_env only
    reads the contract)."""
    os.environ.update(env, MERYL_TPU_COORD="127.0.0.1:1",
                      MERYL_TPU_NPROCS=str(n), MERYL_TPU_PROCID=str(rank))
    from meryl_tpu_torch import counter
    counter.count_to_db(paths, out_path, k, device="cpu")
