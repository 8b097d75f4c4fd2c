"""Multi-process counting: the processes of one job, each with one or
several devices (counterpart of meryl_tpu/parallel/multihost.py).

  * every process joins one torch.distributed group (NCCL on cuda,
    gloo when device=cpu is asked for; no fallback from one to the
    other),
  * each process reads a disjoint sequence segment of the SAME input
    (the chunker's sequence-modulo split) and deals its chunks to its
    devices' members (counter._Dealer),
  * one ShardedCounter step a member exchanges k-mers with their owner
    members (parallel/shard_count.py) over the job's group: a DistGroup
    when a process has one device, else a JobGroup of P processes x D
    devices (parallel/local_group.py); its decisions come from
    all-reduced values, so every member takes them alike,
  * each process writes its members' owner ranges as sorted part files;
    process 0 assembles the 64-bucket DB (histogram and statistics from
    the final merged counts).

Lockstep: every member makes the same collective calls the same number
of times.  A process whose segment is exhausted keeps feeding empty
chunks (the keep-alive pad) until every process is done (one all_reduce
MIN over the group a step), so the collectives never deadlock.

Environment contract (parallel/launch.py sets it):
  MERYL_TPU_COORD          rendezvous address host:port (process 0
                           listens)
  MERYL_TPU_NPROCS         number of processes
  MERYL_TPU_PROCID         this process's index (0-based)
  MERYL_TPU_LOCAL_DEVICES  devices a process, D (default 1): on cpu D
                           members, on cuda cards [p * D, (p + 1) * D)
                           of those the process sees (modulo their
                           count, as one card a process takes card
                           PROCID % device_count)
MERYL_TPU_MH_DEBUG=DIR writes each process's read volume and its
members' hatch counters (LAST_SHARD_STATS) to
DIR/mh_read_bases_proc{p}.json.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from .local_group import (GROUP_TIMEOUT, DistGroup, JobGroup, _dist_barrier,
                          backend_for, rank_device)

PART_DIR_SUFFIX = ".mhparts"


def env_requested() -> bool:
    return "MERYL_TPU_COORD" in os.environ


def local_device_count() -> int:
    """D, the devices of each process of a job (MERYL_TPU_LOCAL_DEVICES,
    default 1)."""
    d = int(os.environ.get("MERYL_TPU_LOCAL_DEVICES") or 1)
    if d < 1:
        raise ValueError(f"MERYL_TPU_LOCAL_DEVICES must be >= 1, got {d}")
    return d


def _first_card(d: int) -> int:
    """This process's first card of its d: p * d modulo the cards it
    sees, which must hold all d (p: the process's rank in the group, or
    MERYL_TPU_PROCID before the group exists)."""
    pid = dist.get_rank() if dist.is_initialized() else \
        int(os.environ.get("MERYL_TPU_PROCID", "0"))
    have = torch.cuda.device_count()
    first = pid * d % max(1, have)
    if first + d > have:
        raise ValueError(
            f"process {pid} of a job with MERYL_TPU_LOCAL_DEVICES={d} "
            f"takes cards {first}..{first + d - 1}; this process sees "
            f"{have} CUDA device(s)")
    return first


def local_devices(device) -> list:
    """This process's devices in a job: D = local_device_count(); on
    cpu D CPU members, on cuda its D cards (_first_card); at D = 1 on
    cuda, the current card (init_from_env has chosen it)."""
    d = local_device_count()
    if d == 1 or torch.device(device).type != "cuda":
        return [rank_device(device)] * d
    from .. import resolve_device
    resolve_device(device)  # raises when CUDA is absent
    first = _first_card(d)
    return [torch.device("cuda", first + i) for i in range(d)]


def job_group(devices):
    """This process's part of the job's group over its `devices`: a
    DistGroup at one device, else a JobGroup (the default group must
    exist)."""
    if len(devices) == 1:
        return DistGroup(devices[0])
    return JobGroup(devices)


def init_from_env(device="cuda") -> tuple[int, int]:
    """Join the group that MERYL_TPU_* describe and return (process
    index, process count).  Idempotent.  On cuda the process's first
    card is made current before the group is made."""
    coord = os.environ["MERYL_TPU_COORD"]
    nprocs = int(os.environ["MERYL_TPU_NPROCS"])
    pid = int(os.environ["MERYL_TPU_PROCID"])
    d = local_device_count()
    dev = torch.device(device)
    if dev.type == "cuda":
        from .. import resolve_device
        resolve_device(dev)  # raises when CUDA is absent
        torch.cuda.set_device(_first_card(d))
    if not dist.is_initialized() and nprocs > 1:
        dist.init_process_group(backend_for(dev),
                                init_method=f"tcp://{coord}",
                                world_size=nprocs, rank=pid,
                                timeout=GROUP_TIMEOUT)
    return pid, nprocs


def barrier() -> None:
    """dist.barrier on this process's current card when the group is
    NCCL."""
    _dist_barrier(torch.cuda.current_device()
                  if dist.get_backend() == "nccl" else "cpu")


def _count_job(paths, k: int, *, mode: str, hpc: bool, chunk_len,
               progress, device, devices, spill_dir, **shard_kw):
    """Count this process's segment over the job's group.  -> the
    members' counters, settled, in member order; LAST_SHARD_STATS holds
    their hatch counters."""
    from ..counter import _count_members, default_chunk

    if not dist.is_initialized():
        raise RuntimeError("count_to_arrays_multihost needs a process "
                           "group (init_from_env)")
    pid, nprocs = dist.get_rank(), dist.get_world_size()
    group = job_group(local_devices(device) if devices is None
                      else [rank_device(d) for d in devices])
    counters, nbases = _count_members(
        group, paths, k, mode=mode, hpc=hpc,
        chunk_len=chunk_len or default_chunk(), progress=progress,
        # one process reads the whole input
        segment=None if nprocs == 1 else (pid + 1, nprocs),
        spill_dir=spill_dir, lockstep=True, **shard_kw)
    dbg_dir = os.environ.get("MERYL_TPU_MH_DEBUG")
    if dbg_dir:
        # each process's read volume and its members' hatch counters, one
        # small file a process: tests read it to show that the keep-alive
        # pad carried an uneven split, the dryrun to sum the hatches
        from .shard_count import LAST_SHARD_STATS
        os.makedirs(dbg_dir, exist_ok=True)
        with open(os.path.join(dbg_dir, f"mh_read_bases_proc{pid}.json"),
                  "w") as f:
            json.dump({"proc": pid, "read_bases": int(nbases),
                       "shard_stats": dict(LAST_SHARD_STATS)}, f)
    return counters


def count_to_arrays_multihost(paths, k: int, mode: str = "canonical",
                              hpc: bool = False,
                              chunk_len: int | None = None,
                              progress=None, device="cuda", devices=None,
                              **shard_kw):
    """Distributed counting over the members of the default group's
    processes: this process's `devices` (default local_devices(device)).

    Returns this process's owner parts [(row, hi, lo, counts)], row the
    member's global rank; rows ascend with it, and every process's
    parts in row order are the globally sorted unique (kmer, count) set.
    assemble_db builds the DB from them."""
    counters = _count_job(paths, k, mode=mode, hpc=hpc, chunk_len=chunk_len,
                          progress=progress, device=device, devices=devices,
                          spill_dir=None, **shard_kw)
    return [p for sc in counters for p in sc.owner_parts()]


def write_parts(out_path: str, k: int, parts) -> str:
    """Write this process's owner parts (an iterable: one part in host
    memory at a time); returns the parts directory.  Process 0 first
    removes a parts directory left by an earlier run (its stale
    proc*.json or part files would be merged in), and every process
    waits for that before writing."""
    pdir = out_path + PART_DIR_SUFFIX
    pid = dist.get_rank()
    if pid == 0 and os.path.isdir(pdir):
        shutil.rmtree(pdir)
    barrier()
    os.makedirs(pdir, exist_ok=True)
    meta = []
    for row, hi, lo, c in parts:
        fn = os.path.join(pdir, f"part_r{row:05d}.npz")
        np.savez(fn, hi=hi, lo=lo, counts=c.astype(np.uint32))
        meta.append({"row": int(row), "n": int(len(c)), "file": fn})
    with open(os.path.join(pdir, f"proc{pid}.json"), "w") as f:
        json.dump({"k": int(k), "nprocs": dist.get_world_size(),
                   "parts": meta}, f)
    return pdir


def assemble_db(out_path: str, k: int, *, mode: str = "canonical",
                hpc: bool = False):
    """Process 0 merges every part file (disjoint, in global order by
    owner row) into the 64-bucket DB; the others wait.  Every process
    checks the parts directory, so a stale one fails on every process
    alike, and every process returns only after the DB is complete."""
    from ..db import MerylDB, stream_sorted_parts

    barrier()
    nprocs = dist.get_world_size()
    pdir = out_path + PART_DIR_SUFFIX
    metas = []
    proc_files = []
    for fn in sorted(os.listdir(pdir)):
        if fn.startswith("proc") and fn.endswith(".json"):
            proc_files.append(fn)
            with open(os.path.join(pdir, fn)) as f:
                j = json.load(f)
            if j.get("nprocs", nprocs) != nprocs:
                raise RuntimeError(
                    f"{pdir}/{fn}: written by a {j['nprocs']}-process "
                    f"run, this job has {nprocs} — stale parts dir, "
                    f"remove it and rerun")
            metas.extend(j["parts"])
    if len(proc_files) != nprocs:
        raise RuntimeError(
            f"{pdir}: {len(proc_files)} proc manifests for {nprocs} "
            f"processes — incomplete or stale parts dir")
    db = None
    if dist.get_rank() == 0:
        metas.sort(key=lambda m: m["row"])

        def load(m):
            z = np.load(m["file"])
            return z["hi"], z["lo"], z["counts"]

        # owner ranges may straddle a 6-bit file: stream_sorted_parts
        # cuts them at the file boundaries
        db = stream_sorted_parts(out_path, k, (load(m) for m in metas),
                                 mode=mode, hpc=hpc)
        shutil.rmtree(pdir, ignore_errors=True)
    barrier()
    return db if db is not None else MerylDB.open(out_path)


def count_to_db_multihost(paths, out_path: str, k: int,
                          mode: str = "canonical", hpc: bool = False,
                          chunk_len: int | None = None, progress=None,
                          device="cuda", devices=None,
                          memory_gb: float | None = None, **shard_kw):
    """The multi-process count: distributed count over this process's
    `devices` (default local_devices(device); the counterpart of
    count_to_arrays_sharded(devices=)) -> one part file a member -> process
    0 assembles the DB.  When memory_gb is given and the plan
    (counter.configure_counting) splits the count, every member's
    accumulator spills to disk (`<out>.spills/m<rank>`, removed at the
    end) and each process writes its parts one owner at a time."""
    from ..counter import configure_counting

    spill_root = None
    if memory_gb is not None and configure_counting(
            paths, k, memory_gb, chunk_len, device=device)["batches"] > 1:
        spill_root = out_path + ".spills"
    try:
        counters = _count_job(
            paths, k, mode=mode, hpc=hpc, chunk_len=chunk_len,
            progress=progress, device=device, devices=devices,
            spill_dir=spill_root, **shard_kw)
        write_parts(out_path, k, (p for sc in counters
                                  for p in sc.owner_parts()))
    finally:
        if spill_root is not None:  # this process's members' spills
            d = local_device_count() if devices is None else len(devices)
            for r in range(dist.get_rank() * d, (dist.get_rank() + 1) * d):
                shutil.rmtree(os.path.join(spill_root, f"m{r}"),
                              ignore_errors=True)
    db = assemble_db(out_path, k, mode=mode, hpc=hpc)
    if spill_root is not None and dist.get_rank() == 0:
        shutil.rmtree(spill_root, ignore_errors=True)
    return db
