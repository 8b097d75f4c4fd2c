"""Multi-process counting: one rank a process, one device a rank
(counterpart of meryl_tpu/parallel/multihost.py).

  * every process joins one torch.distributed group (NCCL on cuda,
    gloo when device=cpu is asked for; no fallback from one to the
    other),
  * each rank reads a disjoint sequence segment of the SAME input (the
    chunker's sequence-modulo split) and feeds its own chunks,
  * one ShardedCounter step a rank exchanges k-mers with their owner
    ranks (parallel/shard_count.py); its decisions come from all-reduced
    values, so every rank takes them alike,
  * each rank writes its owner range as a sorted part file; rank 0
    assembles the 64-bucket DB (histogram and statistics from the final
    merged counts).

Lockstep: every rank makes the same collective calls the same number of
times.  A rank whose segment is exhausted keeps feeding empty chunks
(the keep-alive pad) until every rank is done (one all_reduce MIN a
step), so the collectives never deadlock.

Environment contract (parallel/launch.py sets it):
  MERYL_TPU_COORD    rendezvous address host:port (rank 0 listens)
  MERYL_TPU_NPROCS   number of processes
  MERYL_TPU_PROCID   this process's rank (0-based); on cuda it takes
                     cuda:{PROCID % device_count}
A rank is one device.  MERYL_TPU_LOCAL_DEVICES (the reference's virtual
CPU devices a process) is refused in a job: several devices of one
process count on the one-process path (MERYL_TPU_SHARDED=1 count,
counter.count_to_arrays_sharded(devices=)), and a job of such processes
is not ported (ROADMAP.md, "Not ported").
MERYL_TPU_MH_DEBUG=DIR writes each rank's read volume and hatch counters
(LAST_SHARD_STATS) to DIR/mh_read_bases_proc{rank}.json.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from .local_group import GROUP_TIMEOUT, backend_for, rank_device

PART_DIR_SUFFIX = ".mhparts"


def env_requested() -> bool:
    return "MERYL_TPU_COORD" in os.environ


def init_from_env(device="cuda") -> tuple[int, int]:
    """Join the group that MERYL_TPU_* describe and return (rank,
    world size).  Idempotent.  On cuda the rank's card is chosen before
    the group is made."""
    if os.environ.get("MERYL_TPU_LOCAL_DEVICES"):
        raise ValueError(
            "MERYL_TPU_LOCAL_DEVICES in a job has no counterpart in "
            "meryl_tpu_torch: a rank of a job is one process with one "
            "device (start more ranks with parallel/launch.py --nprocs); "
            "several devices of one process count without a job "
            "(MERYL_TPU_SHARDED=1 count), and a job of such processes is "
            "not ported (ROADMAP.md, Not ported)")
    coord = os.environ["MERYL_TPU_COORD"]
    nprocs = int(os.environ["MERYL_TPU_NPROCS"])
    pid = int(os.environ["MERYL_TPU_PROCID"])
    dev = torch.device(device)
    if dev.type == "cuda":
        from .. import resolve_device
        resolve_device(dev)  # raises when CUDA is absent
        torch.cuda.set_device(pid % torch.cuda.device_count())
    if not dist.is_initialized() and nprocs > 1:
        dist.init_process_group(backend_for(dev),
                                init_method=f"tcp://{coord}",
                                world_size=nprocs, rank=pid,
                                timeout=GROUP_TIMEOUT)
    return pid, nprocs


def barrier() -> None:
    """dist.barrier on this rank's own card when the group is NCCL."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _all_done(local_done: bool, device) -> bool:
    """True iff every rank's input is exhausted (one all_reduce MIN)."""
    t = torch.tensor([1 if local_done else 0], dtype=torch.int64,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item() >= 1)


def count_to_arrays_multihost(paths, k: int, mode: str = "canonical",
                              hpc: bool = False,
                              chunk_len: int | None = None,
                              progress=None, device="cuda", **shard_kw):
    """Distributed counting over the ranks of the default group.

    Returns this rank's owner parts [(row, hi, lo, counts)]; rows ascend
    with rank, and the ranks' parts in row order are the globally sorted
    unique (kmer, count) set.  assemble_db builds the DB from them."""
    from ..counter import _prefetch_chunks, default_chunk
    from ..io.sequence import SequenceChunker
    from .shard_count import ShardedCounter, publish_stats

    if not dist.is_initialized():
        raise RuntimeError("count_to_arrays_multihost needs a process "
                           "group (init_from_env)")
    pid, nprocs = dist.get_rank(), dist.get_world_size()
    sc = ShardedCounter(k, chunk_len=chunk_len or default_chunk(),
                        mode=mode, device=device, **shard_kw)
    chunks = iter(_prefetch_chunks(
        SequenceChunker(paths, k, sc.chunk_len, hpc=hpc,
                        segment=(pid + 1, nprocs)),
        depth=4, transform=sc.prepack))
    pad = sc.prepack(np.zeros(0, np.uint8))
    exhausted = False
    nbases = 0
    while True:
        chunk = None if exhausted else next(chunks, None)
        if chunk is None:
            exhausted = True
            chunk = pad
        else:
            nbases += chunk[4]
        if _all_done(exhausted, sc.device):
            break
        sc.add_codes(chunk)
        if progress:
            progress(nbases)
    parts = sc.finalize_parts()
    publish_stats([sc])
    dbg_dir = os.environ.get("MERYL_TPU_MH_DEBUG")
    if dbg_dir:
        # each rank's read volume and hatch counters, one small file a
        # rank: tests read it to show that the keep-alive pad carried an
        # uneven split, the dryrun to sum the ranks' hatches
        os.makedirs(dbg_dir, exist_ok=True)
        with open(os.path.join(dbg_dir, f"mh_read_bases_proc{pid}.json"),
                  "w") as f:
            json.dump({"proc": pid, "read_bases": int(nbases),
                       "shard_stats": sc.stats}, f)
    return parts


def write_parts(out_path: str, k: int, parts) -> str:
    """Write this rank's owner parts; returns the parts directory.  Rank
    0 first removes a parts directory left by an earlier run (its stale
    proc*.json or part files would be merged in), and every rank waits
    for that before writing."""
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
    """Rank 0 merges every part file (disjoint, in global order by owner
    row) into the 64-bucket DB; the others wait.  Every rank checks the
    parts directory, so a stale one fails on every rank alike, and every
    rank returns only after the DB is complete."""
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
                          device="cuda", **shard_kw):
    """The multi-process count: distributed count -> one part file a
    rank -> rank 0 assembles the DB."""
    parts = count_to_arrays_multihost(
        paths, k, mode=mode, hpc=hpc, chunk_len=chunk_len,
        progress=progress, device=rank_device(device), **shard_kw)
    write_parts(out_path, k, parts)
    return assemble_db(out_path, k, mode=mode, hpc=hpc)
