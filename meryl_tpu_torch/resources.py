"""Host resource discovery: memory/thread allowances.

The reference's AS_configure derives default memory and thread limits
from the OS and, when running under a batch scheduler, from the grid
allocation (Slurm / PBS / SGE — documentation/source/reference.rst:
117-120: "the memory limit is determined from the grid
configuration").  This module re-provides that contract: grid
allocation first, then cgroup limit, then physical RAM.
"""

from __future__ import annotations

import os


def _read_int(path: str) -> int | None:
    try:
        with open(path) as f:
            txt = f.read().strip()
        return int(txt) if txt.isdigit() else None
    except (OSError, ValueError):
        return None


def grid_memory_bytes(env=os.environ) -> int | None:
    """Memory granted by the batch scheduler, if any."""
    v = env.get("SLURM_MEM_PER_NODE")          # MB
    if v and v.isdigit():
        return int(v) << 20
    v = env.get("SLURM_MEM_PER_CPU")           # MB per CPU
    if v and v.isdigit():
        cpus = env.get("SLURM_CPUS_ON_NODE", "1")
        return (int(v) << 20) * (int(cpus) if cpus.isdigit() else 1)
    v = env.get("PBS_RESC_MEM")                # bytes
    if v and v.isdigit():
        return int(v)
    v = env.get("SGE_MEM")                     # bytes (set by wrappers)
    if v and v.isdigit():
        return int(v)
    return None


def grid_threads(env=os.environ) -> int | None:
    """CPUs granted by the batch scheduler, if any.  (OMP_NUM_THREADS
    is deliberately NOT consulted: it is an OpenMP tuning knob that
    users routinely pin to 1 for BLAS, not a grid allocation.)"""
    for key in ("SLURM_CPUS_ON_NODE", "PBS_NCPUS", "NSLOTS"):
        v = env.get(key)
        if v and v.isdigit() and int(v) > 0:
            return int(v)
    return None


def cgroup_memory_bytes() -> int | None:
    """Container limit (cgroup v2 then v1); None when unlimited."""
    v = _read_int("/sys/fs/cgroup/memory.max")
    if v is None:
        v = _read_int("/sys/fs/cgroup/memory/memory.limit_in_bytes")
    # "max"/huge sentinel values mean unlimited
    if v is not None and v < (1 << 60):
        return v
    return None


def physical_memory_bytes() -> int:
    try:
        return (os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    except (ValueError, OSError, AttributeError):
        return 8 << 30


def max_memory_gb(env=os.environ) -> float:
    """Default for memory= when the user gives none: grid allocation,
    else container limit, else physical RAM (minus a 10% headroom)."""
    b = grid_memory_bytes(env)
    if b is None:
        b = cgroup_memory_bytes()
    if b is None:
        b = physical_memory_bytes()
    return max(0.25, (b * 0.9) / 1e9)


def max_threads(env=os.environ) -> int:
    """Default for threads=: grid allocation, else CPU count."""
    t = grid_threads(env)
    if t is None:
        t = os.cpu_count() or 2
    return max(1, t)
