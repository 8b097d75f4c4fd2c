"""meryl_tpu_torch: the PyTorch / CUDA port of meryl_tpu, for NVIDIA
Hopper GPUs.

`meryl count` (FASTA/FASTQ in, meryl DB out) runs as plain PyTorch
around a hand-written CUDA kernel (k-mer extraction, csrc/extract.cu);
the set operations sort their rows with another (csrc/rowsort.cu).  On
several GPUs a job of ranks, one process and one card each, counts over
torch.distributed (NCCL; gloo on the CPU): parallel/.  The JAX package meryl_tpu stays the reference.
This package keeps its own copies of the reference's JAX-free host
modules (kmer, resources, io/, native, db, histogram, reports) and
imports nothing of meryl_tpu and nothing of JAX: importing meryl_tpu
would import jax where it is installed (meryl_tpu/__init__.py).

Every entry point takes an explicit `device`.  "cuda" raises when
CUDA is absent; the CPU runs only when asked for (device="cpu").
"""

__version__ = "0.1.0"

import torch


def resolve_device(device) -> torch.device:
    """"cuda" / "cpu" / a torch.device -> torch.device; raises when the
    device is not present.  There is no fallback from one to the
    other."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=cuda but torch.cuda.is_available() is false; "
                "pass device=cpu to count on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {dev}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev


def __getattr__(name):
    """Lazy public API."""
    if name in ("count_to_db", "count_to_arrays"):
        from . import counter
        return getattr(counter, name)
    if name == "ShardedCounter":
        from .parallel import shard_count
        return shard_count.ShardedCounter
    raise AttributeError(
        f"module 'meryl_tpu_torch' has no attribute {name!r}")
