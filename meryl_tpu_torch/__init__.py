"""meryl_tpu_torch: the PyTorch / CUDA port of meryl_tpu's counting
path, for one NVIDIA Hopper GPU.

`meryl count` on one device (FASTA/FASTQ in, meryl DB out) runs as
plain PyTorch around one hand-written CUDA kernel (k-mer extraction,
csrc/extract.cu).  The JAX package meryl_tpu stays the reference; its
JAX-free host modules (kmer, db, io.sequence, native) are shared, and
nothing in this package imports JAX.

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
    raise AttributeError(
        f"module 'meryl_tpu_torch' has no attribute {name!r}")
