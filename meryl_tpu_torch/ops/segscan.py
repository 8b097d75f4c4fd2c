"""Segmented reductions over sorted runs (counterpart of
meryl_tpu/ops/segscan.py).

The reference phrases every per-run reduction as a log-depth segmented
scan because scatters serialize on the TPU.  PyTorch has a cumulative
sum and scatter-reduce on both the CPU and the GPU, so the port takes
run ids from a cumulative sum of the start flags and reduces by run:

  * a segmented sum is a cumulative sum minus its value before the run;
  * a segmented running min / max is torch.cummax / cummin over the
    values' dense ranks offset by run id, so no run reaches into the
    one before it;
  * a full-run reduction is a scatter_reduce into one slot per run and
    a gather back.

Results equal the reference's bit for bit where no sum wraps; sums of
uint32 values held as int64 are exact here, and the caller masks them
to 32 bits where the reference wraps (ops/setops.py).

`op` is torch.add, torch.minimum or torch.maximum (the reference passes
jnp.add, jnp.minimum, jnp.maximum); `vals` is one tensor or a tuple of
equal-length 1-d tensors, and the result has the same structure.
"""

from __future__ import annotations

import torch

_REDUCE = {torch.add: "sum", torch.minimum: "amin", torch.maximum: "amax"}


def _reduce_name(op) -> str:
    try:
        return _REDUCE[op]
    except KeyError:
        raise ValueError(f"op must be torch.add, torch.minimum or "
                         f"torch.maximum, got {op!r}") from None


def _map(fn, vals):
    if isinstance(vals, (tuple, list)):
        return tuple(fn(v) for v in vals)
    return fn(vals)


def _run_ids(start: torch.Tensor) -> torch.Tensor:
    """Run index of each element; the first element always opens run
    0, flagged or not, as in the reference's scans."""
    s = start.to(torch.int64)
    return torch.cumsum(s, 0) - s[:1]


def _scan1(name: str, x: torch.Tensor, rid: torch.Tensor) -> torch.Tensor:
    if name == "sum":
        cs = torch.cumsum(x, 0, dtype=x.dtype)
        # each run's first position, then the exclusive prefix there
        pos = torch.arange(x.numel(), device=x.device)
        first = torch.zeros_like(pos).scatter_reduce_(
            0, rid, pos, "amin", include_self=False)
        return cs - (cs - x)[first[rid]]
    uniq, rank = torch.unique(x, return_inverse=True)
    if name == "amin":                      # cummin of ranks = cummax of -rank
        rank = uniq.numel() - 1 - rank
    keyed = rid * uniq.numel() + rank
    r = torch.cummax(keyed, 0).values - rid * uniq.numel()
    if name == "amin":
        r = uniq.numel() - 1 - r
    return uniq[r]


def seg_scan(op, vals, start: torch.Tensor, reverse: bool = False):
    """Inclusive segmented scan of `vals` within runs delimited by
    `start` flags; reverse=True scans from run ends backwards."""
    name = _reduce_name(op)
    if reverse:
        end = torch.cat([start[1:], torch.ones(1, dtype=torch.bool,
                                               device=start.device)])
        rid = _run_ids(end.flip(0))
        return _map(lambda x: _scan1(name, x.flip(0), rid).flip(0), vals)
    rid = _run_ids(start)
    return _map(lambda x: _scan1(name, x, rid), vals)


def seg_all(op, vals, start: torch.Tensor):
    """Full-run reduction broadcast to every element of its run."""
    name = _reduce_name(op)
    rid = _run_ids(start)

    def one(x):
        # one slot per element bounds the runs without reading their
        # count back from the device
        red = torch.zeros(x.numel(), dtype=x.dtype, device=x.device)
        red.scatter_reduce_(0, rid, x, name, include_self=False)
        return red[rid]
    return _map(one, vals)


def seg_sum_all(vals, start):
    return seg_all(torch.add, vals, start)


def seg_min_all(vals, start):
    return seg_all(torch.minimum, vals, start)


def seg_max_all(vals, start):
    return seg_all(torch.maximum, vals, start)
