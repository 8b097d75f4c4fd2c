"""Analytic multi-GPU scaling model of sharded counting (counterpart of
meryl_tpu/parallel/scaling.py), printed by `-C`.

The port's machine has one GPU, so instead of a measurement `-C` prints
a checkable prediction: from stage costs measured on one H100 and the
published bandwidths of the links between H100s, the time of each
stage of a step and the parallel efficiency at several GPU counts.

A step of the routed count (parallel/shard_count.py) does, on each GPU,
for a chunk of C bases:

  1. extraction + routing into the (B, Wc) cell grid      t_local
  2. ONE all_to_all_single of the cell grid                t_ici (NVLink
     inside a node), t_dcn (InfiniBand across nodes)
  3. the owner's fold of the staged cells (merge_cells)    t_merge

Wire and merge volumes are the B * Wc slots of the routing geometry
(plan_shard_route), fixed per (source, owner) pair whatever the
composition, so both are balanced by construction.  The port runs the
three stages one after another (no overlap), so

    efficiency(n) = (t_local + t_merge) / (t_local + t_ici + t_dcn + t_merge).

Stage costs: MERYL_TPU_T_LOCAL_NS (ns a base) and MERYL_TPU_T_MERGE_NS
(ns a staged slot) override the built-ins, which chip_smoke.py phase 16
measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (per-step
route and merge times of a 1-rank count at 2^22 bases a step, k=21).
Links: MERYL_TPU_ICI_GB_S and MERYL_TPU_DCN_GB_S override the published
figures of LINKS (one direction, a GPU).  The TPU's calibration files
(BENCH_r*.json) are not read: they are TPU measurements.
"""

from __future__ import annotations

import os

# H100 stage costs from chip_smoke.py phase 16 on an NVIDIA H100 80GB
# HBM3 at 700.00 W, the mean of two runs (1.1624 and 1.1222 ns a base,
# 1.2166 and 1.1268 ns a slot): the median route call (extraction +
# routing) over its 2^22 bases, and the median merge_cells call times
# merges a step over the step's 1024 x 4928 staged slots
_BUILTIN_T_LOCAL_NS = 1.1423
_BUILTIN_T_MERGE_NS = 1.1717
BUILTIN_SOURCE = "built-in (H100 80GB HBM3, 700 W, chip_smoke.py phase 16)"

# published link bandwidths of one H100 SXM, one direction (not
# measured here):
#   nvlink: NVLink 4, 18 links, 900 GB/s both ways = 450 GB/s each way,
#           any to any through NVSwitch inside an 8-GPU HGX H100 node
#           (NVIDIA H100 Tensor Core GPU data sheet);
#   ib:     InfiniBand NDR, one 400 Gb/s ConnectX-7 port a GPU
#           = 50 GB/s (NVIDIA DGX H100 data sheet)
LINKS = {"nvlink": 450.0, "ib": 50.0}
GPUS_PER_NODE = 8


def calibration() -> dict:
    """Stage costs and link rates, env over built-in, read at call
    time: {t_local_ns, t_merge_ns, t_local_src, t_merge_src, ici_gb_s,
    dcn_gb_s}."""
    out = {}
    for key, env, val in (("t_local", "MERYL_TPU_T_LOCAL_NS",
                           _BUILTIN_T_LOCAL_NS),
                          ("t_merge", "MERYL_TPU_T_MERGE_NS",
                           _BUILTIN_T_MERGE_NS)):
        got = os.environ.get(env)
        out[f"{key}_ns"] = float(got) if got else val
        out[f"{key}_src"] = "env" if got else BUILTIN_SOURCE
    out["ici_gb_s"] = float(os.environ.get("MERYL_TPU_ICI_GB_S",
                                           LINKS["nvlink"]))
    out["dcn_gb_s"] = float(os.environ.get("MERYL_TPU_DCN_GB_S",
                                           LINKS["ib"]))
    return out


def predict_scaling(chunk_len: int, n_devices: int,
                    gpus_per_node: int = GPUS_PER_NODE, k: int = 21) -> dict:
    """Predicted step times (ms) and parallel efficiency of n_devices
    GPUs, each counting chunks of chunk_len bases.  A rank sends each
    other rank an equal share of its slots: (m - 1) / n of them stay in
    its node of m = min(n, gpus_per_node) GPUs (NVLink), (n - m) / n
    leave it (InfiniBand)."""
    from ..ops import multiword as mw
    from .shard_count import plan_shard_route
    cal = calibration()
    n = max(1, n_devices)
    g = plan_shard_route(chunk_len, k, n)
    slots = float(g["B"] * g["Wc"])
    wire = slots * 8 * mw.num_words(k)  # int64 key words a slot
    m = min(n, gpus_per_node)
    t_local = chunk_len * cal["t_local_ns"] * 1e-9
    t_ici = wire * (m - 1) / n / (cal["ici_gb_s"] * 1e9)
    t_dcn = wire * (n - m) / n / (cal["dcn_gb_s"] * 1e9)
    t_merge = slots * cal["t_merge_ns"] * 1e-9
    t_step = t_local + t_ici + t_dcn + t_merge
    return {
        "devices": n_devices,
        "hosts": -(-n // gpus_per_node),
        "t_local_ms": round(t_local * 1e3, 3),
        "t_ici_ms": round(t_ici * 1e3, 3),
        "t_dcn_ms": round(t_dcn * 1e3, 3),
        "t_merge_ms": round(t_merge * 1e3, 3),
        "efficiency": round((t_local + t_merge) / t_step, 4),
        "bases_per_s": round(n * chunk_len / t_step, 1),
    }


def scaling_report(chunk_len: int, counts=(8, 64, 256),
                   gpus_per_node: int = GPUS_PER_NODE) -> list:
    """The predicted table of `-C`."""
    return [predict_scaling(chunk_len, n, gpus_per_node) for n in counts]
