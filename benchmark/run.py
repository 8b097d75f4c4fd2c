"""Run one cell of the benchmark of meryl_tpu_torch once.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device, with --trace 1 breakdown, and
last check (each number compared, beside its limit).  Exits nonzero,
with no result, when no CUDA device (or too few) is present, when a
set-up step fails, or when JAX or the JAX package was loaded.
"""

import os
import time


def _process_start() -> float:
    """perf_counter() reading at this process's start."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(ROOT, ".bench_cache")     # fixed: later runs hit it


def _environment():
    """Caches inside the checkout at fixed paths; no JAX behind a
    library's back."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, ROOT)
    sys.path.insert(0, BENCH_DIR)


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _io() -> dict:
    try:
        with open("/proc/self/io") as f:
            return {a: int(b) for a, b in
                    (line.split(": ") for line in f.read().splitlines())}
    except OSError:
        return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch
    from harness import registry
    try:
        cell = registry.find_cell(registry.load_benchmark(ROOT),
                                  args.workload, ROOT)
    except (OSError, registry.NotFound, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    work = tempfile.mkdtemp(prefix="meryl-bench-")
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if result is None:
        return 4
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


def run_cell(cell, seed, seconds, trace, device, workdir, log=None):
    """The whole run; -> the result object, or None when it must not
    print one (a set-up failure, JAX loaded).  device "cpu" is for the
    tests: it skips nothing but the look for a card."""
    import torch
    from harness import registry, runner

    log = log or sys.stderr
    io0 = _io()
    on_card = torch.device(device).type == "cuda"
    readers = {m["name"]: registry.metric_reader(m["name"])
               for m in cell.per_layer} if trace else {}
    probes = sorted({p for r in readers.values()
                     for p in getattr(r, "PROBES", ())})
    r = runner.Runner(cell, seed, seconds, trace, device, workdir, log)
    try:
        r.setup()
    except runner.SetupFailed as e:
        print(f"benchmark: {e}", file=log)
        return None
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    window_s = r.window(probes)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    banned = runner.banned_modules()
    if banned:
        print(f"benchmark: JAX or the JAX package was loaded: "
              f"{', '.join(banned[:8])}", file=log)
        return None
    runner.free_device_memory()
    t = time.perf_counter()
    mism, detail = r.check()
    check_s = time.perf_counter() - t

    metrics = {}
    if trace:
        run = LayerRun(r, window_s)
        for name, reader in readers.items():
            v = reader.read(run)
            if v is not None:
                unit = next(m["unit"] for m in cell.per_layer
                            if m["name"] == name)
                metrics[name] = {"value": v, "unit": unit}
    else:
        spec = cell.traffic["metric"]
        rate = r.total_work(spec["work"]) * spec["scale"] / window_s
        values = {spec["name"]: rate,
                  "peak_device_mib": window_peak / 2 ** 20,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            if m["name"] in values and (on_card or m["name"] !=
                                        "peak_device_mib"):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    failed = sum(d.rc != 0 for d in r.done)
    checks = {f"mismatch_{s}_job": {"value": v, "limit": 0}
              for s, v in mism.items()}
    # a failed command is counted in `failed`, and leaves its outputs
    # missing, which the first and last jobs' numbers count
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(setup_peak, window_peak)}
    if trace and r.trace_result is not None:
        dev["busy_s"] = r.trace_result.busy_s
        dev["window_s"] = r.trace_result.window_s
    if on_card:
        dev["power"] = _power_limit()
    result = {"correct": correct, "attempted": len(r.done),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and r.trace_result is not None:
        result["breakdown"] = r.trace_result.breakdown()
    io1 = _io()
    info = {"jobs": r.jobs, "job_s": [round(x, 3) for x in r.job_seconds()],
            "window_s": window_s, "setup_s": setup_s,
            "check_s": check_s, **r.times,
            **{f"io_{kk}": io1[kk] - io0.get(kk, 0)
               for kk in ("wchar", "write_bytes", "cancelled_write_bytes")
               if kk in io1}}
    result["check"] = checks

    for line in detail:
        print(f"check: {line}", file=log)
    print(f"run: {json.dumps(info)}", file=log)
    for name, c in checks.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=log)
    log.flush()
    return result


class LayerRun:
    """What a per-layer metric's reader sees of a traced run."""

    def __init__(self, r, window_s: float):
        self.window_s = window_s
        self.trace = r.trace_result          # harness.devtrace.Trace
        self.commands = r.done               # runner.Done, in order
        self.probes_start = r.probes_start
        self.config = r.cell.config
        self.cell = r.cell.name


if __name__ == "__main__":
    sys.exit(main())
