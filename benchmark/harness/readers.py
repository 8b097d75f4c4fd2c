"""Helpers of the per-layer metrics' readers (layer_metrics/*.py).

A reader gets a run (run.LayerRun): `window_s`, `trace`
(harness.devtrace.Trace), `commands` (harness.runner.Done of every
command of the window, in order, each with the program counters its
reader asked for by `PROBES`, read after the command, and its `work`)
and `probes_start` (the counters before the window).  It returns the
metric, or None where it finds nothing to read.
"""

from __future__ import annotations

from harness import peaks


def counter_sum(run, probe: str, key: str, argv0: str | None = None):
    """The sum of `key` of a per-call counter dict (the program resets it
    at each call) over the window's commands whose first word is argv0;
    None where no call refreshed it."""
    total, seen = 0.0, False
    prev = run.probes_start.get(probe)
    for d in run.commands:
        cur = d.probes.get(probe)
        fresh = cur is not None and key in cur and cur != prev
        prev = cur
        if fresh and (argv0 is None or d.cmd.argv[0] == argv0):
            total += float(cur[key])
            seen = True
    return total if seen else None


def share_of_window(run, seconds):
    """seconds as a % of the window."""
    if seconds is None or run.window_s <= 0:
        return None
    return 100.0 * seconds / run.window_s


def idle_share(run):
    """% of the traced window in which no operation ran on the device."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline(run, kernels, nbytes):
    """% of the least time (nbytes over the HBM peak) in the device time
    of the operations named by `kernels`."""
    if run.trace is None or not nbytes:
        return None
    sec = run.trace.seconds_of(kernels)
    if sec <= 0:
        return None
    return 100.0 * (nbytes / peaks.HBM_BYTES_PER_S) / sec
