"""The device trace of a window (torch.profiler, CUDA and CPU
activities) reduced to what the benchmark reports: the device's busy
time, every device operation's name and interval, and the idle gaps
labelled with what the host was doing.

The benchmark's own spans (`torch.profiler.record_function`, named
"bench:<command>") mark each command of the window; inside one, the
innermost torch operation running on the host at a gap's middle names
the gap, and "host, no torch op" where none was (Python, NumPy, file
I/O, the program's reader thread).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SPAN_PREFIX = "bench:"
WINDOW_SPAN = "bench:window"     # the window itself: its interval
# device activities that occupy the card (not the spans kineto mirrors
# onto the device's timeline)
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
SHORT_GAP_S = 10e-6       # gaps below this are launch spacing


@dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: list          # (name, start_s, seconds) device operations
    gaps: list         # (label, seconds), idle time summed by label

    def seconds_of(self, substrings) -> float:
        """Device seconds of the operations whose name holds any of
        `substrings`."""
        return sum(d for n, _, d in self.ops
                   if any(s in n for s in substrings))

    def breakdown(self, top: int = 10) -> dict:
        by = {}
        for n, _, d in self.ops:
            by[n] = by.get(n, 0.0) + d
        ops = sorted(by.items(), key=lambda x: -x[1])[:top]
        gaps = sorted(self.gaps, key=lambda x: -x[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


def _events(prof):
    """(device, cpu, spans) event tuples (name, start_ns, end_ns)."""
    from torch.autograd import DeviceType
    dev, cpu, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        t = (e.name(), s, s + e.duration_ns())
        # older torch has no activity_type: the spans mirrored onto the
        # device then show by their names
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        if e.device_type() == DeviceType.CUDA:
            if kind in DEVICE_OPS or (kind is None and
                                      not t[0].startswith(SPAN_PREFIX)):
                dev.append(t)
        elif t[0].startswith(SPAN_PREFIX):
            spans.append(t)
        elif kind in (None, "cpu_op", "user_annotation"):
            cpu.append(t)
    return dev, cpu, spans


def reduce(prof) -> Trace:
    """The trace of the window: the interval of its WINDOW_SPAN, on the
    profiler's own clock."""
    dev, cpu, spans = _events(prof)
    win = [x for x in spans if x[0] == WINDOW_SPAN]
    if len(win) != 1:
        raise RuntimeError(f"{len(win)} {WINDOW_SPAN} spans in the trace")
    spans = [x for x in spans if x[0] != WINDOW_SPAN]
    t0_ns, t1_ns = win[0][1], win[0][2]
    dev.sort(key=lambda x: x[1])
    ops = [(n, (s - t0_ns) / 1e9, (e - s) / 1e9) for n, s, e in dev]
    # union of the device intervals, clipped to the window
    merged = []
    for _, s, e in dev:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [t0_ns] + [x for iv in merged for x in iv] + [t1_ns]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return Trace((t1_ns - t0_ns) / 1e9, busy / 1e9, ops,
                 _label(gaps, cpu, spans))


def _label(gaps, cpu, spans):
    cpu.sort(key=lambda x: x[1])
    spans.sort(key=lambda x: x[1])
    c_start = np.array([s for _, s, _ in cpu], np.int64)
    s_start = np.array([s for _, s, _ in spans], np.int64)
    out: dict[str, float] = {}
    short = 0
    for a, b in gaps:
        if b - a < SHORT_GAP_S * 1e9:
            short += b - a
            continue
        mid = (a + b) // 2
        i = int(np.searchsorted(s_start, mid, "right")) - 1
        span = spans[i][0][len(SPAN_PREFIX):] \
            if i >= 0 and spans[i][2] >= mid else "between commands"
        j = int(np.searchsorted(c_start, mid, "right")) - 1
        op = "host, no torch op"
        for jj in range(j, max(j - 64, -1), -1):
            if cpu[jj][2] >= mid:
                op = cpu[jj][0]
                break
        key = f"{span}: {op}"
        out[key] = out.get(key, 0.0) + (b - a) / 1e9
    if short:
        out[f"gaps under {SHORT_GAP_S * 1e6:g} us"] = short / 1e9
    return sorted(out.items(), key=lambda x: -x[1])
