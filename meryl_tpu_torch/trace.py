"""Host spans: where a command's host time goes, layer by layer.

`with span("count.h2d"):` adds the block's self seconds (less those of
the spans opened inside it) to LAST_SPANS["count.h2d_s"] and one to
LAST_SPANS["count.h2d_n"]; its `seconds` is then its whole duration.
cli.main, lookup_cli.main and v2/cli.main reset LAST_SPANS.  Under
torch.profiler a span is also a host operator "meryl.<name>" of the
trace (RecordFunctionFast: a user annotation would be mirrored onto the
device's timeline, where readers that see no activity_type count it as
device work).  A worker thread's spans, inside thread_spans(), are
counters only, folded into LAST_SPANS when the block ends.
"""

from __future__ import annotations

import contextlib
import threading
from time import perf_counter

import torch

LAST_SPANS: dict = {}
_FOLD = threading.Lock()
_profiling = torch._C._autograd._profiler_enabled
_HostEvent = torch._C._profiler._RecordFunctionFast


class _Local(threading.local):
    top = None            # this thread's innermost open span
    sink = LAST_SPANS     # where its spans add up (thread_spans: its own)


_local = _Local()


def reset() -> None:
    """A command starts: forget the last one's spans."""
    LAST_SPANS.clear()


def since(before: dict) -> dict:
    """LAST_SPANS less an earlier copy of it, key by key."""
    return {k: v - before.get(k, 0) for k, v in LAST_SPANS.items()}


class span:
    """A block of host work named `name` (a leaf where it can be)."""

    __slots__ = ("name", "seconds", "_t0", "_inner", "_up", "_ev")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._ev = None
        if _local.sink is LAST_SPANS and _profiling():
            self._ev = _HostEvent("meryl." + self.name)
            self._ev.__enter__()
        self._up, _local.top = _local.top, self
        self._inner = 0.0
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = t = perf_counter() - self._t0
        _local.top = up = self._up
        if up is not None:
            up._inner += t
        d, name = _local.sink, self.name
        d[name + "_s"] = d.get(name + "_s", 0.0) + t - self._inner
        d[name + "_n"] = d.get(name + "_n", 0) + 1
        if self._ev is not None:
            self._ev.__exit__(*exc)


@contextlib.contextmanager
def thread_spans():
    """Keep the calling thread's spans apart until the block ends."""
    own = _local.sink = {}
    try:
        yield
    finally:
        del _local.sink
        with _FOLD:
            for k, v in own.items():
                LAST_SPANS[k] = LAST_SPANS.get(k, 0) + v
