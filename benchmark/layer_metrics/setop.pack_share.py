"""The set-op evaluator's row packing (_pack_rows or _pack_flat; span
setop.pack) in every command of the window, as a % of the window
(trace.LAST_SPANS)."""

from harness import spans

PROBES = spans.PROBES
KEYS = ["setop.pack_s"]


def read(run):
    return spans.span_share(run, KEYS, None)
