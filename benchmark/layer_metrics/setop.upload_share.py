"""The set-op evaluator's uploads of the packed keys, values and ids (span
setop.upload) in every command of the window, as a % of the window
(trace.LAST_SPANS)."""

from harness import spans

PROBES = spans.PROBES
KEYS = ["setop.upload_s"]


def read(run):
    return spans.span_share(run, KEYS, None)
