"""The set-op evaluator's DB reads (load_bucket for a bucket group; span
setop.db_read) in every command of the window, as a % of the window
(trace.LAST_SPANS)."""

from harness import spans

PROBES = spans.PROBES
KEYS = ["setop.db_read_s"]


def read(run):
    return spans.span_share(run, KEYS, None)
