"""The set-op DB write (the prefix split, MerylDBWriter.add_bucket and
finalize; span setop.db_write) in every command of the window, as a % of
the window (trace.LAST_SPANS)."""

from harness import spans

PROBES = spans.PROBES
KEYS = ["setop.db_write_s"]


def read(run):
    return spans.span_share(run, KEYS, None)
