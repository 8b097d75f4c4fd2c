"""The count's DB write (MerylDB.write; span count.db_write) in the
window's count jobs, as a % of the window (trace.LAST_SPANS)."""

from harness import spans

PROBES = spans.PROBES
KEYS = ["count.db_write_s"]


def read(run):
    return spans.span_share(run, KEYS, "count")
