"""The reader thread's 2-bit pack of each chunk (counter.prepack; span
count.reader_pack) in the window's count jobs, as a % of the window
(trace.LAST_SPANS)."""

from harness import spans

PROBES = spans.PROBES
KEYS = ["count.reader_pack_s"]


def read(run):
    return spans.span_share(run, KEYS, "count")
