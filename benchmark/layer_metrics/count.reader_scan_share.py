"""The reader thread's file scan (the SequenceChunker's next chunk; span
count.reader_scan) in the window's count jobs, as a % of the window
(trace.LAST_SPANS)."""

from harness import spans

PROBES = spans.PROBES
KEYS = ["count.reader_scan_s"]


def read(run):
    return spans.span_share(run, KEYS, "count")
