"""meryl-lookup's queries of each batch (extraction, table search, prefix
counts; span lookup.query) in the window's calls, as a % of the window
(trace.LAST_SPANS)."""

from harness import spans

PROBES = spans.PROBES
KEYS = ["lookup.query_s"]


def read(run):
    return spans.span_share(run, KEYS, "-existence")
