"""meryl-lookup's table load (DB read, table build, upload; span
lookup.table_load) in the window's calls, as a % of the window
(trace.LAST_SPANS)."""

from harness import spans

PROBES = spans.PROBES
KEYS = ["lookup.table_load_s"]


def read(run):
    return spans.span_share(run, KEYS, "-existence")
