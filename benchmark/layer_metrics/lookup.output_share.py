"""meryl-lookup's output lines of each batch (span lookup.output) in the
window's calls, as a % of the window (trace.LAST_SPANS)."""

from harness import spans

PROBES = spans.PROBES
KEYS = ["lookup.output_s"]


def read(run):
    return spans.span_share(run, KEYS, "-existence")
