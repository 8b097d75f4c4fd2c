"""meryl-lookup's parsing of each batch of sequences (reading, CODE_LUT,
breakers; span lookup.parse) in the window's calls, as a % of the window
(trace.LAST_SPANS)."""

from harness import spans

PROBES = spans.PROBES
KEYS = ["lookup.parse_s"]


def read(run):
    return spans.span_share(run, KEYS, "-existence")
