"""The download of each bucket group's merged entries, the wait on the
merge included (span setop.download), in every command of the window, as
a % of the window (trace.LAST_SPANS)."""

from harness import spans

PROBES = spans.PROBES
KEYS = ["setop.download_s"]


def read(run):
    return spans.span_share(run, KEYS, None)
