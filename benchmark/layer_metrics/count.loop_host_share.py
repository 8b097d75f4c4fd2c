"""The main thread's wire uploads, route and merge dispatches and fetches
(spans count.h2d, count.dispatch and count.fetch, those inside finalize
included) in the window's count jobs, as a % of the window
(trace.LAST_SPANS)."""

from harness import spans

PROBES = spans.PROBES
KEYS = ["count.h2d_s", "count.dispatch_s", "count.fetch_s"]


def read(run):
    return spans.span_share(run, KEYS, "count")
