"""The rest of a member's steps in the window's sharded counts
(ShardedCounter.add_codes less its collectives: the wire upload, the
route and merge dispatches, the stats and overflow fetches; span
shard.step), summed over the members and divided by their number
(LAST_SHARD_STATS["members"]), as a % of the window: a mean member's
share, so at most 100 (trace.LAST_SPANS)."""

from harness import shard_spans

PROBES = shard_spans.PROBES
KEYS = ["shard.step_s"]


def read(run):
    return shard_spans.member_share(run, KEYS)
