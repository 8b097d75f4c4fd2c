"""The sharded counts' finalize, as a % of the window: a mean member's
settle (ShardedCounter.settle: the last steps resolved and merged, the
hatch extras exchanged; span shard.settle, its collectives excluded)
plus the main thread's owner_parts (each owner's download and host
merge; span shard.owner_parts) (trace.LAST_SPANS)."""

from harness import shard_spans
from harness.readers import share_of_window

PROBES = shard_spans.PROBES


def read(run):
    counts = shard_spans.sharded_counts(run)
    if not counts:
        return None
    return share_of_window(run, sum(
        shard_spans.member_seconds(sp, st, ["shard.settle_s"])
        + sp.get("shard.owner_parts_s", 0.0) for sp, st in counts))
