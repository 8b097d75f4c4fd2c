"""A member's wait for its chunk in the window's sharded counts
(counter._Dealer.take: its lock and the reader's queue; span
shard.wait_dealer), summed over the members and divided by their
number (LAST_SHARD_STATS["members"]), as a % of the window: a mean
member's share, so at most 100 (trace.LAST_SPANS)."""

from harness import shard_spans

PROBES = shard_spans.PROBES
KEYS = ["shard.wait_dealer_s"]


def read(run):
    return shard_spans.member_share(run, KEYS)
