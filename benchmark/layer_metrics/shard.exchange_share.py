"""A member's host time in the collectives of the window's sharded
counts (the two rendezvous of LocalMember's all_to_all_single,
all_reduce and all_gather, with the copies they queue; span
shard.exchange), summed over the members and divided by their number
(LAST_SHARD_STATS["members"]), as a % of the window: a mean member's
share, so at most 100 (trace.LAST_SPANS)."""

from harness import shard_spans

PROBES = shard_spans.PROBES
KEYS = ["shard.exchange_s"]


def read(run):
    return shard_spans.member_share(run, KEYS)
