"""The sharded count's spans and counters for the per-layer readers:
trace.LAST_SPANS (a member's spans are counters of its thread, summed
over the members) and parallel/shard_count.py LAST_SHARD_STATS
(`members`, the process's members; `peer_bytes`, the bytes of their
all-to-all blocks that went to another member).  A program without
them gives no count, and its readers give None."""

from __future__ import annotations

from importlib.util import find_spec

from harness.readers import share_of_window

SPANS = "meryl_tpu_torch.trace:LAST_SPANS"
STATS = "meryl_tpu_torch.parallel.shard_count:LAST_SHARD_STATS"


def _probes() -> list:
    try:
        found = all(find_spec(p.split(":")[0]) is not None
                    for p in (SPANS, STATS))
    except ImportError:
        found = False
    return [SPANS, STATS] if found else []


PROBES = _probes()


def sharded_counts(run) -> list:
    """(spans, stats) after each count command of the window that ran
    the sharded path to its end: the spans (reset by each command) hold
    shard.step, and the stats give the members."""
    if not PROBES:
        return []
    out = []
    for d in run.commands:
        if d.cmd.argv[0] != "count" or d.rc != 0:
            continue
        spans = d.probes.get(SPANS) or {}
        stats = d.probes.get(STATS) or {}
        if spans.get("shard.step_n") and stats.get("members"):
            out.append((spans, stats))
    return out


def member_seconds(spans: dict, stats: dict, keys) -> float:
    """The members' summed seconds of `keys` over the members: a mean
    member's."""
    return sum(spans.get(key, 0.0) for key in keys) / stats["members"]


def member_share(run, keys):
    """A mean member's seconds of `keys` over the window's sharded
    counts, as a % of the window; None where there is no such count."""
    counts = sharded_counts(run)
    if not counts:
        return None
    return share_of_window(run, sum(member_seconds(sp, st, keys)
                                    for sp, st in counts))
