"""The sharded count's all-to-all against NVLink, %: the bytes of the
blocks every member sent to another member (LAST_SHARD_STATS
["peer_bytes"], summed over the window's sharded counts) over
LINK_BYTES_PER_S, against the device time of the trace's peer copies
(torch.profiler's "Memcpy PtoP (Device -> Device)").  That time also
holds the collectives' small copies (a step's stats all_reduce, a
merge's row maximum, finalize's all_gathers), whose bytes are not
counted: they lower the share."""

from harness import shard_spans

# NVLink 4 on an H100 SXM: 18 links of 25 GB/s each way, 450 GB/s out
# of a card (NVIDIA's H100 data sheet: 900 GB/s both ways)
LINK_BYTES_PER_S = 450e9
OPS = ["PtoP"]
PROBES = shard_spans.PROBES


def read(run):
    nbytes = sum(st.get("peer_bytes", 0)
                 for _, st in shard_spans.sharded_counts(run))
    if run.trace is None or not nbytes:
        return None
    sec = run.trace.seconds_of(OPS)
    if sec <= 0:
        return None
    return 100.0 * nbytes / LINK_BYTES_PER_S / sec
