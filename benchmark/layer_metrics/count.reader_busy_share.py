"""Reader thread (file scan and 2-bit pack, counter.prepack) busy time
of the window's count jobs, as a % of the window (the program's
LAST_WIRE_STATS["reader_busy_s"], set by each count)."""

from harness.readers import counter_sum, share_of_window

PROBES = ["meryl_tpu_torch.counter:LAST_WIRE_STATS"]


def read(run):
    return share_of_window(run, counter_sum(run, PROBES[0], "reader_busy_s",
                                            "count"))
