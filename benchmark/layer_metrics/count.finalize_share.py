"""Finalize and download (DeviceAccCounter.finalize) of the window's
count jobs, as a % of the window (LAST_WIRE_STATS["t_finalize_s"])."""

from harness.readers import counter_sum, share_of_window

PROBES = ["meryl_tpu_torch.counter:LAST_WIRE_STATS"]


def read(run):
    return share_of_window(run, counter_sum(run, PROBES[0], "t_finalize_s",
                                            "count"))
