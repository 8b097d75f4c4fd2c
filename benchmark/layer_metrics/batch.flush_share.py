"""The batched count's flushes (count_to_db_batched, span
count.batch_flush: each batch's finalize, partial DB write and
manifest) in the window's count jobs, as a % of the window
(LAST_BATCH_STATS["t_flush_s"], the flushes' whole seconds)."""

from harness.readers import counter_sum, share_of_window

PROBES = ["meryl_tpu_torch.counter:LAST_BATCH_STATS"]


def read(run):
    return share_of_window(run, counter_sum(run, PROBES[0], "t_flush_s",
                                            "count"))
