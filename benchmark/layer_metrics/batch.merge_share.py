"""The batched count's final merge (count_to_db_batched, span
count.batch_merge: the union-sum of the partial DBs through the set-op
evaluator, and the output DB's write) in the window's count jobs, as a
% of the window (LAST_BATCH_STATS["t_merge_s"], its whole seconds)."""

from harness.readers import counter_sum, share_of_window

PROBES = ["meryl_tpu_torch.counter:LAST_BATCH_STATS"]


def read(run):
    return share_of_window(run, counter_sum(run, PROBES[0], "t_merge_s",
                                            "count"))
