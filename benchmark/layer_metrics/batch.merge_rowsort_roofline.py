"""The row sort (csrc/rowsort.cu, bitonic_keys_kernel) of the batched
count's final union-sum against its memory bound, %.

Bytes: every input entry of the merge (LAST_BATCH_STATS
["merge_entries"], the partial DBs' entries) is an int64 key, an int64
value and an int32 input id, read once and written once, 40 B, as
rowsort_roofline reckons them.  Time is the device time of the kernels
named below over the window; the count phase launches no row sort, so
in a batched count's window it is all the merge's."""

from harness.readers import counter_sum, roofline

KERNELS = ["bitonic_keys_kernel"]
PROBES = ["meryl_tpu_torch.counter:LAST_BATCH_STATS"]
BYTES_PER_ENTRY = 2 * (8 + 8 + 4)


def read(run):
    entries = counter_sum(run, PROBES[0], "merge_entries", "count")
    if entries is None:
        return None
    return roofline(run, KERNELS, int(BYTES_PER_ENTRY * entries))
