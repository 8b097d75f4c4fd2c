"""The set-op row sort (csrc/rowsort.cu, bitonic_keys_kernel) against
its memory bound, %.

Bytes come from the reference's sizes of each command's input
databases, not from the program's padded rows: every input entry is an
int64 key, an int64 value and an int32 input id (as
ops/rowsort.sort_rows takes them), read once and written once, 40 B.
Time is the device time of the kernels named below over the window."""

from harness.readers import roofline

KERNELS = ["bitonic_keys_kernel"]
PROBES = []
BYTES_PER_ENTRY = 2 * (8 + 8 + 4)


def read(run):
    nbytes = BYTES_PER_ENTRY * sum(d.work["entries"] for d in run.commands)
    return roofline(run, KERNELS, nbytes)
