"""The extraction kernel (csrc/extract.cu) against its memory bound, %.

Bytes come from the input, so they do not move when the wire format
does: each read is its bases and one boundary; in, 2 bits a position
and 4 B for each N or boundary (an exception of the wire); out, one
8-byte canonical key (k <= 32) and one valid byte a position.  Time is
the device time of the kernels named below, over the window's count
jobs."""

from harness.readers import roofline

KERNELS = ["extract_kernel"]
PROBES = []


def job_bytes(bases: int, reads: int, n_bases: int) -> int:
    positions = bases + reads
    return -(-2 * positions // 8) + 4 * (n_bases + reads) + 9 * positions


def read(run):
    nbytes = sum(job_bytes(d.work["bases"], d.work["reads"],
                           d.work["n_bases"])
                 for d in run.commands if d.cmd.argv[0] == "count")
    return roofline(run, KERNELS, nbytes)
