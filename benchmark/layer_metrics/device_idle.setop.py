"""% of the traced window in which no operation ran on the device
(1 - the union of the device's kernel, copy and set intervals over the
window), torch.profiler."""

from harness.readers import idle_share

PROBES = []


def read(run):
    return idle_share(run)
