"""The program's host spans (meryl_tpu_torch.trace.LAST_SPANS: each
span's self seconds under "<name>_s", reset at each command) for the
per-layer readers.  A program without the module gives no probe, and
its readers give None."""

from __future__ import annotations

from importlib.util import find_spec

from harness.readers import counter_sum, share_of_window


def _probes() -> list:
    try:
        found = find_spec("meryl_tpu_torch.trace") is not None
    except ImportError:
        found = False
    return ["meryl_tpu_torch.trace:LAST_SPANS"] if found else []


PROBES = _probes()


def span_share(run, keys, argv0=None):
    """The summed seconds of `keys` over the window's commands whose
    first word is argv0 (every command where None), as a % of the
    window; None where no command refreshed them."""
    if not PROBES:
        return None
    parts = [counter_sum(run, PROBES[0], key, argv0) for key in keys]
    if None in parts:
        return None
    return share_of_window(run, sum(parts))
