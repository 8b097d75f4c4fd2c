"""Time the count reader's 2-bit pack, numpy against native, on the host.

    python -m meryl_tpu_torch.tools.ab_pack [--turns 3] [--reps 20]

One chunk of 2^22 codes like an Illumina count's (150-base reads, a
separator after each, 0.05 % N, from a fixed seed) is packed by both
arms of kmer.pack_codes_2bit:

  numpy   the plain version (kmer._pack_codes_numpy, what
          MERYL_TPU_NO_NATIVE selects)
  native  csrc/pack_host.cpp through ctypes, which releases the GIL

Each arm runs `reps` packs alone, then `reps` with a second Python
thread spinning on a counter: the GIL case, as on the count's reader
thread while the main thread dispatches.  A line of JSON an arm, case
and turn: the median and least ms a pack.  The arms run in turns, A B
then B A, and must give the same wire.  Prints the host's architecture
and cores first.  Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import threading
import time

import numpy as np

from .. import kmer as km

CHUNK = 1 << 22
SEED = 19


def illumina_chunk(n=CHUNK, seed=SEED):
    """n codes of 150-base reads, a separator after each, 0.05 % N."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.random(n) < 0.0005] = 255
    codes[150::151] = 255
    return codes


def _arm(name):
    if name == "numpy":
        return lambda codes: km._pack_codes_numpy(codes, len(codes))
    if km._native_pack() is None:
        raise RuntimeError("the native pack is not built (g++ missing, or "
                           "MERYL_TPU_NO_NATIVE set)")
    return km.pack_codes_2bit


class Spinner:
    """A Python thread that runs bytecode for as long as it is open."""

    def __init__(self):
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._spin, daemon=True)

    def _spin(self):
        n = 0
        while not self._stop.is_set():
            n += 1

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=5)
        if self._t.is_alive():
            raise RuntimeError("the spinner did not stop")


def time_arm(pack, codes, reps):
    """-> ms of each of `reps` packs of `codes`."""
    ms = []
    for _ in range(reps):
        t = time.perf_counter()
        pack(codes)
        ms.append((time.perf_counter() - t) * 1e3)
    return ms


def run(turns=3, reps=20):
    codes = illumina_chunk()
    arms = {name: _arm(name) for name in ("numpy", "native")}
    want = arms["numpy"](codes)
    got = arms["native"](codes)
    if not (all(np.array_equal(a, b) for a, b in zip(got[:2], want[:2]))
            and got[2] == want[2]):
        raise AssertionError("the native pack differs from numpy's")
    print(json.dumps({"machine": platform.machine(), "cores": os.cpu_count(),
                      "codes": len(codes), "exceptions":
                      int((want[1] != km.EXC_PAD).sum())}))
    records = []
    for turn in range(turns):
        order = ("numpy", "native") if turn % 2 == 0 else ("native", "numpy")
        for name in order:
            ms = time_arm(arms[name], codes, reps)
            with Spinner():
                ms_gil = time_arm(arms[name], codes, reps)
            for case, m in (("alone", ms), ("spinning", ms_gil)):
                rec = {"arm": name, "case": case, "turn": turn,
                       "ms_median": round(statistics.median(m), 4),
                       "ms_min": round(min(m), 4), "reps": reps}
                records.append(rec)
                print(json.dumps(rec))
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    run(args.turns, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
