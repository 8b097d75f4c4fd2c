"""Time the accumulator's downloads against each other on the card.

    python -m meryl_tpu_torch.tools.ab_download READS [--k 21] [--turns 3]

READS is a FASTA/FASTQ file (chip_smoke.py passes the one it generates).
Three arms download the same accumulator:

  pageable-int64  the key words and the int64 counts, each with
                  `.cpu()` into pageable host memory (the port's first
                  download; its code is kept here, the package no longer
                  has it)
  pinned-int32    DeviceAccCounter._download_dense: the used entries
                  compacted on the device, their key words and 32-bit
                  counts in one device buffer, one copy into a pinned
                  host buffer
  packed          DeviceAccCounter._download_packed: one 32-bit word a
                  unique (gap + count), exceptions beside it, one copy,
                  decoded on the host

For each arm of each turn a new DeviceAccCounter is fed the file's
chunks at the production chunk size (untimed) and finalize() is timed
with that arm as its download; the arms run in turns, A B C then C B A.
A line of JSON an arm and turn: the download's wall ms (device pack,
copy, synchronize and host decode: what finalize waits for; its
count.download span), the bytes it shipped and their GB/s over that
wall, the seconds blocked in fetches and the host decode seconds
(finalize's count.fetch and count.host_decode spans, from
trace.LAST_SPANS), and finalize's wall.  Turn 0 of the
pinned arms includes the allocation of the pinned buffer, which later
turns find cached.  Every arm must decode to the same arrays.  Prints
the card's name and power limit first.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .. import counter, trace
from ..io.sequence import SequenceChunker
from ..ops import multiword as mw

ARMS = ("pageable-int64", "pinned-int32", "packed")


def download_pageable_int64(acc):
    """The download of the port's first slices: two `.cpu()` copies into
    pageable memory, counts as int64."""
    lmax = acc.download_lmax()
    keys = acc._acc[0][:, :lmax].reshape((-1,) + acc._tail()).cpu().numpy()
    counts = acc._acc[1][:, :lmax].reshape(-1).cpu().numpy()
    acc.wire_d2h_bytes += keys.nbytes + counts.nbytes
    keepm = counts > 0
    hi, lo = mw.to_hilo(keys[keepm], acc.k)
    return hi, lo, counts[keepm].astype(np.uint64)


def fed_counter(paths, k, chunk_len, device):
    """A DeviceAccCounter that has seen every chunk of `paths`."""
    exp = counter._use_device_acc(paths, k, device) or \
        counter.expected_kmers(paths)
    acc = counter.DeviceAccCounter(k, "canonical", chunk_len, exp, device)
    for chunk in SequenceChunker(paths, k, chunk_len):
        acc.add_codes(chunk)
    return acc


def run_arm(arm, paths, k, chunk_len, device):
    """-> (record, finalize()'s arrays) of one arm on a fresh counter."""
    acc = fed_counter(paths, k, chunk_len, device)
    saved = os.environ.get("MERYL_TPU_PACK_D2H")
    if arm == "pageable-int64":
        acc.download = lambda: download_pageable_int64(acc)
    else:
        os.environ["MERYL_TPU_PACK_D2H"] = "1" if arm == "packed" else "0"
        if arm == "packed":
            packed = acc._download_packed

            def must_pack(lmax):
                run = packed(lmax)
                if run is None:
                    raise RuntimeError("the packed download bowed out to "
                                       "the dense one on this input")
                return run
            acc._download_packed = must_pack
    try:
        spans0 = dict(trace.LAST_SPANS)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = acc.finalize()
        t_fin = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("MERYL_TPU_PACK_D2H", None)
        else:
            os.environ["MERYL_TPU_PACK_D2H"] = saved
    spans = trace.since(spans0)
    ms = acc.download_s * 1e3
    return {"arm": arm, "download_ms": ms,
            "d2h_bytes": acc.wire_d2h_bytes,
            "GB_per_s": acc.wire_d2h_bytes / ms / 1e6,
            "t_fetch_s": spans.get("count.fetch_s", 0.0),
            "host_decode_s": spans.get("count.host_decode_s", 0.0),
            "t_finalize_s": t_fin, "kmers": len(out[2])}, out


def run(paths, k=21, turns=3, chunk_len=None, device="cuda"):
    """All arms in turns -> list of records; raises when two arms decode
    differently."""
    device = counter.resolve_device(device)
    chunk_len = chunk_len or counter.default_chunk()
    first = None
    records = []
    for turn in range(turns):
        for arm in (ARMS if turn % 2 == 0 else ARMS[::-1]):
            rec, out = run_arm(arm, paths, k, chunk_len, device)
            rec["turn"] = turn
            if first is None:
                first = out
            elif not all(np.array_equal(a, b) for a, b in zip(first, out)):
                raise AssertionError(f"{arm} decodes differently from "
                                     f"{records[0]['arm']}")
            records.append(rec)
            print(json.dumps(rec))
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("reads", nargs="+")
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_download: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    run(args.reads, args.k, args.turns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
