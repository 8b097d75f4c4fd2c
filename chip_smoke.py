#!/usr/bin/env python3
"""Smoke run of meryl_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero:
  1. environment: torch / CUDA versions, the card's name and power limit
  2. build: the CUDA kernels, from the sources in this checkout
  3. kernel parity: the extraction kernel against its plain PyTorch
     version on the card at the production chunk (2^22 codes), every k
     class and mode, with timings at k=21
  4. main path: `meryl count k=21` (the entry point of
     `python -m meryl_tpu_torch`) on a ~70 Mbase FASTQ generated from a
     seed, with the production geometry, checked exactly against a
     numpy brute force
  5. the exactness hatches at small sizes, each against brute force
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Needs CUDA; imports no JAX.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
KS = [1, 15, 16, 21, 31, 32, 33, 48, 63, 64]
MODES = ["canonical", "forward", "reverse", "both"]
CHUNK = 1 << 22
GENOME = 4_641_652      # E. coli K-12 MG1655
READ_LEN = 150
COVERAGE = 15


def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}")


def phase_build(extract_cuda, native):
    t0 = time.perf_counter()
    extract_cuda.build()
    t1 = time.perf_counter()
    have_native = native.available()  # host scanner and k-way merge
    print(f"build: extract.cu in {t1 - t0:.2f} s; native host library "
          f"{'built' if have_native else 'UNAVAILABLE'} in "
          f"{time.perf_counter() - t1:.2f} s")


def _time_ms(torch, fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_kernel_parity(torch, km, ext, extract_cuda):
    """Kernel against the plain version on the card, same inputs."""
    rng = np.random.default_rng(SEED)
    codes = rng.integers(0, 4, size=CHUNK).astype(np.uint8)
    codes[rng.integers(0, CHUNK, size=CHUNK // 150)] = 255  # separators
    for s in rng.integers(0, CHUNK - 50, size=200):
        codes[s:s + int(rng.integers(1, 40))] = 255          # N runs
    codes[CHUNK - 1000:] = 255                               # n_real < L
    packed2, exc, n_real = km.pack_codes_2bit(codes)
    dev = torch.device("cuda")
    p = torch.from_numpy(packed2.view(np.int32)).to(dev)
    e = torch.from_numpy(exc).to(dev)
    max_err = 0
    for k in KS:
        for mode in MODES:
            got = extract_cuda.extract_kmers_packed(p, e, n_real, k, mode)
            want = ext.extract_kmers_packed(p, e, n_real, k, mode)
            torch.cuda.synchronize()
            if not torch.equal(got[-1], want[-1]):
                raise AssertionError(f"valid mask differs: k={k} {mode}")
            v = want[-1]
            for g, w in zip(got[:-1], want[:-1]):
                if v.any():
                    max_err = max(max_err,
                                  int((g[v] - w[v]).abs().max()))
                bad = (g[v] != w[v])
                if bad.any():
                    raise AssertionError(
                        f"keys differ at {int(bad.sum())} valid "
                        f"positions: k={k} {mode}")
    k, mode = 21, "canonical"
    ms = _time_ms(torch, lambda: extract_cuda.extract_kmers_packed(
        p, e, n_real, k, mode))
    plain_ms = _time_ms(torch, lambda: ext.extract_kmers_packed(
        p, e, n_real, k, mode))
    print(f"kernel parity: {len(KS) * len(MODES)} (k, mode) cases equal at "
          f"L={CHUNK} (n_real={n_real}, {int((exc < CHUNK).sum())} "
          f"exceptions); k=21 canonical kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    return max_err, ms, plain_ms


def _make_fastq(path, rng):
    """Random genome, 150 bp reads from both strands at 15x, 0.5 %
    substitutions, sprinkled N.  -> (n, 150) read codes (4 = N)."""
    genome = rng.integers(0, 4, size=GENOME).astype(np.uint8)
    n = COVERAGE * GENOME // READ_LEN
    starts = rng.integers(0, GENOME - READ_LEN + 1, size=n)
    reads = genome[starts[:, None] + np.arange(READ_LEN)]
    rev = rng.random(n) < 0.5
    reads[rev] = reads[rev, ::-1] ^ 2          # reverse complement
    sub = rng.random(reads.shape) < 0.005
    reads[sub] = (reads[sub] + rng.integers(1, 4, size=int(sub.sum()))
                  .astype(np.uint8)) % 4
    reads[rng.random(reads.shape) < 0.0005] = 4
    lut = np.frombuffer(b"ACTGN", np.uint8)
    rec = np.empty((n, 3 + READ_LEN + 3 + READ_LEN + 1), np.uint8)
    rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3:3 + READ_LEN] = lut[reads]
    rec[:, 3 + READ_LEN:6 + READ_LEN] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + READ_LEN:-1] = ord("I")
    rec[:, -1] = ord("\n")
    rec.tofile(path)
    return reads


def _brute_canonical(reads, k):
    """(n, len) codes (4 = N) -> sorted unique canonical k-mers, counts."""
    n, ln = reads.shape
    w = ln - k + 1
    c = reads.astype(np.uint64)
    f = np.zeros((n, w), np.uint64)
    r = np.zeros((n, w), np.uint64)
    for j in range(k):
        f = f * np.uint64(4) + (c[:, j:j + w] & np.uint64(3))
        r = r + ((c[:, j:j + w] & np.uint64(3)) ^ np.uint64(2)) \
            * np.uint64(4 ** j)
    bad = np.concatenate([np.zeros((n, 1), np.int32),
                          np.cumsum(reads == 4, axis=1, dtype=np.int32)],
                         axis=1)
    ok = (bad[:, k:] - bad[:, :w]) == 0
    return np.unique(np.minimum(f, r)[ok], return_counts=True)


def phase_main_path(torch, cli, counter, accum, extract_cuda, MerylDB,
                    workdir):
    rng = np.random.default_rng(SEED + 1)
    fq = os.path.join(workdir, "reads.fq")
    reads = _make_fastq(fq, rng)
    exp = counter.configure_counting([fq], 21)["expected_kmers"]
    plan = accum.plan_route(CHUNK, 21, exp)
    if (plan["L0"], plan["B"], plan["M"]) != (1 << 18, 1024, 8):
        raise AssertionError(f"not the production geometry: {plan}")
    db = os.path.join(workdir, "out.meryl")
    torch.cuda.reset_peak_memory_stats()
    extract_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    rc = cli.main(["count", "k=21", fq, "output", db])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = extract_cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise AssertionError(f"meryl-torch count exited {rc}")
    stats = dict(counter.LAST_WIRE_STATS)
    hi, lo, cts = MerylDB.open(db).load_all()
    want_k, want_c = _brute_canonical(reads, 21)
    if not (len(lo) == len(want_k) and (hi == 0).all()
            and np.array_equal(lo, want_k)
            and np.array_equal(cts.astype(np.int64),
                               want_c.astype(np.int64))):
        raise AssertionError(f"DB differs from brute force: {len(lo)} vs "
                             f"{len(want_k)} k-mers")
    if not (stats["chunks"] >= 1 and launches >= stats["chunks"]):
        raise AssertionError(f"extract kernel launches {launches} < "
                             f"chunks {stats['chunks']}")
    bases = int(reads.size)
    print(f"main path: {bases} input bases, {stats['chunks']} chunks, "
          f"{bases / wall / 1e6:.3f} Mbases/s ({wall:.3f} s wall incl. DB "
          f"write), {len(lo)} distinct k-mers equal to brute force; "
          f"merges {stats['merges']} regrows {stats['regrows']} recounts "
          f"{stats['recounts']} captured {stats['captured']} salvaged "
          f"{stats['salvaged']}; extract LAUNCHES {launches}; "
          f"max_memory_allocated {peak} B; geometry L0={plan['L0']} "
          f"B={plan['B']} M={plan['M']} c={plan['c']} La0={plan['La0']}")
    print("main path stats: " + json.dumps(stats, sort_keys=True))
    return launches


COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
CODE = {"A": 0, "C": 1, "T": 2, "G": 3}


def _brute(seqs, k, mode):
    out = {}
    for s in seqs:
        for i in range(len(s) - k + 1):
            w = s[i:i + k]
            if "N" in w:
                continue
            f = r = 0
            for ch in w:
                f = f * 4 + CODE[ch]
            for ch in reversed(w):
                r = r * 4 + CODE[COMP[ch]]
            key = {"canonical": min(f, r), "forward": f, "reverse": r}[mode]
            out[key] = out.get(key, 0) + 1
    return out


def phase_hatches(counter, workdir):
    rng = np.random.default_rng(SEED + 2)

    def rand(n, ln):
        return ["".join("ACTG"[c] for c in rng.integers(0, 4, ln))
                for _ in range(n)]

    cases = [
        # name, seqs, k, mode, chunk, expected uniques, env, stat check
        ("poly-A recount", ["A" * 5000, "G" * 40], 16, "forward", 1 << 13,
         None, {}, lambda s: s["recounts"] > 0),
        ("overflow capture", ["A" * 1850] + rand(30, 300), 21, "canonical",
         1 << 15, None, {},
         lambda s: s["captured"] > 0 and s["recounts"] == 0),
        ("regrow", rand(60, 400), 21, "canonical", 1 << 14, 64, {},
         lambda s: s["regrows"] > 0),
        ("AccCapacity salvage", rand(80, 400), 21, "canonical", 1 << 13, 64,
         {"MERYL_TPU_ACC_CAP_GB": "0.000002"}, lambda s: s["salvaged"]),
        ("poly-G all-ones k=16", rand(20, 200) + ["G" * 40, "G" * 16], 16,
         "forward", 1 << 15, None, {}, lambda s: True),
        ("poly-G all-ones k=32", rand(20, 200) + ["G" * 60, "G" * 32], 32,
         "forward", 1 << 15, None, {}, lambda s: True),
    ]
    done = []
    for name, seqs, k, mode, chunk, exp, env, check in cases:
        fa = os.path.join(workdir, "hatch.fa")
        with open(fa, "w") as f:
            for i, s in enumerate(seqs):
                f.write(f">s{i}\n{s}\n")
        saved = {kk: os.environ.get(kk) for kk in env}
        os.environ.update(env)
        try:
            exp = exp or counter._use_device_acc([fa], k, "cuda")
            hi, lo, c = counter.count_to_arrays_device_acc(
                [fa], k, mode, False, chunk, exp, device="cuda")
        finally:
            for kk, v in saved.items():
                if v is None:
                    os.environ.pop(kk, None)
                else:
                    os.environ[kk] = v
        got = {(int(h) << 64) | int(l): int(v)
               for h, l, v in zip(hi, lo, c)}
        stats = counter.LAST_WIRE_STATS
        if got != _brute(seqs, k, mode) or not check(stats):
            raise AssertionError(f"hatch {name!r} failed: {stats}")
        done.append(name)
    print("hatches: " + ", ".join(done) + " equal to brute force")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from meryl_tpu import kmer as km
    from meryl_tpu import native
    from meryl_tpu.db import MerylDB
    from meryl_tpu_torch import cli, counter
    from meryl_tpu_torch.ops import accum, extract_cuda
    from meryl_tpu_torch.ops import extract as ext

    phase_env(torch)
    phase_build(extract_cuda, native)
    max_err, ms, plain_ms = phase_kernel_parity(torch, km, ext,
                                                extract_cuda)
    workdir = tempfile.mkdtemp(prefix="meryl_torch_smoke_")
    try:
        launches = phase_main_path(torch, cli, counter, accum,
                                   extract_cuda, MerylDB, workdir)
        phase_hatches(counter, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"kernels": [{
        "name": "extract_kmers_packed", "route": "cuda",
        "source": "meryl_tpu_torch/csrc/extract.cu",
        "replaces": "meryl_tpu/ops/extract_pallas.py:136",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
