#!/usr/bin/env python3
"""Smoke run of meryl_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero:
  1. environment: torch / CUDA versions, the card's name and power limit
  2. build: the CUDA kernels (one nvcc per source, all started together),
     the native host library and the native 2-bit pack, from the
     sources in this checkout
  3. extract parity: the extraction kernel against its plain PyTorch
     version at the production chunk (2^22 codes), every k class and
     mode; then, at k=21 and 33 canonical and k=64 "both", the kernel
     alone (raw launches into preallocated outputs, rotating over more
     output bytes than the L2 holds), the call as the count path makes
     it, the bound (bytes moved over 3.35 TB/s) and the share of it
  4. rowsort parity: the bitonic row sort on int32 rows (the probe's
     shape, 2^13 rows of 2048) and on synthetic set-op rows (256 rows of
     5120, k = 16, 21, 32, 33: keys shared by two inputs, sentinel
     padding that aliases the all-ones k-mer at k = 16 and 32), and the
     pass floor (also on odd, short and misaligned shapes, at 66 and 0
     passes), each against its plain version, exactly, with times; the
     pass floor beside torch.sort of its pairs (its library yardstick)
     and its passes sweep (the kernel alone at 1, 16, 33 and 66 passes,
     with the least-squares slope a pass)
  5. the probe (scripts/probe_r4_pallas_sort.py's question, on the
     card): ns/element of torch.sort (A), the plain two-word sort (B),
     the bitonic kernel (C) and the pass floor (D), and whether D lies
     below C
  6. count path: `meryl count k=21` through the CLI on a ~70 Mbase
     FASTQ generated from a seed, with the production geometry, checked
     exactly against a numpy brute force; every chunk packed natively
  7. the exactness hatches at small sizes, each against brute force
  8. set-op path: a second read set of the same genome with 0.1 % SNPs
     is counted, then a Merqury-style sequence of set operations runs
     through the CLI on the two ~10.5 M k-mer DBs; every output DB is
     held against a numpy brute force over the two decoded inputs; then
     the set-op row sort against its plain version on the rows the path
     packs (the first bucket group of `union-sum a b`), exactly, timed
  9. batched count: phase 6's FASTQ again with a `memory=` that the plan
     turns into several batches, and `threads=`; the batch DBs and the
     manifest exist while it runs and are gone after it, the DB equals
     phase 6's, and both the extraction kernel and the set-op row sort
     (the final union-sum of the batch DBs) were launched; then a
     resume from a manifest that says batch 0 is done, with that
     batch's DB kept: an equal DB, and batch 0 not counted again.  The
     batched count's rate and layers are measured by the benchmark's
     cell `ecoli-k12-illumina-k21.count-batched` (memory=1, 3 batches)
 10. count-suffix and the host sort path on a subsample of the reads
     (at the production chunk), against a numpy brute force; the host
     path's peak device bytes a base beside the plan's model
 11. `-C`: the plan on stderr, the card's own memory in it, nothing
     counted
 12. accumulator memory: the device-accumulator count's peak device
     bytes at two input sizes, beside the admission budget's bytes a
     unique
 14. lookup: every meryl-lookup mode through the CLI with phase 6's
     genome as the assembly and 20,000 reads (and as many mates) of
     phase 6's FASTQ, against DBs a and b (b with -min 2 for -include /
     -exclude), and position-lookup of the reads against a DB counted
     from the genome; each output against a numpy brute force over the
     decoded DBs; the extraction kernel's launches over these runs, each
     run's own above 0 (position-lookup's DB is counted before they
     start); the table's device bytes beside estimate_memory_bytes; then
     2^23 queries, half hits, against DB a and a 2^16-entry table through
     each regime (values_bulk's binary search on the device-resident
     table, values_host, and the segmented grid join on the table held
     past a device budget forced low), Mq/s a regime
 15. meryl2 (run before 14): phase 6's and phase 8's
     read sets counted through meryl2-torch with labels #1 and #2 (equal
     to the v1 counts), then actions over the two labelled DBs --
     union-sum (also equal to phase 8's v1 union-sum), intersect with
     value=min label=xor, a `not select:input:@2`, a value: and a bases:
     selector, a saturating value=mul#2^28 -- and a 7-input union-sum
     over slices of DB a (the flat scan path), each output DB against a
     numpy brute force; histogram and statistics; wall and M input
     entries/s a command, the row sort's launches a row-packed command
     (equal to its row-packed dispatches); then union-sum row-packed and
     flat in turns with the time of each layer of the CLI's path, and
     last one union-sum under torch.profiler in a process of its own
     (device busy share, top device ops)
 16. multi-GPU counting on the one card (runs after 14):
     `MERYL_TPU_SHARDED=1 meryl-torch count` of phase 6's FASTQ in a
     1-rank NCCL group (one_rank_group, the path of a launcher job's
     rank) at full width (2^22 bases a step), its DB equal
     to phase 6's, wall and Mbases/s beside phase 6's, the hatch stats,
     the extraction kernel's launches and the peak device memory; the
     same count with each layer of its step timed (route, the
     all_to_all_single, the owner merge, settle), which gives the
     scaling model's t_local and t_merge; count_to_db_multihost in a
     1-rank group (the same DB, no parts directory left); and
     dryrun_multichip(1, "cuda", job=True) walking the three hatches
 17. multi-GPU counting in one process (after 16): count_to_arrays_sharded
     of phase 6's FASTQ over 4 members on cuda:0 (one thread each, the
     machine having one card) at full width, equal to phase 6's DB, wall
     and Mbases/s beside phase 6's, the extraction kernel's launches
     (4 members x the steps), the peak device memory, whether peer
     access is on and the hatch stats; the same count with the route,
     the exchange and the owner merge timed a call; the CLI's
     MERYL_TPU_SHARDED=1 count over every visible card (equal DB); and
     the in-process dryrun_multichip(1, "cuda") and dryrun_devices over
     the 4 members, each walking the three hatches
 18. a job's process of several devices (after 17):
     count_to_db_multihost of phase 6's FASTQ over a JobGroup of 4
     members on cuda:0 in a 1-rank NCCL group (one NCCL rank x 4
     threads: the machine has one card) at full width, its DB equal to
     phase 6's, wall and Mbases/s beside phase 6's, the extraction
     kernel's launches (4 members x the steps), the peak device memory
     and the hatch stats; the same count with the route, the two-level
     exchange's local gather, NCCL all_to_all_single and local scatter,
     and the owner merge timed a call; and dryrun_devices over the same
     group (job=True), walking the three hatches
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Needs CUDA; imports no JAX.
"""

import contextlib
import filecmp
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
KS = [1, 15, 16, 21, 31, 32, 33, 48, 63, 64]
MODES = ["canonical", "forward", "reverse", "both"]
CHUNK = 1 << 22
GENOME = 4_641_652      # E. coli K-12 MG1655
READ_LEN = 150
COVERAGE = 15
SNP_RATE = 0.001
PROBE_ROWS, PROBE_LEN, PROBE_STEPS = 1 << 13, 2048, 2
SETOP_ROWS, SETOP_LEN = 256, 5120
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
# H100 SXM float32 rate outside the tensor cores (NVIDIA's data sheet);
# no int32 rate is published, and the pass floor's min/max are int32
ALU_OPS_PER_S = 67e12


def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}")
    return smi


def phase_build(kernel_modules, native):
    """Every kernel library and the native host libraries at once."""
    from meryl_tpu_torch import kmer
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    jobs = {name: mod.build for name, mod in kernel_modules.items()}
    jobs["native host library"] = native.available
    jobs["native 2-bit pack"] = kmer._native_pack
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {name: pool.submit(timed, fn) for name, fn in jobs.items()}
        secs = {name: f.result() for name, f in futs.items()}
    have_native = native.available()  # host scanner and k-way merge
    print("build: " + "; ".join(f"{n} in {s:.2f} s" for n, s in secs.items())
          + ("" if have_native else " (native host library UNAVAILABLE)")
          + ("" if kmer._native_pack() else " (native 2-bit pack UNAVAILABLE)"))


def _time_ms(torch, fn, reps=20):
    """ms a call of fn: CUDA events over reps calls after a warm-up."""
    from meryl_tpu_torch.tools.ab_extract import time_calls
    return time_calls(fn, reps)[0]


def _bound_ms(nbytes, ops=0):
    """The least time for the work: bytes over the memory rate, or
    operations over the ALU rate, whichever is larger -> (ms, by)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _extract_bytes(p, e, L, k, mode):
    """Bytes the extraction must move: the packed words, the exception
    entries inside [0, L) (the padding is never needed), the keys and
    the valid bytes."""
    n_exc = int((e < L).sum())
    words = (2 if mode == "both" else 1) * (1 if k <= 32 else 2)
    return p.numel() * 4 + n_exc * 4 + words * 8 * L + L


def phase_kernel_parity(torch, ext, extract_cuda, ab_extract):
    """Kernel against the plain version on the card, same inputs; then
    its times beside its bound.  The chunk has a separator every ~150
    codes, 200 N runs and a trailing separator run (n_real < L)."""
    packed2, exc, n_real = ab_extract.chunk_wire(CHUNK, SEED)
    dev = torch.device("cuda")
    p = torch.from_numpy(packed2.view(np.int32)).to(dev)
    e = torch.from_numpy(exc).to(dev)
    max_err = 0
    for k in KS:
        for mode in MODES:
            before = extract_cuda.LAUNCHES
            got = extract_cuda.extract_kmers_packed(p, e, n_real, k, mode)
            if extract_cuda.LAUNCHES != before + 1:
                raise AssertionError("an extraction call is not one launch")
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
    print(f"extract parity: {len(KS) * len(MODES)} (k, mode) cases equal at "
          f"L={CHUNK} (n_real={n_real}, {int((exc < CHUNK).sum())} "
          f"exceptions in a list of {len(exc)}), one launch a call")
    times = {}
    for k, mode in ab_extract.TIMED:
        # raw launches of the C entry point into preallocated outputs,
        # more than the L2 holds: no Python checks, no allocation
        alone, host = ab_extract.time_alone(
            extract_cuda._lib().mt_extract_packed, p, e, n_real, k, mode)
        call, call_host = ab_extract.time_calls(
            lambda: extract_cuda.extract_kmers_packed(p, e, n_real, k, mode))
        plain = _time_ms(torch, lambda: ext.extract_kmers_packed(
            p, e, n_real, k, mode))
        nbytes = _extract_bytes(p, e, CHUNK, k, mode)
        bound, by = _bound_ms(nbytes)
        times[(k, mode)] = dict(alone=alone, call=call, plain=plain,
                                bound=bound, by=by)
        print(f"extract k={k} {mode}: kernel alone {alone:.4f} ms (host "
              f"{host:.4f} ms a raw launch), call {call:.4f} ms (host "
              f"{call_host:.4f} ms a call), plain "
              f"{plain:.4f} ms, bound {bound:.4f} ms ({nbytes} B over "
              f"3.35 TB/s), kernel alone at {100 * bound / alone:.1f} % "
              f"of the bound, call at {100 * bound / call:.1f} %")
    return max_err, times


def _probe_rows(torch, rng, rows):
    return torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, size=(rows, PROBE_LEN),
        dtype=np.int64).astype(np.int32)).cuda()


def _setop_rows(torch, mw, rng, k):
    """(R, L) set-op rows as the packer builds them: per row, two
    sorted inputs drawn from one sorted key pool (so most keys appear
    in both), then sentinel padding with value 0 and input id 2.  Where
    the sentinel aliases the all-ones k-mer (k = 16, 32), every 8th row
    holds that k-mer in both inputs."""
    R, L = SETOP_ROWS, SETOP_LEN
    n_pool, n0, n1 = 2600, 2400, 2300
    nw = mw.num_words(k)
    sent = np.array(mw.sentinel_words(k), np.int64)
    allones = mw.from_hilo(*[np.array([w], np.uint64) for w in
                             mw.sentinel_hilo(k)], k)[0]
    bits = 2 * k
    raw = [rng.integers(0, 1 << min(bits, 62), size=(R, n_pool),
                        dtype=np.uint64)]
    if nw == 2:
        raw = [rng.integers(0, 1 << (bits - 64), size=(R, n_pool),
                            dtype=np.uint64), raw[0]]
    words = [(w ^ np.uint64(1 << 63)).view(np.int64) for w in raw]
    pool = np.stack(words, axis=-1)                 # (R, n_pool, nw)
    aliased = bits % 32 == 0
    if aliased:
        pool[::8, -1] = allones
    order = np.lexsort(tuple(pool[..., q] for q in range(nw - 1, -1, -1)))
    pool = np.take_along_axis(pool, order[..., None], axis=1)
    key = np.empty((R, L, nw), np.int64)
    key[:] = sent
    vals = np.zeros((R, L), np.int64)
    ids = np.full((R, L), 2, np.int32)
    pos = 0
    for i, n in enumerate((n0, n1)):
        pick = np.sort(np.argsort(rng.random((R, n_pool)), axis=1)[:, :n],
                       axis=1)
        if aliased:
            pick[::8, -1] = n_pool - 1              # the all-ones k-mer
        key[:, pos:pos + n] = np.take_along_axis(pool, pick[..., None], 1)
        v = rng.integers(1, 60, size=(R, n))
        big = rng.random((R, n)) < 0.01
        v[big] = (1 << 32) - 1
        vals[:, pos:pos + n] = v
        ids[:, pos:pos + n] = i
        pos += n
    if nw == 1:
        key = key[..., 0]
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in (key, vals, ids)]


def phase_rowsort_parity(torch, mw, rowsort, ab_passfloor):
    rng = np.random.default_rng(SEED + 5)
    x = _probe_rows(torch, rng, PROBE_ROWS)
    got = rowsort.bitonic_rows(x)
    want = rowsort.bitonic_rows_plain(x)
    torch.cuda.synchronize()
    err_a = int((got.long() - want.long()).abs().max())
    pf = rowsort.pass_floor(x)
    pf_want = rowsort.pass_floor_plain(x)
    pairs_sorted = torch.sort(x.view(PROBE_ROWS, PROBE_LEN // 2, 2),
                              dim=-1).values.view(PROBE_ROWS, PROBE_LEN)
    torch.cuda.synchronize()
    err_d = int((pf.long() - pf_want.long()).abs().max())
    if not torch.equal(pairs_sorted, pf_want):
        raise AssertionError("torch.sort of the pairs differs from the pass "
                             "floor's plain version")
    # odd, short and misaligned shapes, 66 passes and 0 (raw launches of
    # the C entry point: they do not count)
    floor_fn = rowsort._lib().mt_pass_floor
    ab_passfloor.check_shapes(floor_fn)
    errs_b = {}
    for k in (16, 21, 32, 33):
        key, vals, ids = _setop_rows(torch, mw, rng, k)
        got = rowsort.sort_rows(key, vals, ids, k)
        want = rowsort.sort_rows_plain(key, vals, ids, k)
        torch.cuda.synchronize()
        errs_b[k] = max(int((g.long() - w.long()).abs().max())
                        for g, w in zip(got, want))
    if err_a or err_d or any(errs_b.values()):
        raise AssertionError(f"row sorts differ from their plain versions: "
                             f"bitonic int32 {err_a}, pass floor {err_d}, "
                             f"set-op rows {errs_b}")
    key, vals, ids = _setop_rows(torch, mw, rng, 21)
    t = {
        "a": _time_ms(torch, lambda: rowsort.bitonic_rows(x)),
        "a_plain": _time_ms(torch, lambda: rowsort.bitonic_rows_plain(x)),
        "a_library": _time_ms(torch, lambda: torch.sort(x, dim=-1)),
        "b": _time_ms(torch, lambda: rowsort.sort_rows(key, vals, ids, 21)),
        "b_plain": _time_ms(torch, lambda: rowsort.sort_rows_plain(
            key, vals, ids, 21)),
        "d": _time_ms(torch, lambda: rowsort.pass_floor(x)),
        "d_plain": _time_ms(torch, lambda: rowsort.pass_floor_plain(x)),
        "d_library": _time_ms(torch, lambda: torch.sort(
            x.view(PROBE_ROWS, PROBE_LEN // 2, 2), dim=-1)),
    }
    print(f"rowsort parity: bitonic int32 ({PROBE_ROWS} x {PROBE_LEN}) equal "
          f"to torch.sort; set-op rows ({SETOP_ROWS} x {SETOP_LEN}, "
          f"k = 16 21 32 33) equal to the plain stable sort, payloads "
          f"included; pass floor equal to its plain version (and to "
          f"torch.sort of the pairs) at {PROBE_ROWS} x {PROBE_LEN} and on "
          f"odd, short and misaligned shapes at 66 and 0 passes")
    # the sweep: raw launches of the C entry point at several pass counts
    # over two input sets (more than the L2 holds); every pass must cost
    xs = [x, _probe_rows(torch, rng, PROBE_ROWS)]
    sweep_ms, slope, icpt = ab_passfloor.sweep(floor_fn, xs)
    t["d_alone"] = sweep_ms[rowsort.FLOOR_PASSES]
    print("pass floor sweep (kernel alone, ms): " + ", ".join(
        f"{p} passes {ms:.4f}" for p, ms in sweep_ms.items())
        + f"; least-squares slope {slope * 1e3:.4f} us a pass, intercept "
        f"{icpt:.4f} ms")
    if not slope > 0:
        raise AssertionError(f"the pass floor's time does not grow with "
                             f"its passes: {sweep_ms}")
    # the int32 sort's bound counts n log2(L) compares, the pass floor's
    # its 66 passes of a min and a max on every pair: the work its
    # kernel does, though the passes after the first change nothing
    n, io_bytes = x.numel(), 2 * x.numel() * x.element_size()
    t["a_bound"] = _bound_ms(io_bytes, n * np.log2(PROBE_LEN))
    t["d_bound"] = _bound_ms(io_bytes, 66 * n)
    # the floor of the integer issue: 66 min/max a pair-element, at 64 a
    # clock an SM (the ALU pipe's rate for min/max) and the card's clock
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t["d_issue"] = 66 * n / (64 * sms * mhz * 1e6) * 1e3
    print(f"pass floor integer-issue floor {t['d_issue']:.4f} ms (66 x {n} "
          f"min/max at 64 a clock an SM, {sms} SMs, {mhz:.0f} MHz); kernel "
          f"alone at {100 * t['d_issue'] / t['d_alone']:.1f} % of it")
    print(f"rowsort times: bitonic int32 kernel {t['a']:.4f} ms, plain "
          f"{t['a_plain']:.4f} ms, torch.sort {t['a_library']:.4f} ms, "
          f"bound {t['a_bound'][0]:.4f} ms ({t['a_bound'][1]}); set-op rows "
          f"k=21 kernel {t['b']:.4f} ms, plain {t['b_plain']:.4f} ms; pass "
          f"floor call {t['d']:.4f} ms (alone {t['d_alone']:.4f} ms), plain "
          f"{t['d_plain']:.4f} ms, torch.sort of the pairs "
          f"{t['d_library']:.4f} ms, bound {t['d_bound'][0]:.4f} ms "
          f"({t['d_bound'][1]}), alone at "
          f"{100 * t['d_bound'][0] / t['d_alone']:.1f} % of the bound")
    return err_a, max(errs_b.values()), err_d, t


def phase_probe(torch, mw, rowsort):
    """The probe's four measurements, over PROBE_STEPS x PROBE_ROWS rows
    of PROBE_LEN int32 (two planes for B)."""
    rng = np.random.default_rng(SEED + 6)
    rows = PROBE_STEPS * PROBE_ROWS
    n = rows * PROBE_LEN
    x = _probe_rows(torch, rng, rows)
    x2 = torch.stack([_probe_rows(torch, rng, rows).long(), x.long()],
                     dim=-1).contiguous()            # (rows, L, 2) words
    rowsort.LAUNCHES = rowsort.PASS_FLOOR_LAUNCHES = 0
    ns = {
        "A torch.sort 1-plane": _time_ms(
            torch, lambda: torch.sort(x, dim=-1), reps=10),
        "B plain two-word sort": _time_ms(
            torch, lambda: mw.sort(x2, 33), reps=10),
        "C bitonic kernel 1-plane": _time_ms(
            torch, lambda: rowsort.bitonic_rows(x), reps=10),
        "D pass floor (66 passes)": _time_ms(
            torch, lambda: rowsort.pass_floor(x), reps=10),
    }
    launches = rowsort.LAUNCHES, rowsort.PASS_FLOOR_LAUNCHES
    c, d = (ns[k] for k in ("C bitonic kernel 1-plane",
                            "D pass floor (66 passes)"))
    print("probe (ns/element over " f"{n} int32 elements): " + "; ".join(
        f"{name} {ms * 1e6 / n:.4f}" for name, ms in ns.items())
        + f"; the floor D is {'below' if d < c else 'NOT below'} the "
        f"network C (D/C {d / c:.3f})")
    return launches


def _make_genome(rng):
    return rng.integers(0, 4, size=GENOME).astype(np.uint8)


def _make_fastq(path, genome, rng):
    """150 bp reads of `genome` from both strands at 15x, 0.5 %
    substitutions, sprinkled N.  -> (n, 150) read codes (4 = N)."""
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
    genome = _make_genome(rng)
    fq = os.path.join(workdir, "reads.fq")
    reads = _make_fastq(fq, genome, rng)
    exp = counter.configure_counting([fq], 21)["expected_kmers"]
    plan = accum.plan_route(CHUNK, 21, exp)
    if (plan["L0"], plan["B"], plan["M"]) != (1 << 18, 1024, 8):
        raise AssertionError(f"not the production geometry: {plan}")
    db = os.path.join(workdir, "a.meryl")
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
    if stats["native_packs"] != stats["chunks"] + stats["recounts"]:
        raise AssertionError(f"native 2-bit packs {stats['native_packs']} "
                             f"!= chunks {stats['chunks']} + recounts "
                             f"{stats['recounts']}")
    bases = int(reads.size)
    print(f"count path: {bases} input bases, {stats['chunks']} chunks, "
          f"{bases / wall / 1e6:.3f} Mbases/s ({wall:.3f} s wall incl. DB "
          f"write), {len(lo)} distinct k-mers equal to brute force; "
          f"merges {stats['merges']} regrows {stats['regrows']} recounts "
          f"{stats['recounts']} captured {stats['captured']} salvaged "
          f"{stats['salvaged']}; native packs {stats['native_packs']}; "
          f"extract LAUNCHES {launches}; "
          f"max_memory_allocated {peak} B; geometry L0={plan['L0']} "
          f"B={plan['B']} M={plan['M']} c={plan['c']} La0={plan['La0']}")
    print("count path stats: " + json.dumps(stats, sort_keys=True))
    return launches, genome, db, fq, reads, peak, wall


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


# ------------------------------------------------------------ set ops

def _setop_brute(a, b):
    """Expected (k-mers, values) of each set-op command, from the two
    decoded inputs (sorted unique uint64 k-mers and their counts),
    independent of both packages."""
    (la, ca), (lb, cb) = a, b
    ca, cb = ca.astype(np.int64), cb.astype(np.int64)
    in_b = np.isin(la, lb, assume_unique=True)
    u = np.union1d(la, lb)
    us = np.zeros(len(u), np.int64)
    us[np.searchsorted(u, la)] += ca
    us[np.searchsorted(u, lb)] += cb
    common, ia, ib = np.intersect1d(la, lb, assume_unique=True,
                                    return_indices=True)
    cb_at_a = np.zeros(len(la), np.int64)
    cb_at_a[ia] = cb[ib]
    sub = np.where(in_b, ca - cb_at_a, ca)
    keep_sub = ~in_b | (ca > cb_at_a)
    nested = (ca > 1) & ~in_b
    return {
        "union-sum": (u, us & 0xFFFFFFFF),
        "intersect-min": (common, np.minimum(ca[ia], cb[ib])),
        "difference": (la[~in_b], ca[~in_b]),
        "solid": (la[ca > 1], ca[ca > 1]),
        "nested": (la[nested], ca[nested]),
        "subtract": (la[keep_sub], sub[keep_sub]),
    }


def phase_setops(torch, cli, optree, rowsort, MerylDB, genome, db_a,
                 workdir, device="cuda"):
    """Count a second read set, then the Merqury-style sequence."""
    rng = np.random.default_rng(SEED + 3)
    g2 = genome.copy()
    snp = rng.random(GENOME) < SNP_RATE
    g2[snp] = (g2[snp] + rng.integers(1, 4, size=int(snp.sum()))
               .astype(np.uint8)) % 4
    fq = os.path.join(workdir, "reads_b.fq")
    _make_fastq(fq, g2, rng)
    db_b = os.path.join(workdir, "b.meryl")
    t0 = time.perf_counter()
    if cli.main(["count", "k=21", fq, "output", db_b,
                 f"device={device}"]) != 0:
        raise AssertionError("counting the second read set failed")
    print(f"set-op inputs: b = {int(snp.sum())} SNPs, counted in "
          f"{time.perf_counter() - t0:.3f} s")

    def decode(path):
        hi, lo, c = MerylDB.open(path).load_all()
        if (hi != 0).any():
            raise AssertionError(f"{path}: k=21 k-mers with hi bits")
        return lo, c
    a, b = decode(db_a), decode(db_b)
    want = _setop_brute(a, b)
    out = lambda name: os.path.join(workdir, name + ".meryl")  # noqa: E731
    cmds = [
        ("union-sum", ["union-sum", db_a, db_b, "output", out("u")]),
        ("intersect-min", ["intersect-min", db_a, db_b, "output",
                           out("imin")]),
        ("difference", ["difference", db_a, db_b, "output", out("diff")]),
        ("solid", ["[greater-than", "1", db_a, "output", out("solid") + "]"]),
        ("nested", ["intersect", "[greater-than", "1", db_a + "]",
                    "[difference", db_a, db_b + "]", "output",
                    out("nested")]),
        ("subtract", ["subtract", db_a, db_b, "output", out("sub")]),
    ]
    outs = {"union-sum": "u", "intersect-min": "imin", "difference": "diff",
            "solid": "solid", "nested": "nested", "subtract": "sub"}
    rowsort.LAUNCHES = 0
    total_entries, total_wall = 0, 0.0
    for name, argv in cmds:
        optree.reset_stats()
        before = rowsort.LAUNCHES
        t0 = time.perf_counter()
        rc = cli.main(argv + [f"device={device}"])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rowsort.LAUNCHES - before
        if rc != 0:
            raise AssertionError(f"{' '.join(argv)} exited {rc}")
        hi, lo, c = MerylDB.open(out(outs[name])).load_all()
        wk, wv = want[name]
        if not (len(lo) == len(wk) and (hi == 0).all()
                and np.array_equal(lo, wk)
                and np.array_equal(c.astype(np.int64), wv)):
            raise AssertionError(f"{name}: DB differs from brute force "
                                 f"({len(lo)} vs {len(wk)} k-mers)")
        s = dict(optree.STATS)
        if device == "cuda" and launches == 0:
            raise AssertionError(f"{name}: rowsort kernel never launched")
        total_entries += s["entries"]
        total_wall += wall
        print(f"set-op {name}: {wall:.3f} s wall, {s['entries']} input "
              f"entries, {len(lo)} output k-mers equal to brute force, "
              f"{s['dispatches']} dispatches ({s['row_dispatches']} "
              f"row-batched), mean R "
              f"{s['rows'] / max(1, s['row_dispatches']):.1f}, mean L "
              f"{s['row_slots'] / max(1, s['rows']):.1f}, rowsort LAUNCHES "
              f"{launches}")
    for name, argv, check in (
            ("histogram", ["histogram", out("u")], _check_histogram),
            ("statistics", ["statistics", out("u")], _check_statistics)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv + [f"device={device}"])
        wall = time.perf_counter() - t0
        if rc != 0 or not check(buf.getvalue(), want["union-sum"][1]):
            raise AssertionError(f"{name} u: wrong report:\n"
                                 f"{buf.getvalue()[:2000]}")
        print(f"set-op {name} u: {wall:.3f} s wall, report equal to brute "
              f"force")
    path_launches = rowsort.LAUNCHES
    print(f"set-op path: {total_entries} entries merged in {total_wall:.3f} "
          f"s, {total_entries / total_wall / 1e6:.3f} M entries/s; rowsort "
          f"LAUNCHES {path_launches}")
    return path_launches, db_b


def _check_histogram(text, values):
    v, o = np.unique(values, return_counts=True)
    return text == "".join(f"{a}\t{b}\n" for a, b in zip(v.tolist(),
                                                         o.tolist()))


def _check_statistics(text, values):
    fields = {ln.split()[0]: int(ln.split()[1]) for ln in text.splitlines()
              if ln.startswith(("  unique ", "  distinct ", "  present "))}
    return fields == {"unique": int((values == 1).sum()),
                      "distinct": len(values), "present": int(values.sum())}


def phase_setop_rows(torch, optree, rowsort, db_a, db_b):
    """Kernel (b) against its plain version on rows the set-op path
    packs: the first bucket group of `union-sum a b`."""
    node = optree.OpNode(op="union-sum", inputs=[optree.DBInput(db_a),
                                                 optree.DBInput(db_b)])
    group = optree.bucket_groups(node)[0]
    ins = [inp.open() for inp in node.inputs]
    ins = [optree.BucketEvaluator._concat_buckets(
        [db.load_bucket(ff) for ff in group]) for db in ins]
    ev = optree.BucketEvaluator(21, "cuda")
    keys, values, ids = (torch.from_numpy(x).cuda()
                         for x in ev._pack_rows(ins, 2))
    got = rowsort.sort_rows(keys, values, ids, 21)
    want = rowsort.sort_rows_plain(keys, values, ids, 21)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got,
                                                                     want))
    if err:
        raise AssertionError(f"set-op rows: kernel differs from plain "
                             f"(max abs err {err})")
    ms = _time_ms(torch, lambda: rowsort.sort_rows(keys, values, ids, 21))
    plain = _time_ms(torch, lambda: rowsort.sort_rows_plain(
        keys, values, ids, 21))
    library = _time_ms(torch, lambda: torch.sort(keys, dim=-1, stable=True))
    R, L = values.shape
    nbytes = 2 * sum(t.numel() * t.element_size() for t in (keys, values,
                                                            ids))
    bound, by = _bound_ms(nbytes)
    print(f"set-op rows (union-sum, buckets {group[0]}..{group[-1]}, R={R} "
          f"L={L}): kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.sort of "
          f"the keys alone {library:.4f} ms, bound {bound:.4f} ms ({by}), "
          f"equal")
    return dict(err=err, ms=ms, plain=plain, library=library, bound=bound,
                by=by, shape=f"{R}x{L} k=21")


class _StderrHook:
    """Stands in for sys.stderr during a `-P` count: every progress line
    (one a chunk, written by the counting thread) calls `on_chunk`."""

    def __init__(self, on_chunk):
        self.on_chunk = on_chunk
        self.text = []

    def write(self, s):
        self.text.append(s)
        if s.startswith("\rcounting"):
            self.on_chunk()
        return len(s)

    def flush(self):
        pass


def _same_db(MerylDB, a, b):
    return all(np.array_equal(x, y) for x, y in
               zip(MerylDB.open(a).load_all(), MerylDB.open(b).load_all()))


def phase_batched(torch, cli, counter, extract_cuda, rowsort, MerylDB, fq,
                  db_a, bases, workdir):
    """`memory=` / `threads=` through the CLI: out-of-core batches, their
    union-sum, and a resume."""
    exp = counter.expected_kmers([fq])
    # the file-size guess is ~2x a FASTQ's bases, so a plan of 6 batches
    # makes 3 real ones
    memory = round(exp * 20 / 5.5 / 1e9, 4)
    plan = counter.configure_counting([fq], 21, memory)
    if plan["batches"] < 3 or plan["chunk_len"] != CHUNK:
        raise AssertionError(f"memory={memory} does not plan >= 3 batches "
                             f"of 2^22 chunks: {plan}")
    threads = min(8, os.cpu_count() or 1)
    saved_threads = os.environ.get("MERYL_TPU_THREADS")
    out = os.path.join(workdir, "batched.meryl")
    keep0 = os.path.join(workdir, "kept.batch0")
    seen = {"manifest": None, "batch_dbs": set()}

    def on_chunk():
        mpath = out + ".manifest.json"
        if os.path.exists(mpath):
            with open(mpath) as f:
                manifest = json.load(f)
            seen["batch_dbs"].update(
                i for i in manifest["done"]
                if os.path.isdir(f"{out}.batch{i}"))
            if seen["manifest"] is None and 0 in manifest["done"]:
                # batch 0 is complete and untouched until the final merge
                shutil.copytree(out + ".batch0", keep0)
                seen["manifest"] = manifest

    words = ["k=21", f"memory={memory}", f"threads={threads}", "-P", "count",
             fq, "output"]
    try:
        hook = _StderrHook(on_chunk)
        extract_cuda.LAUNCHES = rowsort.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(hook):
            rc = cli.main(words + [out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ext_launches, sort_launches = extract_cuda.LAUNCHES, rowsort.LAUNCHES
        peak = torch.cuda.max_memory_allocated()
        if rc != 0:
            raise AssertionError(f"batched count exited {rc}: "
                                 f"{''.join(hook.text)[-2000:]}")
        if os.environ.get("MERYL_TPU_THREADS") != str(threads):
            raise AssertionError("threads= did not set MERYL_TPU_THREADS")
        st = dict(counter.LAST_BATCH_STATS)
        n = st["batches"]
        if n < 3 or len(st["counted"]) != n or st["skipped"]:
            raise AssertionError(f"not >= 3 counted batches: {st}")
        if seen["manifest"] is None or len(seen["batch_dbs"]) < n - 1:
            raise AssertionError(f"the manifest and the batch DBs were not "
                                 f"seen while counting: {seen}")
        left = [p for p in os.listdir(workdir)
                if p.startswith("batched.meryl.")]
        if left:
            raise AssertionError(f"left behind: {left}")
        if not _same_db(MerylDB, out, db_a):
            raise AssertionError("the batched DB differs from the unbatched")
        if ext_launches < st["chunks"] or sort_launches < 1:
            raise AssertionError(
                f"kernels not launched on the batched path: extract "
                f"{ext_launches} (chunks {st['chunks']}), row sort "
                f"{sort_launches}")
        print(f"batched count: memory={memory} threads={threads}: plan "
              f"{plan['batches']} batches of {plan['batch_bases']} expected "
              f"k-mers, {n} real batches over {st['chunks']} chunks; "
              f"{bases / wall / 1e6:.3f} Mbases/s ({wall:.3f} s wall incl. "
              f"the batches' flushes {st['t_flush_s']:.3f} s and the final "
              f"union-sum of {st['merge_entries']} entries "
              f"{st['t_merge_s']:.3f} s); DB equal to "
              f"the unbatched count's; manifest and {len(seen['batch_dbs'])} "
              f"batch DBs seen while counting, gone after; extract LAUNCHES "
              f"{ext_launches}, rowsort LAUNCHES {sort_launches}; "
              f"max_memory_allocated {peak} B")
        print("batched count batches: " + json.dumps(st["counted"]))

        # resume: batch 0 done by "an earlier run", its DB kept
        out2 = os.path.join(workdir, "resumed.meryl")
        shutil.copytree(keep0, out2 + ".batch0")
        with open(out2 + ".manifest.json", "w") as f:
            json.dump(dict(seen["manifest"], done=[0]), f)
        extract_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(_StderrHook(lambda: None)):
            rc = cli.main(words + [out2])
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        st2 = dict(counter.LAST_BATCH_STATS)
        cpb = -(-plan["batch_bases"] // CHUNK)  # chunks a batch
        if rc != 0 or st2["skipped"] != [0] or \
                [b["batch"] for b in st2["counted"]] != list(range(1, n)) or \
                not st["chunks"] - cpb <= extract_cuda.LAUNCHES \
                < st["chunks"]:
            raise AssertionError(
                f"resume recounted batch 0 or lost one: rc {rc}, {st2}, "
                f"extract LAUNCHES {extract_cuda.LAUNCHES}")
        if not _same_db(MerylDB, out2, db_a):
            raise AssertionError("the resumed DB differs from the unbatched")
        print(f"batched resume: batch 0 skipped ({cpb} chunks), batches "
              f"1..{n - 1} counted in {wall2:.3f} s, extract LAUNCHES "
              f"{extract_cuda.LAUNCHES}, DB equal")
    finally:
        if saved_threads is None:
            os.environ.pop("MERYL_TPU_THREADS", None)
        else:
            os.environ["MERYL_TPU_THREADS"] = saved_threads
    return ext_launches, sort_launches


FASTQ_RECORD = 3 + READ_LEN + 3 + READ_LEN + 1   # bytes, _make_fastq


def _head_fastq(fq, n_reads, path):
    """The first n_reads records of a _make_fastq file."""
    with open(fq, "rb") as f, open(path, "wb") as g:
        g.write(f.read(n_reads * FASTQ_RECORD))
    return path


def _with_env(env, fn):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_suffix(torch, cli, counter, MerylDB, fq, reads, workdir):
    """count-suffix= and the host sort path at the production chunk, on
    the first 60,000 reads."""
    n_sub = 60_000
    sub = _head_fastq(fq, n_sub, os.path.join(workdir, "sub.fq"))
    suffix = "ACGT"
    sbits = sum(CODE[ch] << (2 * (len(suffix) - 1 - i))
                for i, ch in enumerate(suffix))
    all_k, all_c = _brute_canonical(reads[:n_sub], 21)
    ends = (all_k & np.uint64(4 ** len(suffix) - 1)) == np.uint64(sbits)
    want_k, want_c = all_k[ends], all_c[ends]
    if not 1000 < len(want_k) < len(all_k) // 100:
        raise AssertionError(f"odd suffix share: {len(want_k)} of "
                             f"{len(all_k)}")

    def count(name, words, env, wk, wc):
        db = os.path.join(workdir, name + ".meryl")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = _with_env(env, lambda: cli.main(
            ["k=21", *words, "count", sub, "output", db]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hi, lo, c = MerylDB.open(db).load_all()
        if rc != 0 or not ((hi == 0).all() and np.array_equal(lo, wk)
                           and np.array_equal(c.astype(np.int64),
                                              wc.astype(np.int64))):
            raise AssertionError(f"{name}: rc {rc}, {len(lo)} k-mers, "
                                 f"brute force {len(wk)}")
        return wall, torch.cuda.max_memory_allocated()

    sfx = [f"count-suffix={suffix}"]
    w1, _ = count("sfx", sfx, {}, want_k, want_c)
    w3, peak = count("host", [], {"MERYL_TPU_DEVICE_ACC": "0"}, all_k, all_c)
    model = counter.device_bytes_per_base(21)
    print(f"count-suffix: k=21 count-suffix={suffix} on {n_sub} reads "
          f"({n_sub * READ_LEN} bases): {len(want_k)} of {len(all_k)} "
          f"k-mers, equal to brute force in {w1:.3f} s")
    print(f"host sort path: the same reads with MERYL_TPU_DEVICE_ACC=0 equal "
          f"to brute force in {w3:.3f} s, peak {peak} B = "
          f"{peak / CHUNK:.1f} B a base of a 2^22 chunk (the plan's model: "
          f"{model})")
    if peak > 2 * model * CHUNK:
        raise AssertionError("the host sort path holds more than twice the "
                             "plan's device bytes a base")
    return sub


def phase_configure(torch, cli, counter, fq, workdir):
    """-C prints the tree and the plan, counts nothing."""
    out = os.path.join(workdir, "never.meryl")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["-C", "k=21", "memory=1.5", "count", fq, "output",
                       out])
    plan = dict(ln.strip().split(": ", 1) for ln in
                err.getvalue().splitlines() if ": " in ln)
    total = torch.cuda.get_device_properties(0).total_memory
    want = counter.configure_counting([fq], 21, 1.5)
    if rc != 0 or os.path.exists(out) or \
            float(plan.get("hbm_gb", 0)) != total / 1e9 or \
            {k: str(v) for k, v in want.items()} != \
            {k: plan.get(k) for k in want}:
        raise AssertionError(f"-C: rc {rc}, plan {plan}, wanted {want}")
    print(f"-C: exit 0, no DB; plan {json.dumps(want)} (hbm_gb is the card's "
          f"total_memory {total} B)")


def phase_acc_memory(torch, cli, counter, accum, fq, peak_full, workdir):
    """The device-accumulator count's peak device memory at two input
    sizes, and what the admission budget takes it to be."""
    n_half = COVERAGE * GENOME // READ_LEN // 2
    half = _head_fastq(fq, n_half, os.path.join(workdir, "half.fq"))
    torch.cuda.reset_peak_memory_stats()
    rc = cli.main(["k=21", "count", half, "output",
                   os.path.join(workdir, "half.meryl")])
    torch.cuda.synchronize()
    peak_half = torch.cuda.max_memory_allocated()
    if rc != 0 or counter.LAST_WIRE_STATS["salvaged"]:
        raise AssertionError("half-size count failed or left the device path")
    rows = []
    for path, peak in ((half, peak_half), (fq, peak_full)):
        exp = counter.expected_kmers([path])
        plan = accum.plan_route(CHUNK, 21, exp)
        rows.append((exp, 0.35 * exp, plan["B"] * plan["La0"], peak))
    (e0, u0, s0, p0), (e1, u1, s1, p1) = rows
    budget = counter.acc_bytes_per_unique(21)
    print(f"accumulator memory: peak {p0} B at {e0} expected k-mers "
          f"({s0} accumulator slots), {p1} B at {e1} ({s1} slots): "
          f"{(p1 - p0) / (u1 - u0):.1f} B a budgeted unique (0.35 x "
          f"expected) on the slope, {p1 / u1:.1f} B in all at the full "
          f"size; {(p1 - p0) / (s1 - s0):.1f} B an accumulator slot; the "
          f"admission budget counts {budget} B a budgeted unique against "
          f"{counter.acc_cap_bytes('cuda')} B")
    return peak_half


# ------------------------------------------------------------- lookup

LOOKUP_READS = 20_000    # reads (and as many mates) of phase 14's read modes
REGIME_Q = 1 << 23       # queries a regime timing
SMALL_TABLE = 1 << 16


class _ArraysDB:
    """A DB in memory: what ExactLookup reads of a MerylDB."""

    def __init__(self, k, hi, lo, counts, mode="canonical"):
        self.k, self.mode = k, mode
        self._t = (hi, lo, counts)

    def load_all(self):
        return self._t


def _fwd_rev(codes, k):
    """(n, L) codes (4 = N) -> forward and reverse-complement uint64
    k-mers (n, L - k + 1) and their valid mask (no N in the window)."""
    n, ln = codes.shape
    w = ln - k + 1
    c = codes.astype(np.uint64) & np.uint64(3)
    f = np.zeros((n, w), np.uint64)
    r = np.zeros((n, w), np.uint64)
    for j in range(k):
        f = f * np.uint64(4) + c[:, j:j + w]
        r = r + (c[:, j:j + w] ^ np.uint64(2)) * np.uint64(4 ** j)
    bad = np.concatenate([np.zeros((n, 1), np.int32),
                          np.cumsum(codes == 4, axis=1, dtype=np.int32)],
                         axis=1)
    return f, r, (bad[:, k:] - bad[:, :w]) == 0


def _np_values(keys, counts, q):
    """Brute-force lookup: value of each query in sorted unique keys."""
    i = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    return np.where(keys[i] == q, counts[i], 0).astype(np.int64)


def _table(path):
    """A text file of whitespace-separated columns, the same number on
    every line -> (n_lines, n_cols) bytes array."""
    with open(path, "rb") as f:
        data = f.read()
    tok = data.split()
    n = data.count(b"\n")
    if n == 0 or len(tok) % n:
        raise AssertionError(f"{path}: empty or ragged")
    return np.array(tok).reshape(n, len(tok) // n)


def _ints(col):
    return col.astype(np.int64)


def _runs(found):
    pad = np.zeros(len(found) + 2, np.int8)
    pad[1:-1] = found
    d = np.diff(pad)
    return np.flatnonzero(d == 1), np.flatnonzero(d == -1)


def _write_reads(path, codes, lut=np.frombuffer(b"ACTGN", np.uint8)):
    with open(path, "wb") as f:
        for s in lut[codes]:
            f.write(b"@r\n" + s.tobytes() + b"\n+\n" + b"I" * len(s) + b"\n")


def _lookup_cli_checks(lookup_cli, extract_cuda, MerylDB, genome, reads, asm,
                       db_a, db_b, workdir):
    """Every meryl-lookup mode through the CLI, each output against a
    numpy brute force over the decoded DBs, each run launching the
    extraction kernel.  -> ({mode: wall s}, {mode: launches}, ...)."""
    k = 21
    dec = {}
    for name, path in (("a", db_a), ("b", db_b)):
        hi, lo, c = MerylDB.open(path).load_all()
        dec[name] = (lo, c.astype(np.int64))
    f, r, _ = _fwd_rev(genome[None, :], k)
    f, r = f[0], r[0]
    npos = len(f)
    va = _np_values(*dec["a"], f), _np_values(*dec["a"], r)
    vb = _np_values(*dec["b"], f), _np_values(*dec["b"], r)
    found_a = (va[0] > 0) | (va[1] > 0)
    found_b = (vb[0] > 0) | (vb[1] > 0)
    walls, launches = {}, {}

    def call(name, args):
        before = extract_cuda.LAUNCHES
        t0 = time.perf_counter()
        rc = lookup_cli.main(args)
        walls[name] = time.perf_counter() - t0
        launches[name] = extract_cuda.LAUNCHES - before
        if launches[name] == 0:
            raise AssertionError(f"meryl-lookup {name} never launched the "
                                 f"extraction kernel")
        return rc

    def run(name, args):
        out = os.path.join(workdir, f"lk_{name}.txt")
        rc = call(name, args + ["-output", out])
        if rc != 0:
            raise AssertionError(f"meryl-lookup {name} exited {rc}")
        return out

    def expect(name, got, want):
        if not (len(got) == len(want) and all(
                np.array_equal(g, w) for g, w in zip(got, want))):
            raise AssertionError(f"meryl-lookup {name}: output differs from "
                                 f"brute force")

    seq = ["-sequence", asm]
    t = _table(run("existence genome", ["-existence", *seq, "-mers", db_a,
                                        db_b]))
    expect("existence genome", [t[:, 0], _ints(t[0, 1:])],
           [np.array([b"chr"]),
            [npos, len(dec["a"][0]), int(found_a.sum()), len(dec["b"][0]),
             int(found_b.sum())]])
    t = _table(run("bed", ["-bed", *seq, "-mers", db_a]))
    ps = np.flatnonzero(found_a)
    expect("bed", [_ints(t[:, 1]), _ints(t[:, 2])], [ps, ps + k])
    t = _table(run("bed-runs", ["-bed-runs", *seq, "-mers", db_a]))
    s, e = _runs(found_a)
    expect("bed-runs", [_ints(t[:, 1]), _ints(t[:, 2])], [s, e + k])
    t = _table(run("wig-depth", ["-wig-depth", *seq, "-mers", db_a]))
    maxp = int(ps[-1]) + k if len(ps) else 0
    depth = np.cumsum(np.bincount(ps, minlength=maxp + k + 1)
                      - np.bincount(ps + k, minlength=maxp + k + 1))[:maxp]
    dp = np.flatnonzero(depth > 0)
    expect("wig-depth", [t[0], _ints(t[1:, 0]), _ints(t[1:, 1])],
           [np.array([b"variableStep", b"chrom=chr"]), dp + 1,
            depth[dp]])
    t = _table(run("wig-count", ["-wig-count", *seq, "-mers", db_a]))
    cnt = va[0] + va[1]            # odd k: no palindromes
    cp = np.flatnonzero(cnt)
    expect("wig-count", [_ints(t[1:, 0]), _ints(t[1:, 1])], [cp + 1, cnt[cp]])
    t = _table(run("bed labels", ["-bed", *seq, "-mers", db_a, db_b,
                                  "-labels", "A", "B"]))
    both = np.stack([found_a, found_b], axis=1)
    pp, dd = np.nonzero(both)
    expect("bed labels", [_ints(t[:, 1]), t[:, 3]],
           [pp, np.array([b"A", b"B"])[dd]])

    # reads: -existence, then -include / -exclude of pairs against b -min 2
    n = LOOKUP_READS
    r1 = os.path.join(workdir, "lk_r1.fq")
    r2 = os.path.join(workdir, "lk_r2.fq")
    _write_reads(r1, reads[:n])
    _write_reads(r2, reads[n:2 * n])
    t = _table(run("existence reads", ["-existence", "-sequence", r1,
                                       "-mers", db_a, db_b]))
    rf, rr, rv = _fwd_rev(reads[:2 * n], k)

    def hits(keys, counts, min_v=1):
        v = np.maximum(_np_values(keys, counts, rf.ravel()),
                       _np_values(keys, counts, rr.ravel()))
        return ((v >= min_v) & rv.ravel()).reshape(rf.shape).sum(axis=1)
    ha, hb = hits(*dec["a"]), hits(*dec["b"])
    expect("existence reads", [_ints(t[:, c]) for c in (1, 2, 3, 4, 5)],
           [rv[:n].sum(axis=1), np.full(n, len(dec["a"][0])), ha[:n],
            np.full(n, len(dec["b"][0])), hb[:n]])
    hb2 = hits(*dec["b"], min_v=2)
    nf = hb2[:n] + hb2[n:]
    lut = np.frombuffer(b"ACTGN", np.uint8)
    for mode, keep in (("include", nf > 0), ("exclude", nf == 0)):
        o1 = os.path.join(workdir, f"lk_{mode}_1.fq")
        o2 = os.path.join(workdir, f"lk_{mode}_2.fq")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = call(mode, [f"-{mode}", "-sequence", r1, r2, "-mers", db_b,
                             "-min", "2", "-output", o1, o2])
        for path, rows in ((o1, reads[:n]), (o2, reads[n:2 * n])):
            want = b"".join(
                b"@r nKmers=%d\n%s\n+\n%s\n" % (
                    nf[i], lut[rows[i]].tobytes(), b"I" * rows.shape[1])
                for i in np.flatnonzero(keep))
            with open(path, "rb") as f:
                if rc != 0 or f.read() != want:
                    raise AssertionError(f"meryl-lookup -{mode}: output "
                                         f"differs from brute force")
        if f"Including {int(keep.sum())} reads (or read pairs) out of {n}." \
                not in err.getvalue():
            raise AssertionError(f"-{mode}: {err.getvalue()!r}")
    return walls, launches, r1, int(found_a.sum())


def _position_lookup_check(position_lookup, extract_cuda, genome, reads, asm,
                           ref, r1, workdir):
    """position-lookup of the reads against `ref`, a DB counted from the
    genome itself, -hpq / -mpb / -qpb against a numpy brute force."""
    k, n = 21, LOOKUP_READS
    out = {x: os.path.join(workdir, f"pl.{x}") for x in ("hpq", "mpb", "qpb")}
    before = extract_cuda.LAUNCHES
    t0 = time.perf_counter()
    rc = position_lookup.main(["-m", ref, "-s", asm, "-hpq", out["hpq"],
                               "-mpb", out["mpb"], "-qpb", out["qpb"], r1])
    wall = time.perf_counter() - t0
    launches = extract_cuda.LAUNCHES - before
    if launches == 0:
        raise AssertionError("position-lookup never launched the extraction "
                             "kernel")
    f, r, _ = _fwd_rev(genome[None, :], k)
    g = np.minimum(f[0], r[0])
    uniq, grank, occ = np.unique(g, return_inverse=True, return_counts=True)
    rf, rr, rv = _fwd_rev(reads[:n], k)
    q = np.minimum(rf, rr)
    i = np.minimum(np.searchsorted(uniq, q), len(uniq) - 1)
    hit = (uniq[i] == q) & rv
    tcov = hit.sum(axis=1)
    nper = np.where(hit, occ[i], 0).sum(axis=1)
    per_rank = np.bincount(i[hit], minlength=len(uniq))
    mer = per_rank[grank]
    rows = np.nonzero(hit)[0]
    pairs = np.unique(np.stack([rows, i[hit]], axis=1), axis=0)
    qry = np.bincount(pairs[:, 1], minlength=len(uniq))[grank]
    t = _table(out["hpq"])
    want = [nper, tcov, np.full(n, reads.shape[1])]
    if rc != 0 or not all(np.array_equal(_ints(t[:, c]), w)
                          for c, w in enumerate(want)):
        raise AssertionError("position-lookup -hpq differs from brute force")
    for name, paint in (("mpb", mer), ("qpb", qry)):
        t = _table(out[name])
        p = np.flatnonzero(paint)
        if not (np.array_equal(_ints(t[:, 0]), p)
                and np.array_equal(_ints(t[:, 1]), paint[p])):
            raise AssertionError(f"position-lookup -{name} differs from "
                                 f"brute force")
    return wall, launches, int(tcov.sum())


def _lookup_breakdown(torch, lookup_cli, asm, db_a, workdir):
    """Where `-bed` of the genome against DB a spends its time: the table
    load, the per-position values (extraction, search, download), the
    whole dump under torch.profiler (device time over its wall)."""
    from torch.profiler import ProfilerActivity, profile
    from meryl_tpu_torch import kmer as km
    from meryl_tpu_torch.io.sequence import iter_sequences

    out = os.path.join(workdir, "lk_breakdown.bed")
    g = lookup_cli.parse_args(["-bed", "-sequence", asm, "-mers", db_a,
                               "-output", out])
    t0 = time.perf_counter()
    lookup_cli.load_tables(g)
    torch.cuda.synchronize()
    load = time.perf_counter() - t0
    _, seq, _ = next(iter_sequences(asm))
    codes = km.CODE_LUT[np.frombuffer(seq, np.uint8)]
    t0 = time.perf_counter()
    lookup_cli._per_position_values(g.lookups, codes, 21, exists_only=True)
    values = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with open(out, "w") as f:
            lookup_cli.cmd_dump(g, f)
        torch.cuda.synchronize()
        dump = time.perf_counter() - t0
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    busy = (f"device busy {dev_ms:.3f} ms = {dev_ms / 10 / dump:.2f} % of "
            f"the dump (idle {100 - dev_ms / 10 / dump:.2f} %)"
            if dev_ms > 0 else "the profiler traced no device time")
    print(f"lookup breakdown (-bed, genome against a): table load "
          f"{load:.3f} s; per-position values (extraction, search, "
          f"download) {values:.3f} s; cmd_dump {dump:.3f} s (traced), of "
          f"it the values above and {dump - values:.3f} s of formatting "
          f"and writing; {busy}")


def _time_regimes(torch, lookup, table_fn, keys, counts, label):
    """Each regime in turn on REGIME_Q queries (half hits), each held
    against the brute force; Mq/s of the steady calls (a warm-up call
    first builds the regime's layout)."""
    rng = np.random.default_rng(SEED + 14)
    Q = REGIME_Q
    q = np.concatenate([keys[rng.integers(0, len(keys), Q // 2)],
                        rng.integers(0, 1 << 42, Q - Q // 2, dtype=np.uint64)])
    rng.shuffle(q)
    key = torch.from_numpy((q ^ np.uint64(1 << 63)).view(np.int64)).cuda()
    want = _np_values(keys, counts, q)
    valid = torch.ones(Q, dtype=torch.bool, device="cuda")
    t = table_fn({})
    res = {}

    def timed(name, fn):
        """A first call (it builds the regime's layout), then three timed
        calls, or one where the first took more than 2 s."""
        lookup.reset_stats()
        t0 = time.perf_counter()
        got = fn()
        first = time.perf_counter() - t0
        if not np.array_equal(got.astype(np.int64), want):
            raise AssertionError(f"{label} {name}: values differ from brute "
                                 f"force")
        walls = []
        for _ in range(3 if first < 2 else 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        res[name] = dict(mqs=[Q / w / 1e6 for w in walls], first_s=first,
                         stats={a: b for a, b in lookup.STATS.items() if b})
        return res[name]["stats"]
    bs = timed("binary search", lambda: t.values_bulk(key, valid))
    if not bs.get("bsearch_calls") or t._bacj is not None:
        raise AssertionError(f"{label}: the binary search did not answer")
    zeros = np.zeros(Q, np.uint64)
    timed("values_host", lambda: t.values_host(zeros, q))
    # the segmented grid: the table past a device budget forced low, the
    # grid cap a third of the whole grid's bytes
    cap = t._build_bacj()["cfg"]["mem"] / 3 / 1e9
    env = {"MERYL_TPU_LOOKUP_DEVICE_GB": "0.000001",
           "MERYL_TPU_BACJ_CAP_GB": repr(cap)}
    ts = table_fn(env)
    seg = timed("segmented grid", lambda: _with_env(
        env, lambda: ts.values_bulk(key, valid)))
    if ts._device_resident or ts._bacj["segments"] < 2 \
            or not seg.get("bacj_slabs"):
        raise AssertionError(f"{label}: the segmented grid did not run")
    res["segmented grid"]["segments"] = ts._bacj["segments"]
    del t, ts
    for name, m in res.items():
        print(f"lookup regime {label}, {name}: "
              + ", ".join(f"{x:.2f}" for x in m["mqs"])
              + f" Mq/s ({Q} queries, half hits; first call "
              f"{m['first_s']:.3f} s incl. the layout build); STATS "
              + json.dumps(m["stats"], sort_keys=True))
    return res


def phase_lookup(torch, cli, lookup, lookup_cli, position_lookup,
                 extract_cuda, MerylDB, genome, reads, db_a, db_b, workdir):
    """meryl-lookup and position-lookup through their CLIs, each mode
    against a numpy brute force; the table's device bytes; every bulk
    regime timed on DB a and on a 2^16-entry table."""
    asm = os.path.join(workdir, "asm.fa")
    with open(asm, "wb") as f:
        f.write(b">chr\n" + np.frombuffer(b"ACTG", np.uint8)[genome]
                .tobytes() + b"\n")
    # position-lookup's DB, counted before the launch window opens: the
    # window holds meryl-lookup and position-lookup runs only
    ref = os.path.join(workdir, "genome.meryl")
    if cli.main(["count", "k=21", asm, "output", ref]) != 0:
        raise AssertionError("counting the genome failed")
    extract_cuda.LAUNCHES = 0
    lookup.reset_stats()
    walls, per_mode, r1, n_found = _lookup_cli_checks(
        lookup_cli, extract_cuda, MerylDB, genome, reads, asm, db_a, db_b,
        workdir)
    pl_wall, pl_launches, pl_hits = _position_lookup_check(
        position_lookup, extract_cuda, genome, reads, asm, ref, r1, workdir)
    launches = extract_cuda.LAUNCHES
    path_stats = {a: b for a, b in lookup.STATS.items() if b}
    if launches != sum(per_mode.values()) + pl_launches:
        raise AssertionError(f"extract LAUNCHES {launches} is not the sum of "
                             f"the runs' own")
    print("lookup CLI (each output equal to brute force; wall s, extract "
          "launches): " + ", ".join(f"{m} {w:.3f} ({per_mode[m]})"
                                    for m, w in walls.items())
          + f"; position-lookup {pl_wall:.3f} ({pl_launches}; {pl_hits} read "
          f"k-mers hit); genome k-mers found in a {n_found} of "
          f"{GENOME - 20}; extract LAUNCHES {launches}; STATS "
          + json.dumps(path_stats, sort_keys=True))

    db = MerylDB.open(db_a)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    t = lookup.ExactLookup(db)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    table_bytes = torch.cuda.memory_allocated() - before
    print(f"lookup table a: {t.n_kmers()} k-mers, device bytes "
          f"{table_bytes} (memory_allocated delta), estimate_memory_bytes "
          f"{t.estimate_memory_bytes()}, built in {build:.3f} s (DB read, "
          f"offsets, upload)")
    del t
    hi, lo, c = db.load_all()

    big = _time_regimes(torch, lookup, lambda env: _with_env(
        env, lambda: lookup.ExactLookup(db)), lo, c.astype(np.int64),
        f"N={len(lo)}")
    pick = np.linspace(0, len(lo) - 1, SMALL_TABLE).astype(np.int64)
    small_db = _ArraysDB(21, hi[pick], lo[pick], c[pick])
    small = _time_regimes(torch, lookup, lambda env: _with_env(
        env, lambda: lookup.ExactLookup(small_db)), lo[pick],
        c[pick].astype(np.int64), f"N={SMALL_TABLE}")
    # last: the profiler's tracing would slow the timings after it
    _lookup_breakdown(torch, lookup_cli, asm, db_a, workdir)
    return launches, dict(walls=walls, big=big, small=small,
                          table_bytes=table_bytes)


# ------------------------------------------------------------- meryl2

MASK32 = 0xFFFFFFFF
MUL_CONST = 1 << 28          # phase 15's saturating assign:value=mul#C
M7_SLICE = 1 << 20           # k-mers of DB a behind the 7-input action


def _decode_labelled(MerylDB, path):
    """-> sorted k=21 k-mers, counts (int64) and labels of a DB."""
    db = MerylDB.open(path)
    runs = [db.load_bucket_labels(ff) for ff in range(64)]
    hi = np.concatenate([r[0] for r in runs])
    if (hi != 0).any():
        raise AssertionError(f"{path}: k=21 k-mers with hi bits")
    lab = np.concatenate([r[3] if r[3] is not None else
                          np.zeros(len(r[2]), np.uint64) for r in runs])
    return (np.concatenate([r[1] for r in runs]),
            np.concatenate([r[2] for r in runs]).astype(np.int64),
            lab.astype(np.int64))


def _gc_count(kmers, k=21):
    """G and C bases of each k-mer (codes 1 and 3: the low bit set)."""
    gc = np.zeros(len(kmers), np.int64)
    for j in range(k):
        gc += ((kmers >> np.uint64(2 * j)) & np.uint64(1)).astype(np.int64)
    return gc


def _meryl2_brute(a, b):
    """Expected (k-mers, values, labels) of phase 15's two-input actions,
    from the two decoded inputs (labels 1 and 2), independent of both
    packages."""
    (ka, ca, _), (kb, cb, _) = a, b
    u = np.union1d(ka, kb)
    va = np.zeros(len(u), np.int64)
    vb = np.zeros(len(u), np.int64)
    va[np.searchsorted(u, ka)] = ca
    vb[np.searchsorted(u, kb)] = cb
    ina, inb = va > 0, vb > 0
    lab_or = np.where(ina, 1, 0) | np.where(inb, 2, 0)
    both, only_a = ina & inb, ina & ~inb
    vmax = np.maximum(va, vb)
    sel = (vmax >= 20) & (_gc_count(u) >= 11)
    prod = np.where(ina, va, 1) * np.where(inb, vb, 1)
    return {
        # value sum (saturating), label OR
        "union-sum": (u, np.minimum(va + vb, MASK32), lab_or),
        # keys of both; value min, label 1 ^ 2
        "intersect-min-xor": (u[both], np.minimum(va, vb)[both],
                              np.full(int(both.sum()), 3)),
        # not in input 2: a's own k-mers, value and label
        "not-input-2": (u[only_a], va[only_a], np.ones(int(only_a.sum()))),
        # union-max: value max, label of the first input holding it
        "value-bases": (u[sel], vmax[sel],
                        np.where(ina & (va >= vb), 1, 2)[sel]),
        # saturating product of the constant and the present values
        "mul-saturating": (u, np.minimum(MUL_CONST * prod, MASK32), lab_or),
    }


def _write_slices(MerylDB, a, workdir):
    """7 labelled DBs from the first M7_SLICE k-mers of DB a: input i
    holds the k-mers whose index is a multiple of i + 2, label 1 << i.
    -> paths and the expected union-sum (k-mers, values, labels)."""
    keys, counts = a[0][:M7_SLICE], a[1][:M7_SLICE]
    j = np.arange(len(keys))
    n_in = np.zeros(len(keys), np.int64)
    lab = np.zeros(len(keys), np.int64)
    paths = []
    for i in range(7):
        take = j % (i + 2) == 0
        n_in += take
        lab |= np.where(take, 1 << i, 0)
        path = os.path.join(workdir, f"m2_slice{i}.meryl")
        MerylDB.write(path, 21, np.zeros(int(take.sum()), np.uint64),
                      keys[take], counts[take].astype(np.uint32),
                      labels=np.full(int(take.sum()), 1 << i, np.uint64))
        paths.append(path)
    hit = n_in > 0
    return paths, (keys[hit], np.minimum(n_in * counts, MASK32)[hit],
                   lab[hit])


def _check_labelled(MerylDB, name, path, want):
    got = _decode_labelled(MerylDB, path)
    for what, g, w in zip(("k-mers", "values", "labels"), got, want):
        if len(g) != len(w) or not np.array_equal(g.astype(np.int64),
                                                  np.asarray(w, np.int64)):
            raise AssertionError(f"meryl2 {name}: {what} differ from brute "
                                 f"force ({len(g)} vs {len(w)})")
    return len(got[0])


@contextlib.contextmanager
def _call_clock(torch, spots):
    """Wrap each (owner, attribute, layer) of `spots` in a timer that
    synchronizes the card before and after the call; yields the seconds
    of each call, a list a layer.  The originals come back on exit."""
    calls = {name: [] for _, _, name in spots}

    def timed(fn, name):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                calls[name].append(time.perf_counter() - t0)
        return call
    saved = [(owner, attr, owner.__dict__[attr]) for owner, attr, _ in spots]
    for owner, attr, name in spots:
        setattr(owner, attr, timed(getattr(owner, attr), name))
    try:
        yield calls
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


@contextlib.contextmanager
def _layer_clock(torch, spots):
    """_call_clock summed: yields the seconds each layer spent over its
    calls (filled in on exit)."""
    spent = {}
    with _call_clock(torch, spots) as calls:
        yield spent
    spent.update({name: sum(v) for name, v in calls.items()})


def _same_files(a, b):
    """Two DB directories hold the same files, byte for byte."""
    names = sorted(os.listdir(a))
    return names == sorted(os.listdir(b)) and all(
        filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False)
        for n in names)


def _meryl2_layers(torch, v2cli, engine, rowsort, la, lb, checked, workdir):
    """`union-sum` of the labelled DBs through the CLI, row-packed
    (`Evaluator.ROWPACK_MIN` as shipped) and flat (ROWPACK_MIN 2^60) in
    turns: row, flat, flat, row.  Each run times the layers of the path
    the CLI runs (DB read, host packing, upload, sort stage, compute
    stage, download, DB write; the rest is grouping and the CLI) and
    its output DB must equal `checked`, the brute-force-checked
    union-sum, byte for byte.  -> walls a layout."""
    spots = [(v2cli.Evaluator, "_load_input", "DB read"),
             (v2cli.Evaluator, "_pack", "pack"),
             (v2cli.Evaluator, "_dispatch", "dispatch"),
             (engine, "_action_sort_stage", "sort stage"),
             (engine, "_action_compute_stage", "compute stage"),
             (v2cli.Evaluator, "_download", "download"),
             (v2cli.MerylDBWriter, "add_bucket", "DB write"),
             (v2cli.MerylDBWriter, "finalize", "DB write")]
    shipped = v2cli.Evaluator.ROWPACK_MIN
    walls = {"row-packed": [], "flat": []}
    for i, layout in enumerate(("row-packed", "flat", "flat", "row-packed")):
        path = os.path.join(workdir, f"m2_layers{i}.meryl")
        v2cli.reset_stats()
        before = rowsort.LAUNCHES
        v2cli.Evaluator.ROWPACK_MIN = shipped if layout == "row-packed" \
            else 1 << 60
        try:
            with _layer_clock(torch, spots) as spent:
                t0 = time.perf_counter()
                rc = v2cli.main(["union-sum", la, lb,
                                 f"output:database={path}"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            v2cli.Evaluator.ROWPACK_MIN = shipped
        launches = rowsort.LAUNCHES - before
        s = dict(v2cli.STATS)
        if rc != 0 or not _same_files(path, checked):
            raise AssertionError(f"meryl2 union-sum ({layout}): rc {rc} or "
                                 f"a DB unlike the checked union-sum")
        if (s["row_dispatches"] > 0) != (layout == "row-packed") or \
                launches != s["row_dispatches"]:
            raise AssertionError(f"meryl2 union-sum ({layout}): rowsort "
                                 f"LAUNCHES {launches} for "
                                 f"{s['row_dispatches']} row-packed of "
                                 f"{s['dispatches']} dispatches")
        shutil.rmtree(path)
        walls[layout].append(wall)
        spent["upload"] = spent.pop("dispatch") - spent["sort stage"] - \
            spent["compute stage"]
        spent["rest"] = wall - sum(spent.values())
        print(f"meryl2 layers (union-sum {layout}, run {i + 1} of 4): "
              f"{wall:.3f} s wall, {s['dispatches']} dispatches, rowsort "
              f"LAUNCHES {launches}; " + ", ".join(
                  f"{n} {1e3 * spent[n]:.1f} ms" for n in (
                      "DB read", "pack", "upload", "sort stage",
                      "compute stage", "download", "DB write", "rest")))
    return walls


def phase_meryl2(torch, v2cli, engine, extract_cuda, rowsort, MerylDB, fq_a,
                 fq_b, db_a, db_b, db_u, workdir):
    """meryl2-torch on the card: phase 6's and phase 8's read sets
    counted with labels #1 and #2, then actions over the two labelled
    ~10.5 M k-mer DBs and a 7-input action over slices of DB a, each
    output DB decoded and held against a numpy brute force; histogram
    and statistics.  The launch counts are read there: what follows
    (union-sum in both layouts with its layers timed, and the trace in a
    process of its own) checks its own.  -> the extraction and row sort
    launches of those meryl2 commands."""
    t_phase = time.perf_counter()
    la, lb = (os.path.join(workdir, n) for n in ("m2_a.meryl", "m2_b.meryl"))
    out = lambda name: os.path.join(workdir, f"m2_{name}.meryl")  # noqa: E731
    extract_cuda.LAUNCHES = rowsort.LAUNCHES = 0
    for fq, lab, path, ref in ((fq_a, 1, la, db_a), (fq_b, 2, lb, db_b)):
        before = extract_cuda.LAUNCHES
        t0 = time.perf_counter()
        rc = v2cli.main(["-k", "21", "count", f"label=#{lab}", fq,
                         f"output:database={path}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"meryl2 count label=#{lab} exited {rc}")
        kmers, counts, labels = _decode_labelled(MerylDB, path)
        hi, lo, c = MerylDB.open(ref).load_all()
        if not (np.array_equal(kmers, lo) and np.array_equal(counts, c)
                and (labels == lab).all()):
            raise AssertionError(f"meryl2 count label=#{lab} differs from "
                                 f"the brute-force-checked v1 count")
        print(f"meryl2 count label=#{lab}: {len(kmers)} k-mers equal to the "
              f"v1 count, every label {lab}, {wall:.3f} s wall, extract "
              f"LAUNCHES {extract_cuda.LAUNCHES - before}")
    count_launches = extract_cuda.LAUNCHES
    if count_launches == 0:
        raise AssertionError("meryl2 count never launched the extract kernel")
    a, b = _decode_labelled(MerylDB, la), _decode_labelled(MerylDB, lb)
    want = _meryl2_brute(a, b)
    slices, want["7-input"] = _write_slices(MerylDB, a, workdir)
    cmds = [
        ("union-sum", ["union-sum", la, lb]),
        ("intersect-min-xor", ["intersect", "assign:value=min",
                               "assign:label=xor", la, lb]),
        ("not-input-2", ["union-sum", "not", "select:input:@2", la, lb]),
        ("value-bases", ["union-max", "select:value:>=20", "and",
                         "select:bases:gc:>=11", la, lb]),
        ("mul-saturating", ["union", f"assign:value=mul#{MUL_CONST}", la,
                            lb]),
        ("7-input", ["union-sum", *slices]),
    ]
    total_entries, total_wall = 0, 0.0
    for name, argv in cmds:
        v2cli.reset_stats()
        before = rowsort.LAUNCHES
        t0 = time.perf_counter()
        rc = v2cli.main(argv + [f"output:database={out(name)}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rowsort.LAUNCHES - before
        if rc != 0:
            raise AssertionError(f"meryl2 {name} exited {rc}")
        n = _check_labelled(MerylDB, name, out(name), want[name])
        s = dict(v2cli.STATS)
        if name == "7-input":
            if s["row_dispatches"]:
                raise AssertionError("the 7-input action was row-packed")
        elif launches == 0 or launches != s["row_dispatches"]:
            raise AssertionError(f"meryl2 {name}: rowsort LAUNCHES "
                                 f"{launches} for {s['row_dispatches']} "
                                 f"row-packed dispatches")
        total_entries += s["entries"]
        total_wall += wall
        print(f"meryl2 {name}: {wall:.3f} s wall, {s['entries']} input "
              f"entries, {s['entries'] / wall / 1e6:.3f} M entries/s, {n} "
              f"output k-mers equal to brute force, {s['dispatches']} "
              f"dispatches ({s['row_dispatches']} row-packed, mean R "
              f"{s['rows'] / max(1, s['row_dispatches']):.1f}, mean L "
              f"{s['row_slots'] / max(1, s['rows']):.1f}), rowsort LAUNCHES "
              f"{launches}")
    u = _decode_labelled(MerylDB, out("union-sum"))
    hi, lo, c = MerylDB.open(db_u).load_all()
    if not (np.array_equal(u[0], lo) and np.array_equal(u[1], c)):
        raise AssertionError("meryl2 union-sum differs from phase 8's v1 "
                             "union-sum")
    for name, check in (("histogram", _check_histogram),
                        ("statistics", _check_statistics)):
        v2cli.reset_stats()
        before = rowsort.LAUNCHES
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = v2cli.main([name, out("union-sum")])
        wall = time.perf_counter() - t0
        launches = rowsort.LAUNCHES - before
        rows = v2cli.STATS["row_dispatches"]
        if rc != 0 or not check(buf.getvalue(), want["union-sum"][1]):
            raise AssertionError(f"meryl2 {name}: wrong report:\n"
                                 f"{buf.getvalue()[:2000]}")
        if launches == 0 or launches != rows:
            raise AssertionError(f"meryl2 {name}: rowsort LAUNCHES "
                                 f"{launches} for {rows} row-packed "
                                 f"dispatches")
        print(f"meryl2 {name} of union-sum: {wall:.3f} s wall, report equal "
              f"to brute force, {v2cli.STATS['dispatches']} dispatches "
              f"({rows} row-packed), rowsort LAUNCHES {launches}")
    ext, srt = extract_cuda.LAUNCHES, rowsort.LAUNCHES
    if ext == 0 or srt == 0:
        raise AssertionError(f"meryl2 path: extract LAUNCHES {ext}, rowsort "
                             f"LAUNCHES {srt}")
    print(f"meryl2 path: {total_entries} entries in {total_wall:.3f} s, "
          f"{total_entries / total_wall / 1e6:.3f} M entries/s; union-sum "
          f"equal to v1's in k-mers and values; extract LAUNCHES {ext}, "
          f"rowsort LAUNCHES {srt}")
    walls = _meryl2_layers(torch, v2cli, engine, rowsort, la, lb,
                           out("union-sum"), workdir)
    print("meryl2 union-sum walls, row-packed / flat in the same process: "
          + " / ".join(", ".join(f"{w:.3f}" for w in walls[x])
                       for x in ("row-packed", "flat")) + " s")
    sys.stdout.flush()
    torch.cuda.empty_cache()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--meryl2-trace", la, lb, workdir], check=True,
                   timeout=600)
    print(f"meryl2 phase wall {time.perf_counter() - t_phase:.1f} s")
    return ext, srt


def meryl2_trace(la, lb, workdir):
    """One `union-sum` of the labelled DBs under torch.profiler, in a
    process of its own (`chip_smoke.py --meryl2-trace A B DIR`), since a
    trace slows what runs after it in its process: an untraced run warms
    the process, then the traced run gives device time over the wall
    and the top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, ROOT)
    from meryl_tpu_torch.v2 import cli as v2cli
    path = os.path.join(workdir, "m2_traced.meryl")
    argv = ["union-sum", la, lb, f"output:database={path}"]
    t0 = time.perf_counter()
    rc = v2cli.main(argv)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    shutil.rmtree(path, ignore_errors=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc |= v2cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"traced meryl2 union-sum exited {rc}")
    ka = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in ka) / 1e3
    top = sorted(ka, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    busy = (f"device busy {dev_ms:.3f} ms = {dev_ms / 10 / wall:.2f} % of "
            f"the wall (idle {100 - dev_ms / 10 / wall:.2f} %)"
            if dev_ms > 0 else "the profiler traced no device time")
    print(f"meryl2 trace (union-sum in a process of its own, untraced "
          f"{warm:.3f} s, then traced): {wall:.3f} s wall; {busy}; "
          "top device ops: " + "; ".join(
              f"{e.key} {e.self_device_time_total / 1e3:.3f} ms "
              f"({e.count} calls)" for e in top), flush=True)
    return 0


# ------------------------------------------------------------ sharded

def _sharded_layers(torch, cli, accum, shard_count, fq, workdir):
    """The sharded count of phase 16 again with each layer of its step
    timed (the card is synchronized around every call).  -> ({layer:
    [seconds a call]}, steps)."""
    spots = [(accum, "route_chunk_packed", "route"),
             (shard_count, "exchange_cells", "all_to_all"),
             (shard_count, "routed_merge", "merge"),
             (shard_count.ShardedCounter, "settle", "settle")]
    db = os.path.join(workdir, "sharded_layers.meryl")
    with _call_clock(torch, spots) as calls, \
            shard_count.one_rank_group("cuda"):
        rc = _with_env({"MERYL_TPU_SHARDED": "1"}, lambda: cli.main(
            ["count", "k=21", fq, "output", db]))
    if rc != 0:
        raise AssertionError(f"timed sharded count exited {rc}")
    shutil.rmtree(db, ignore_errors=True)
    return calls, shard_count.LAST_SHARD_STATS["steps"]


def phase_sharded(torch, cli, accum, extract_cuda, MerylDB, fq, db_a, bases,
                  wall6, workdir):
    """Multi-GPU counting on the one card: (a) `MERYL_TPU_SHARDED=1
    meryl-torch count` of phase 6's FASTQ inside a 1-rank NCCL group
    (one_rank_group: the path of a launcher job's rank) at full width
    (2^22 bases a step, plan_shard_route's geometry), its DB equal to
    phase 6's; then the same count with each layer of its step timed,
    which gives scaling.py's t_local and t_merge; (b)
    count_to_db_multihost in a 1-rank group: the same DB, no parts
    directory left; (c) dryrun_multichip(1, "cuda", job=True): the three
    hatches through the CLI in a 1-rank NCCL group.  -> the extraction
    kernel's launches in (a)."""
    import torch.distributed as dist

    from meryl_tpu_torch.parallel import dryrun, multihost
    from meryl_tpu_torch.parallel import shard_count
    t_phase = time.perf_counter()
    g = shard_count.plan_shard_route(CHUNK, 21, 1)
    os.environ.pop("MERYL_TPU_SHARD_CHUNK", None)
    db_s = os.path.join(workdir, "sharded.meryl")
    torch.cuda.reset_peak_memory_stats()
    extract_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    with shard_count.one_rank_group("cuda"):
        if dist.get_backend() != "nccl":
            raise AssertionError(f"1-rank group on {dist.get_backend()}")
        rc = _with_env({"MERYL_TPU_SHARDED": "1"}, lambda: cli.main(
            ["count", "k=21", fq, "output", db_s]))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = extract_cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    stats = dict(shard_count.LAST_SHARD_STATS)
    if rc != 0:
        raise AssertionError(f"sharded count exited {rc}")
    if dist.is_initialized():
        raise AssertionError("the 1-rank group outlived the count")
    if not _same_db(MerylDB, db_s, db_a):
        raise AssertionError("sharded DB differs from phase 6's DB")
    if not (stats["steps"] >= 1 and launches >= stats["steps"]):
        raise AssertionError(f"extract launches {launches} < sharded steps "
                             f"{stats['steps']}")
    print(f"sharded count (1-rank NCCL group): {bases} bases, "
          f"{bases / wall / 1e6:.3f} Mbases/s ({wall:.3f} s wall incl. DB "
          f"write) against phase 6's {bases / wall6 / 1e6:.3f} Mbases/s "
          f"({wall6:.3f} s) in this run; DB equal to phase 6's (so to the "
          f"brute force); LAST_SHARD_STATS {json.dumps(stats)}; extract "
          f"LAUNCHES {launches}; max_memory_allocated {peak} B; geometry "
          f"B={g['B']} rpo={g['rpo']} R0={g['R0']} L0={g['L0']} c={g['c']} "
          f"Wc={g['Wc']}")

    calls, steps = _sharded_layers(torch, cli, accum, shard_count, fq,
                                   workdir)
    ms = {name: [t * 1e3 for t in v] for name, v in calls.items()}
    med = {name: float(np.median(v)) for name, v in ms.items()}
    print(f"sharded layers (ms, card synchronized around each call, "
          f"{steps} steps): " + "; ".join(
              f"{name} {len(v)} calls, first {v[0]:.3f}, median "
              f"{med[name]:.3f}, total {sum(v):.3f}"
              for name, v in ms.items()))
    # a step's route and merge at their medians (the first call of the
    # all-to-all makes the NCCL communicator)
    merges_a_step = len(ms["merge"]) / steps
    t_local = med["route"] / CHUNK * 1e6
    t_merge = med["merge"] * merges_a_step / (g["B"] * g["Wc"]) * 1e6
    print(f"scaling calibration: t_local {t_local:.4f} ns/base (median "
          f"route call / {CHUNK} bases), t_merge {t_merge:.4f} ns/slot "
          f"(median merge call x {merges_a_step:.3f} merges a step / "
          f"{g['B']} x {g['Wc']} slots a step); all_to_all_single "
          f"{med['all_to_all']:.3f} ms a step at "
          f"{g['B'] * g['Wc'] * 8 / med['all_to_all'] / 1e6:.2f} GB/s "
          f"(1 rank: NCCL's copy to itself)")

    db_m = os.path.join(workdir, "multihost.meryl")
    t0 = time.perf_counter()
    with shard_count.one_rank_group("cuda"):
        multihost.count_to_db_multihost([fq], db_m, 21, device="cuda")
        torch.cuda.synchronize()
    wall_m = time.perf_counter() - t0
    if dist.is_initialized():
        raise AssertionError("the multihost group outlived the count")
    if not _same_db(MerylDB, db_m, db_a):
        raise AssertionError("multihost DB differs from phase 6's DB")
    if os.path.exists(db_m + multihost.PART_DIR_SUFFIX):
        raise AssertionError("multihost parts directory left behind")
    print(f"multihost count (1-rank NCCL group, count_to_db_multihost): "
          f"{bases / wall_m / 1e6:.3f} Mbases/s ({wall_m:.3f} s), DB equal "
          f"to phase 6's, parts directory removed; LAST_SHARD_STATS "
          f"{json.dumps(shard_count.LAST_SHARD_STATS)}")

    dryrun.dryrun_multichip(1, "cuda", job=True)
    if dist.is_initialized():
        raise AssertionError("the dryrun's group outlived it")
    print(f"sharded phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


LOCAL_MEMBERS = 4   # phase 17's members on cuda:0


def phase_local_sharded(torch, cli, counter, accum, extract_cuda, MerylDB,
                        fq, db_a, bases, wall6, workdir):
    """Multi-GPU counting in one process (phase 17): (a)
    count_to_arrays_sharded over LOCAL_MEMBERS members on cuda:0 (a
    LocalGroup, one thread a member; the machine has one card) of phase
    6's FASTQ at full width (2^22 bases a member a step,
    plan_shard_route at n = LOCAL_MEMBERS), equal to phase 6's DB; then
    the same count with the route, the exchange and the owner merge
    timed a call (the card synchronized around each call; the members
    share cuda:0's stream, so a call's time holds what the other
    members queued meanwhile); (b) the CLI's MERYL_TPU_SHARDED=1 count
    over every visible card, equal to phase 6's DB; (c)
    dryrun_multichip(1, "cuda") in one process and dryrun_devices over
    LOCAL_MEMBERS members on cuda:0, each walking the three hatches.
    -> the extraction kernel's launches in (a)."""
    import torch.distributed as dist

    from meryl_tpu_torch.parallel import dryrun, local_group, shard_count
    t_phase = time.perf_counter()
    n = LOCAL_MEMBERS
    devices = ["cuda:0"] * n
    g = shard_count.plan_shard_route(CHUNK, 21, n)
    os.environ.pop("MERYL_TPU_SHARD_CHUNK", None)
    want = MerylDB.open(db_a).load_all()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    extract_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    got = counter.count_to_arrays_sharded([fq], 21, devices=devices)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = extract_cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    stats = dict(shard_count.LAST_SHARD_STATS)
    if dist.is_initialized():
        raise AssertionError("the in-process count made a process group")
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{n} members on cuda:0 differ from phase "
                             f"6's DB")
    if not (stats["steps"] >= 1 and launches >= n * stats["steps"]):
        raise AssertionError(f"extract launches {launches} < {n} members "
                             f"x {stats['steps']} steps")
    cards = torch.cuda.device_count()
    peer = "no two distinct cards in the group" if cards < 2 else \
        local_group.LocalGroup(range(cards)).peer_access()
    print(f"local sharded count ({n} members on cuda:0, one thread each): "
          f"{bases} bases, {bases / wall / 1e6:.3f} Mbases/s ({wall:.3f} s "
          f"wall, to arrays) against phase 6's {bases / wall6 / 1e6:.3f} "
          f"Mbases/s ({wall6:.3f} s, CLI incl. DB write) in this run; "
          f"equal to phase 6's DB (so to the brute force); LAST_SHARD_STATS "
          f"{json.dumps(stats)}; extract LAUNCHES {launches} (= {n} members "
          f"x {stats['steps']} steps + {launches - n * stats['steps']} "
          f"recount launches); max_memory_allocated {peak} B; peer access "
          f"{peer} ({cards} card(s)); geometry B={g['B']} rpo={g['rpo']} "
          f"R0={g['R0']} L0={g['L0']} c={g['c']} Wc={g['Wc']}")

    spots = [(accum, "route_chunk_packed", "route"),
             (shard_count, "exchange_cells", "exchange"),
             (shard_count, "routed_merge", "merge")]
    with _call_clock(torch, spots) as calls:
        timed = counter.count_to_arrays_sharded([fq], 21, devices=devices)
    if not all(np.array_equal(a, b) for a, b in zip(timed, want)):
        raise AssertionError("timed local sharded count differs")
    ms = {name: [t * 1e3 for t in v] for name, v in calls.items()}
    print(f"local sharded layers (ms a call, card synchronized around "
          f"each, {n} members, {shard_count.LAST_SHARD_STATS['steps']} "
          f"steps): " + "; ".join(
              f"{name} {len(v)} calls, median {float(np.median(v)):.3f}, "
              f"max {max(v):.3f}, total {sum(v):.3f}"
              for name, v in ms.items()))

    db_s = os.path.join(workdir, "local_sharded.meryl")
    t0 = time.perf_counter()
    rc = _with_env({"MERYL_TPU_SHARDED": "1"}, lambda: cli.main(
        ["count", "k=21", fq, "output", db_s]))
    torch.cuda.synchronize()
    wall_cli = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"MERYL_TPU_SHARDED=1 count exited {rc}")
    if dist.is_initialized():
        raise AssertionError("the CLI's in-process count made a group")
    if not _same_db(MerylDB, db_s, db_a):
        raise AssertionError("in-process sharded CLI DB differs from "
                             "phase 6's DB")
    shutil.rmtree(db_s, ignore_errors=True)
    print(f"CLI MERYL_TPU_SHARDED=1 count over every visible card "
          f"({cards}): {bases / wall_cli / 1e6:.3f} Mbases/s "
          f"({wall_cli:.3f} s incl. DB write), DB equal to phase 6's; "
          f"LAST_SHARD_STATS {json.dumps(shard_count.LAST_SHARD_STATS)}")

    dryrun.dryrun_multichip(1, "cuda")
    dryrun.dryrun_devices(devices)
    if dist.is_initialized():
        raise AssertionError("an in-process dryrun made a group")
    print(f"local sharded phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


JOB_MEMBERS = 4    # phase 18's members of the one process, on cuda:0


def phase_job_hybrid(torch, accum, extract_cuda, MerylDB, fq, db_a, bases,
                     wall6, card, workdir):
    """A job's process of several devices (phase 18): (a)
    count_to_db_multihost of phase 6's FASTQ over a JobGroup of
    JOB_MEMBERS members on cuda:0 (one thread each) in a 1-rank NCCL
    group (the machine has one card, and the launcher refuses P x D
    past it), at full width (2^22 bases a member a step), its DB equal
    to phase 6's; then count_to_arrays_multihost over the same group
    with the route, the two-level exchange's local gather, NCCL
    all_to_all_single and local scatter, and the owner merge timed a
    call (the card synchronized around each; the members share cuda:0's
    stream, so a call holds what the other members queued meanwhile);
    (b) dryrun_devices over the same group (job=True), walking the three
    hatches.  -> the extraction kernel's launches in (a)."""
    import torch.distributed as dist

    from meryl_tpu_torch.parallel import dryrun, local_group, multihost
    from meryl_tpu_torch.parallel import shard_count
    t_phase = time.perf_counter()
    n = JOB_MEMBERS
    devices = ["cuda:0"] * n
    g = shard_count.plan_shard_route(CHUNK, 21, n)
    for key in ("MERYL_TPU_CHUNK", "MERYL_TPU_SHARD_CHUNK"):
        os.environ.pop(key, None)
    db_j = os.path.join(workdir, "job_hybrid.meryl")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    extract_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    with shard_count.one_rank_group("cuda"):
        if dist.get_backend() != "nccl":
            raise AssertionError(f"1-rank group on {dist.get_backend()}")
        multihost.count_to_db_multihost([fq], db_j, 21, device="cuda",
                                        devices=devices)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = extract_cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    stats = dict(shard_count.LAST_SHARD_STATS)
    if dist.is_initialized():
        raise AssertionError("the job's 1-rank group outlived the count")
    if not _same_db(MerylDB, db_j, db_a):
        raise AssertionError("the job's DB differs from phase 6's DB")
    if os.path.exists(db_j + multihost.PART_DIR_SUFFIX):
        raise AssertionError("the job's parts directory was left behind")
    if not (stats["steps"] >= 1 and launches >= n * stats["steps"]):
        raise AssertionError(f"extract launches {launches} < {n} members "
                             f"x {stats['steps']} steps")
    shutil.rmtree(db_j, ignore_errors=True)
    print(f"job of 1 NCCL rank x {n} members on cuda:0 "
          f"(count_to_db_multihost, a JobGroup): {bases} bases, "
          f"{bases / wall / 1e6:.3f} Mbases/s ({wall:.3f} s wall incl. parts "
          f"and DB write) against phase 6's {bases / wall6 / 1e6:.3f} "
          f"Mbases/s ({wall6:.3f} s) in this run; DB equal to phase 6's (so "
          f"to the brute force); LAST_SHARD_STATS {json.dumps(stats)}; "
          f"extract LAUNCHES {launches} (= {n} members x {stats['steps']} "
          f"steps + {launches - n * stats['steps']} recount launches); "
          f"max_memory_allocated {peak} B; geometry B={g['B']} "
          f"rpo={g['rpo']} R0={g['R0']} L0={g['L0']} c={g['c']} "
          f"Wc={g['Wc']}; {card}")

    want = MerylDB.open(db_a).load_all()
    Member = local_group.JobMember
    spots = [(accum, "route_chunk_packed", "route"),
             (Member, "_gather", "gather"),
             (Member, "_procs_all_to_all", "nccl_all_to_all"),
             (Member, "_scatter", "scatter"),
             (shard_count, "routed_merge", "merge")]
    with _call_clock(torch, spots) as calls, \
            shard_count.one_rank_group("cuda"):
        parts = multihost.count_to_arrays_multihost(
            [fq], 21, device="cuda", devices=devices)
    got = [np.concatenate([p[i] for p in parts]) for i in (1, 2, 3)]
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("the timed job count differs from phase 6's DB")
    ms = {name: [t * 1e3 for t in v] for name, v in calls.items()}
    if not all(ms.values()):
        raise AssertionError(f"a layer of the job's step never ran: "
                             f"{ {k: len(v) for k, v in ms.items()} }")
    print(f"job layers (ms a call, card synchronized around each, {n} "
          f"members, {shard_count.LAST_SHARD_STATS['steps']} steps; "
          f"{card}): " + "; ".join(
              f"{name} {len(v)} calls, median {float(np.median(v)):.3f}, "
              f"max {max(v):.3f}, total {sum(v):.3f}"
              for name, v in ms.items()))
    grid = n * g["B"] * g["Wc"] * 8
    med = float(np.median(ms["nccl_all_to_all"]))
    print(f"job exchange: leader's send buffer {grid} B a step; NCCL "
          f"all_to_all_single median {med:.3f} ms, "
          f"{grid / med / 1e6:.2f} GB/s (1 rank: NCCL's copy to itself); "
          f"{card}")

    dryrun.dryrun_devices(devices, job=True)
    if dist.is_initialized():
        raise AssertionError("the job dryrun's group outlived it")
    print(f"job phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from meryl_tpu_torch import cli, counter, lookup, lookup_cli, native, optree
    from meryl_tpu_torch.db import MerylDB
    from meryl_tpu_torch.ops import accum, extract_cuda, rowsort
    from meryl_tpu_torch.ops import extract as ext
    from meryl_tpu_torch.ops import multiword as mw
    from meryl_tpu_torch.tools import ab_extract, ab_passfloor
    from meryl_tpu_torch.tools import position_lookup
    from meryl_tpu_torch.v2 import cli as v2cli
    from meryl_tpu_torch.v2 import engine

    card = phase_env(torch)
    phase_build({"extract.cu": extract_cuda, "rowsort.cu": rowsort}, native)
    max_err, ext_t = phase_kernel_parity(torch, ext, extract_cuda,
                                         ab_extract)
    err_a, err_b, err_d, rt = phase_rowsort_parity(torch, mw, rowsort,
                                                   ab_passfloor)
    i32_launches, floor_launches = phase_probe(torch, mw, rowsort)
    workdir = tempfile.mkdtemp(prefix="meryl_torch_smoke_")
    try:
        launches, genome, db_a, fq, reads, peak, wall6 = phase_main_path(
            torch, cli, counter, accum, extract_cuda, MerylDB, workdir)
        phase_hatches(counter, workdir)
        sort_launches, db_b = phase_setops(torch, cli, optree, rowsort,
                                           MerylDB, genome, db_a, workdir)
        rows = phase_setop_rows(torch, optree, rowsort, db_a, db_b)
        batched_ext, batched_sort = phase_batched(
            torch, cli, counter, extract_cuda, rowsort, MerylDB, fq, db_a,
            int(reads.size), workdir)
        phase_suffix(torch, cli, counter, MerylDB, fq, reads, workdir)
        phase_configure(torch, cli, counter, fq, workdir)
        phase_acc_memory(torch, cli, counter, accum, fq, peak, workdir)
        # phase 15 runs before 14, whose trace would slow it; its own
        # trace runs in a process of its own
        m2_ext, m2_sort = phase_meryl2(
            torch, v2cli, engine, extract_cuda, rowsort, MerylDB, fq,
            os.path.join(workdir, "reads_b.fq"), db_a, db_b,
            os.path.join(workdir, "u.meryl"), workdir)
        lookup_launches, _ = phase_lookup(
            torch, cli, lookup, lookup_cli, position_lookup, extract_cuda,
            MerylDB, genome, reads, db_a, db_b, workdir)
        sharded_ext = phase_sharded(torch, cli, accum, extract_cuda, MerylDB,
                                    fq, db_a, int(reads.size), wall6,
                                    workdir)
        local_ext = phase_local_sharded(
            torch, cli, counter, accum, extract_cuda, MerylDB, fq, db_a,
            int(reads.size), wall6, workdir)
        job_ext = phase_job_hybrid(torch, accum, extract_cuda, MerylDB, fq,
                                   db_a, int(reads.size), wall6, card,
                                   workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    probe = "scripts/probe_r4_pallas_sort.py"
    x21 = ext_t[(21, "canonical")]
    print(f"smoke wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": "extract", "route": "cuda",
         "source": "meryl_tpu_torch/csrc/extract.cu",
         "replaces": "meryl_tpu/ops/extract_pallas.py:136",
         "launches": launches, "max_abs_err": max_err, "ms": x21["alone"],
         "plain_ms": x21["plain"], "bound_ms": x21["bound"],
         "bound_by": x21["by"], "library_ms": None, "call_ms": x21["call"],
         "launches_batched": batched_ext, "launches_lookup": lookup_launches,
         "launches_meryl2": m2_ext, "launches_sharded": sharded_ext,
         "launches_local_sharded": local_ext,
         "launches_job_hybrid": job_ext,
         "path": "count", "shape": f"{CHUNK} codes k=21 canonical"},
        {"name": "rowsort_bitonic_keys", "route": "cuda",
         "source": "meryl_tpu_torch/csrc/rowsort.cu",
         "replaces": f"{probe}:69",
         "launches": sort_launches, "max_abs_err": max(err_b, rows["err"]),
         "ms": rows["ms"], "plain_ms": rows["plain"],
         "bound_ms": rows["bound"], "bound_by": rows["by"],
         "library_ms": rows["library"], "launches_batched": batched_sort,
         "launches_meryl2": m2_sort,
         "path": "set operations",
         "shape": rows["shape"]},
        {"name": "rowsort_bitonic_i32", "route": "cuda",
         "source": "meryl_tpu_torch/csrc/rowsort.cu",
         "replaces": f"{probe}:69",
         "launches": i32_launches, "max_abs_err": err_a, "ms": rt["a"],
         "plain_ms": rt["a_plain"], "bound_ms": rt["a_bound"][0],
         "bound_by": rt["a_bound"][1], "library_ms": rt["a_library"],
         "path": "probe", "shape": f"{PROBE_ROWS}x{PROBE_LEN}"},
        {"name": "rowsort_pass_floor", "route": "cuda",
         "source": "meryl_tpu_torch/csrc/rowsort.cu",
         "replaces": f"{probe}:94",
         "launches": floor_launches, "max_abs_err": err_d, "ms": rt["d"],
         "plain_ms": rt["d_plain"], "bound_ms": rt["d_bound"][0],
         "bound_by": rt["d_bound"][1], "library_ms": rt["d_library"],
         "alone_ms": rt["d_alone"], "path": "probe",
         "shape": f"{PROBE_ROWS}x{PROBE_LEN}"}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--meryl2-trace"]:
        sys.exit(meryl2_trace(*sys.argv[2:]))
    sys.exit(main())
