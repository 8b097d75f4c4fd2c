"""Multi-GPU sharded k-mer counting: the route-first step over one
all-to-all (counterpart of meryl_tpu/parallel/shard_count.py).

A rank is a member of a group (parallel/local_group.py): one thread a
device of this process (LocalGroup, the reference's mesh), one process
a device of a torch.distributed job (DistGroup: NCCL on cuda, gloo on
cpu), or one thread a device of a process of such a job (JobGroup, the
reference's mesh over several processes).  The rank's code is the same
in all three; only the group object differs, and rank and size are
global.  Each rank feeds its own chunk every step.  A step is
the single-device accumulator's routed dataflow (ops/accum.py) with an
exchange in the middle:

  1. the rank extracts canonical windows from its chunk with the
     extraction kernel and routes them to B key-range bucket rows with
     the exact integer equal-mass map (accum.route_chunk_packed),
  2. bucket rows belong to owner ranks in contiguous blocks of
     rpo = B / n rows, so ONE all_to_all_single of the (B, Wc) cell grid
     ships every block to its owner with no gathers and no send-buffer
     packing; the owner lays what it receives out as (rpo, n * Wc), with
     source s in columns [s * Wc, (s + 1) * Wc),
  3. every MERGE_EVERY steps the owner folds its staged groups into its
     (rpo, La) sorted-unique accumulator (accum.merge_cells).

Exactness (every hatch exact, as in the reference): cell overflow is
captured and counted on the host by the SOURCE rank; a source whose
capture region overflows has its column block masked out of every
owner's staged group and recounts its chunk on the host sort path; an
accumulator row overflow re-runs the merge with grown rows, and past
the entry budget the accumulator spills to host RAM or disk; the
all-ones k-mer is excluded on the device and carried by a summed
scalar.

Lockstep: every rank makes the same collective calls in the same
order.  Every mask, spill, regrow and done decision comes from an
all-reduced value (the per-step (3, n) stats, the merge's row maximum),
so every rank takes it alike.  The host-side extras that may belong to
another owner (captures, recounted chunks) are exchanged at finalize
with two all_gathers and split by the same integer row map the device
routed with.  Keys travel as the port's int64 words; uint64 host arrays
cross as int64 bit patterns, since neither NCCL nor gloo has uint64.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .. import kmer as km
from .. import trace
from ..ops import accum
from ..ops import multiword as mw
from ..ops.accum import OVF_CAP
from .local_group import (GROUP_TIMEOUT, MAX, SUM, DistGroup, backend_for,
                          rank_device)

# hatch counters of this process's most recent sharded count, written
# once it ends (publish_stats): spills and steps are equal on every
# rank; captured_windows and recount_chunks count each rank's own
# chunks, summed over the ranks of the process (the reference's figure
# for the same mesh); members is the process's ranks, and peer_bytes
# the bytes of their all-to-all blocks that went to another rank.  A
# process of a job writes its own members'.
LAST_SHARD_STATS: dict = {}


def plan_shard_route(chunk_len: int, k: int, n: int) -> dict:
    """Static routing geometry of the step: the reference's
    (meryl_tpu/parallel/shard_count.py plan_shard_route), kept as it is
    for parity.  B is a multiple of n (the all-to-all splits rows into
    equal owner blocks) and the row map is the integer map (bits <= 16).
    Its constants were swept on the TPU, not on the H100."""
    L0 = min(1 << 18, chunk_len)
    while chunk_len % L0:
        L0 >>= 1
    R0 = chunk_len // L0
    bits = min(16, 2 * k)
    cap = 1 << max(0, min(10, 2 * k - 5))
    b_target = max(n, min(cap, max(1, L0 // 8)))
    rpo = max(1, b_target // n)
    B = n * rpo
    mean = max(1.0, L0 / B)
    c = max(4, int(mean + 3.0 * mean ** 0.5 + 4))
    return {"B": B, "rpo": rpo, "R0": R0, "L0": L0, "c": c,
            "bits": bits, "Wc": R0 * c}


def owner_of_keys(hi: np.ndarray, lo: np.ndarray, k: int, bits: int,
                  B: int, rpo: int, canonical: bool) -> np.ndarray:
    """Owner rank of each unsigned (hi, lo) k-mer: top `bits` bits ->
    accum.row_from_prefix_int -> row // rpo, the map the device routed
    with (integer arithmetic only, so host extras land on the owner
    whose accumulator holds their key range)."""
    twok = 2 * k
    hi = np.asarray(hi, np.uint64)
    lo = np.asarray(lo, np.uint64)
    if twok <= 64:
        pref = lo >> np.uint64(twok - bits) if twok > bits else lo
    else:
        hb = twok - 64  # bits stored in hi
        if bits <= hb:
            pref = hi >> np.uint64(hb - bits)
        else:
            need = bits - hb
            pref = (hi << np.uint64(need)) | (lo >> np.uint64(64 - need))
    row = accum.row_from_prefix_int(
        torch.from_numpy(pref.astype(np.int64)), bits, B, canonical)
    return (row.numpy() // rpo).astype(np.int32)


@contextlib.contextmanager
def one_rank_group(device):
    """The process group of a sharded count in one process: the default
    group when this process already has one, else a 1-rank group (NCCL
    on cuda, gloo on cpu) over a FileStore in a temporary directory,
    destroyed on exit."""
    if dist.is_initialized():
        yield
        return
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tmp = tempfile.mkdtemp(prefix="meryl_torch_group_")
    try:
        dist.init_process_group(
            backend_for(dev), store=dist.FileStore(
                os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, timeout=GROUP_TIMEOUT)
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ one rank
# The reference's three shard_map programs (make_routed_step,
# make_routed_merge, make_mask_sources) as plain functions on one rank's
# tensors around the group's collectives.

def exchange_cells(cells: torch.Tensor, group):
    """(B, Wc[, 2]) cell grid -> (rpo, n * Wc[, 2]) staged group: rows
    [d * rpo, (d + 1) * rpo) go to rank d, and what arrives from source
    s fills columns [s * Wc, (s + 1) * Wc) (the reference's tiled
    lax.all_to_all with split_axis 0 and concat_axis 1)."""
    n = group.size
    B, W = cells.shape[:2]
    tail = cells.shape[2:]
    out = torch.empty_like(cells)
    group.all_to_all_single(out, cells.contiguous())
    return out.reshape((n, B // n, W) + tail).transpose(0, 1) \
        .reshape((B // n, n * W) + tail)


def routed_step(packed2, exc, n_real: int, cfg: tuple, group):
    """One step of one rank: extract + route its chunk, exchange the
    cells.  -> (staged (rpo, n * Wc[, 2]), captured overflow (R0,
    OVF_CAP[, 2]), n_ovf_row (R0,), stats (3, n) int64 summed over the
    ranks): for each source s, [0, s] = 1 if its captures overflowed
    (mask it and recount its chunk), [1, s] its captured windows, [2, s]
    its all-ones k-mer count."""
    cells, ovf, n_ovf_row, n_allones = accum.route_chunk_packed(
        packed2, exc, n_real, cfg)
    staged = exchange_cells(cells, group)
    bad = (n_ovf_row.max() > OVF_CAP).to(torch.int64)
    ncap = torch.clamp(n_ovf_row, max=OVF_CAP).sum()
    stats = torch.zeros((3, group.size), dtype=torch.int64,
                        device=cells.device)
    stats[:, group.rank] = torch.stack([bad, ncap,
                                        n_allones.to(torch.int64)])
    group.all_reduce(stats, SUM)
    return staged, ovf, n_ovf_row, stats


def routed_merge(acc_key, acc_counts, staged, k: int, La_out: int,
                 vmax: int, group):
    """Fold staged groups into this rank's accumulator.  -> (keys,
    counts, nmax) with nmax the largest row's distinct keys over ALL
    ranks (all_reduce MAX): past La_out the rows were cut and the caller
    merges again with more room."""
    key, counts, n_runs = accum.merge_cells(acc_key, acc_counts,
                                            tuple(staged), k, La_out, vmax)
    nmax = n_runs.max().reshape(1).to(torch.int64)
    group.all_reduce(nmax, MAX)
    return key, counts, nmax


def mask_sources(staged, bad: np.ndarray, Wc: int, k: int):
    """Set the column block of every bad source to the sentinel
    (merge_cells drops sentinel keys), so its host recount is the only
    copy of its chunk."""
    cols = torch.from_numpy(np.repeat(bad, Wc)).to(staged.device)
    return mw.where(cols[None, :], mw.sentinel(k, staged.device), staged, k)


class ShardedCounter:
    """Multi-GPU counting, one rank of it: each rank feeds its own chunk
    a step; windows route to owner-keyed bucket rows, cross in one
    all-to-all, and each owner folds them into its sorted-unique
    accumulator.  Near its entry budget an accumulator spills to host
    RAM or spill_dir and resets.  finalize merges spills, accumulator and
    hatch extras per owner: owner key ranges ascend with rank, so the
    ranks' parts concatenate in order.

    group: a LocalGroup or JobGroup member (parallel/local_group.py),
    whose device is the rank's; or None, for this process's rank of the
    default torch.distributed group, which must exist, on `device`
    (default cuda), whose backend the group must have (NCCL for cuda,
    gloo for cpu)."""

    # staged groups folded per merge: each carries about n chunks' mass
    # an owner row, so the single device's M = 8 divides by n
    MERGE_EVERY = 2

    def __init__(self, k: int, *, chunk_len: int, mode: str = "canonical",
                 acc_cap: int | None = None, spill_dir: str | None = None,
                 device=None, group=None):
        if group is None:
            group = DistGroup("cuda" if device is None else device)
        elif device is not None and rank_device(device) != group.device:
            raise ValueError(f"device {device} is not the member's "
                             f"{group.device}")
        self.group = group
        self.device = group.device
        self.n = group.size
        self.rank = group.rank
        self.k = int(k)
        self.chunk_len = int(chunk_len)
        if self.chunk_len % 16:
            raise ValueError(f"chunk_len must be a multiple of 16, got "
                             f"{chunk_len}")
        self.mode = mode
        self.nplanes = km.num_planes(self.k)
        g = plan_shard_route(self.chunk_len, self.k, self.n)
        self.B, self.rpo, self.Wc = g["B"], g["rpo"], g["Wc"]
        self.bits = g["bits"]
        self.cfg = (self.k, self.nplanes, mode, g["B"], g["R0"], g["L0"],
                    g["c"], g["bits"])
        # per-rank accumulator entry budget (rpo rows x La columns);
        # MERYL_TPU_SHARD_ACC_CAP forces it (tests and the dryrun walk
        # the spill hatch with a tiny one)
        if acc_cap is None and os.environ.get("MERYL_TPU_SHARD_ACC_CAP"):
            acc_cap = int(os.environ["MERYL_TPU_SHARD_ACC_CAP"])
        if acc_cap is None:
            grid_bytes = self.B * self.Wc * 8 * mw.num_words(self.k)
            acc_cap = default_acc_cap(
                self.k, self.device, self.MERGE_EVERY * self.B * self.Wc,
                group.share, group.exchange_grids * grid_bytes)
        self.acc_cap = int(acc_cap)
        # the per-row cap has 2x slack: the equal-mass map balances rows
        # only in expectation; the proactive spill (nmax * rpo >= acc_cap
        # after a merge) keeps the total honest
        self.La_max = max(1, 2 * self.acc_cap // self.rpo)
        self.La0 = min(self.La_max,
                       max(64, accum._eighth_round(
                           self.MERGE_EVERY * self.n * self.Wc // 2)))
        self.La = self.La0
        self._acc = None           # (keys, counts) of this rank's rows
        self._acc_rows_used = 0    # nmax of the last verified merge
        self._unverified = None
        self._pending = []         # [(step outputs, host codes)]
        self._staged = []          # staged groups awaiting merge
        self._n_allones = 0
        self._captures = []        # captured window keys (int64 words)
        self._fallback_runs = []   # host-recounted chunks (hi, lo, c)
        self.spill_dir = spill_dir
        self._spill_seq = 0
        self._spills: dict = {}
        self._finalized = False
        self._owned_extras = None  # settle(): the extras this rank owns
        self.masked_steps = 0      # steps with a bad source masked out
        self.stats = {"spills": 0, "recount_chunks": 0,
                      "captured_windows": 0, "steps": 0}
        # what a step's all-to-all sends to the other ranks: n - 1 of
        # the n blocks of its (B, Wc) int64 cell grid
        self._peer_step = (self.n - 1) * self.rpo * self.Wc * 8 \
            * mw.num_words(self.k)

    @property
    def peer_bytes(self) -> int:
        """Bytes this rank's all-to-alls sent to the other ranks."""
        return self.stats["steps"] * self._peer_step

    def _fresh_acc(self, La: int):
        tail = () if mw.num_words(self.k) == 1 else (2,)
        key = mw.sentinel(self.k, self.device).expand(
            (self.rpo, La) + tail).clone()
        return key, torch.zeros((self.rpo, La), dtype=torch.int64,
                                device=self.device)

    # ------------------------- feed path ------------------------------

    def prepack(self, codes: np.ndarray):
        """Pad + 2-bit-pack this rank's chunk for add_codes (the reader
        thread runs it).  An empty chunk is the keep-alive pad: all
        separators, n_real 0, no exceptions."""
        if len(codes) > self.chunk_len:
            raise ValueError(f"chunk of {len(codes)} codes, chunk_len "
                             f"{self.chunk_len}")
        from ..counter import prepack
        return prepack(codes, self.chunk_len)

    def add_codes(self, codes) -> None:
        """codes: this rank's (<= chunk_len,) uint8 chunk, or a prepack
        tuple; every rank calls add_codes once a step.

        Pipelined 1 deep: the previous step's summed stats are resolved
        after this step is dispatched, so hatch handling surfaces one
        call late (or at finalize), always before any result."""
        with trace.span("shard.step"):
            if not isinstance(codes, tuple):
                codes = self.prepack(codes)
            raw, packed2, exc, n_real, _ = codes
            out = routed_step(
                torch.from_numpy(packed2.view(np.int32)).to(self.device),
                torch.from_numpy(exc).to(self.device), n_real, self.cfg,
                self.group)
            self.stats["steps"] += 1
            self._pending.append((out, raw))
            if len(self._pending) > 1:
                self._resolve_pending(keep_last=True)
            if len(self._staged) >= self.MERGE_EVERY:
                self._merge_staged()

    def _resolve_pending(self, keep_last: bool = False) -> None:
        pend = self._pending[:-1] if keep_last else self._pending
        self._pending = self._pending[-1:] if keep_last else []
        if not pend:
            return
        # one fetch for all pending steps' stats
        stats = torch.stack([p[0][3] for p in pend]).cpu().numpy()
        for (out, codes), st in zip(pend, stats):
            self._resolve_one(out, codes, st)

    def _resolve_one(self, out, codes, st) -> None:
        staged, ovf, n_ovf_row, _ = out
        bad = st[0] > 0
        if bad.any():
            staged = mask_sources(staged, bad, self.Wc, self.k)
            self.masked_steps += 1
            if bad[self.rank]:
                self._recount_chunk(codes)
        if not bad[self.rank] and st[1][self.rank] > 0:
            self._collect_captures(ovf, n_ovf_row)
        # all-ones k-mers of good sources only (a bad source's recount
        # counts its own)
        self._n_allones += int(st[2][~bad].sum())
        self._staged.append(staged)

    def _recount_chunk(self, codes_np: np.ndarray) -> None:
        from ..counter import _count_chunk, _finish_chunk
        self.stats["recount_chunks"] += 1
        self._fallback_runs.extend(_finish_chunk(
            *_count_chunk(codes_np, self.k, self.mode, self.device)))

    def _collect_captures(self, ovf, n_ovf_row) -> None:
        """This rank's captured overflow windows: the head of each
        capture row."""
        nrow = n_ovf_row.cpu().numpy()
        ovf_np = ovf.cpu().numpy()
        for r in np.flatnonzero(nrow > 0):
            take = min(int(nrow[r]), OVF_CAP)
            self.stats["captured_windows"] += take
            self._captures.append(ovf_np[r, :take].copy())

    # ------------------------- merge path -----------------------------

    def _merge_staged(self) -> None:
        """Dispatch the merge and defer its nmax check to the next merge
        (or finalize); every rank defers the same all-reduced scalar, so
        the ranks stay in lockstep.  The pre-merge accumulator and the
        staged groups stay alive in _unverified until the check clears."""
        self._verify_merge()
        staged = self._staged
        self._staged = []
        if not staged:
            return
        if self._acc is None:
            self._acc = self._fresh_acc(self.La)
        key, counts, nmax = routed_merge(
            self._acc[0], self._acc[1], staged, self.k, self.La,
            int(km.VALUE_MAX), self.group)
        self._unverified = (key, counts, nmax, self._acc, staged, self.La)
        self._acc = (key, counts)  # optimistic: overflow is rare

    def _verify_merge(self) -> None:
        uv = self._unverified
        if uv is None:
            return
        self._unverified = None
        key, counts, nmax_d, old_acc, staged, la_then = uv
        nmax = int(nmax_d.item())  # all-reduced: lockstep-safe
        if nmax <= la_then:
            self._acc_rows_used = nmax
            if nmax * self.rpo >= self.acc_cap:
                self.spill()  # total-entry budget reached
            return
        # cut rows: merge again against the kept pre-merge accumulator
        self._acc = old_acc
        La_out = self.La
        while True:
            need = accum._eighth_round(nmax)
            if need <= self.La_max:
                La_out = need
            elif self._acc_nonempty():
                # past the budget: spill and retry into a fresh one
                self.spill()
                self._acc = self._fresh_acc(self.La0)
                self.La = self.La0
                La_out = min(self.La_max, max(self.La0, need))
            else:
                raise RuntimeError(
                    f"ShardedCounter accumulator overflow: one merge "
                    f"needs {nmax} entries/row x {self.rpo} rows with "
                    f"acc_cap={self.acc_cap}; raise acc_cap")
            key, counts, nmax_d = routed_merge(
                self._acc[0], self._acc[1], staged, self.k, La_out,
                int(km.VALUE_MAX), self.group)
            nmax = int(nmax_d.item())
            if nmax <= La_out:
                break
        self._acc = (key, counts)
        self.La = La_out
        self._acc_rows_used = nmax
        if nmax * self.rpo >= self.acc_cap:
            self.spill()

    def _acc_nonempty(self) -> bool:
        return self._acc is not None and self._acc_rows_used > 0

    # ------------------------- spill path -----------------------------

    def _download_acc(self):
        """{rank: (hi, lo, counts)} of this rank's accumulated run, the
        used entries selected on the device; rows partition the key
        range in ascending order and each row is sorted, so the run is
        sorted."""
        from ..counter import _to_host
        key, counts = self._acc
        keep = counts > 0
        if not bool(keep.any()):
            return {}
        hi, lo = mw.to_hilo(_to_host(key[keep]), self.k)
        return {self.rank: (hi, lo,
                            _to_host(counts[keep]).astype(np.uint64))}

    def spill(self) -> None:
        """Move this rank's accumulated run to host RAM (or a spill_dir
        .npz) and reset the accumulator: the out-of-core batch dump.
        Every rank spills at the same step (the trigger is all-reduced)."""
        if self._acc is None or not self._acc_nonempty():
            return
        for d, run in self._download_acc().items():
            if len(run[2]):
                self._spills.setdefault(d, []).append(
                    self._store_run(d, run))
        self.stats["spills"] += 1
        self._acc = None
        self._acc_rows_used = 0
        self.La = self.La0
        self._spill_seq += 1

    def _store_run(self, d: int, run):
        if self.spill_dir is None:
            return run
        os.makedirs(self.spill_dir, exist_ok=True)
        p = os.path.join(self.spill_dir, f"spill_r{d}_s{self._spill_seq}.npz")
        np.savez(p, hi=run[0], lo=run[1], c=run[2])
        return p

    @staticmethod
    def _load_run(run):
        if not isinstance(run, str):
            return run
        z = np.load(run)
        return z["hi"], z["lo"], z["c"]

    # ------------------------ finalize path ---------------------------

    def _extras_run(self):
        """This rank's host-side extras as one sorted unique (hi, lo,
        counts) run: captured windows (count 1 each) union-merged with
        the recounted chunks."""
        from ..counter import _unique_run, merge_runs
        runs = list(self._fallback_runs)
        self._fallback_runs = []
        if self._captures:
            keys = np.concatenate(self._captures)
            self._captures = []
            # the capture rows hold real keys only (the all-ones k-mer is
            # excluded at extraction): a sentinel here can only be padding
            sent = np.array(mw.sentinel_words(self.k), np.int64)
            real = ~(keys.reshape(len(keys), -1) == sent).all(axis=1)
            runs.append(_unique_run(*mw.to_hilo(keys[real], self.k)))
        if not runs:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.uint64)
        hi, lo, c = merge_runs(runs)
        return hi, lo, c.astype(np.uint64)

    def _exchange_extras(self, hi, lo, c):
        """Every rank's extras to every rank (two all_gathers: the
        lengths, then a padded (3, mx) buffer), so each keeps what it
        owns.  -> one sorted unique run a rank, in rank order.  Extras
        are hatch tails, thin by construction."""
        if self.n <= 1:
            return [(hi, lo, c)]
        lens_t = [torch.zeros(1, dtype=torch.int64, device=self.device)
                  for _ in range(self.n)]
        self.group.all_gather(lens_t, torch.tensor(
            [len(c)], dtype=torch.int64, device=self.device))
        lens = torch.cat(lens_t).cpu().numpy()
        mx = int(lens.max())
        if mx == 0:
            return [(hi, lo, c)]
        buf = np.zeros((3, mx), np.uint64)
        for i, a in enumerate((hi, lo, c)):
            buf[i, :len(c)] = a
        mine = torch.from_numpy(buf.view(np.int64)).to(self.device)
        got = [torch.empty_like(mine) for _ in range(self.n)]
        self.group.all_gather(got, mine)
        allb = torch.stack(got).cpu().numpy().view(np.uint64)
        return [tuple(allb[r, i, :lens[r]] for i in range(3))
                for r in range(self.n)]

    def settle(self) -> None:
        """Every collective of finalize: resolve the pending steps,
        merge what is staged, check the last merge, exchange the hatch
        extras and keep those this rank owns.  Every rank calls it (in
        lockstep); owner_parts then needs no other rank.  Once only."""
        if self._finalized:
            raise RuntimeError(
                "ShardedCounter already finalized: finalize()/"
                "finalize_parts()/iter_finalized_parts() consume the "
                "accumulator and may be called only once")
        self._finalized = True
        self._resolve_pending()
        if self._staged:
            self._merge_staged()
        self._verify_merge()

        # extras: exchanged, then split by owner with the device's map;
        # each source's run stays a run of its own (sorted and unique),
        # since two sources may hold the same k-mer
        extras = []
        for ehi, elo, ec in self._exchange_extras(*self._extras_run()):
            if len(ec):
                m = owner_of_keys(ehi, elo, self.k, self.bits, self.B,
                                  self.rpo, self.mode == "canonical") \
                    == self.rank
                if m.any():
                    extras.append((ehi[m], elo[m], ec[m].astype(np.uint64)))

        # the all-ones k-mer (excluded on the device) tops the key space:
        # the last owner appends it, from the summed scalar
        if self._n_allones and self.rank == self.n - 1:
            twok = 2 * self.k
            extras.append((
                np.array([(1 << max(0, twok - 64)) - 1], np.uint64),
                np.array([(1 << min(64, twok)) - 1], np.uint64),
                np.array([self._n_allones], np.uint64)))
        self._owned_extras = extras

    def owner_parts(self):
        """After settle: yield this rank's (owner row, hi, lo, counts):
        spilled runs, the live accumulator and the hatch extras it owns,
        union-summed.  No collective, so any thread may drain the ranks'
        parts one owner at a time (with spill_dir, host peak is one
        owner's range)."""
        from ..counter import INSERT_MAX, insert_runs, merge_runs
        if self._owned_extras is None:
            raise RuntimeError("owner_parts() runs once, after settle()")
        extras, self._owned_extras = self._owned_extras, None
        with trace.span("shard.owner_parts"):
            acc_runs = self._download_acc() if self._acc_nonempty() else {}
            self._acc = None
            runs = [self._load_run(r)
                    for r in self._spills.pop(self.rank, [])]
            runs += list(acc_runs.values()) + extras
            runs.sort(key=lambda r: len(r[2]), reverse=True)
            if len(runs) > 1 and sum(len(r[2]) for r in runs[1:]) \
                    <= INSERT_MAX:
                # a few captured windows beside the accumulator's run
                part = insert_runs(runs[0], runs[1:])
            else:
                part = merge_runs(runs) if runs else None
        if part is not None:
            yield (self.rank,) + part

    def iter_finalized_parts(self):
        """settle, then owner_parts: a generator, so a caller can stream
        owner ranges into a DB writer."""
        self.settle()
        yield from self.owner_parts()

    def finalize_parts(self):
        """-> [(owner row, hi, lo, counts)] of this rank, materialized."""
        return list(self.iter_finalized_parts())

    def finalize(self):
        """-> (hi, lo, counts) of this rank's owner range, sorted unique;
        at one rank, the whole count.  Histograms and statistics come
        from these final counts (MerylDB.write), never from partials."""
        parts = self.finalize_parts()
        if not parts:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.uint32)
        return (np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]),
                np.concatenate([p[3] for p in parts]).astype(np.uint32))


def default_acc_cap(k: int, device, staged_slots: int,
                    share: int = 1, reserved_bytes: int = 0) -> int:
    """Entries a rank's accumulator may hold before it spills: the
    rank's part of its device budget (counter.acc_cap_bytes: half the
    card, or MERYL_TPU_ACC_CAP_GB, less the group's own buffers on that
    device, `reserved_bytes`, over the `share` ranks on it) over the
    bytes merge_cells holds a slot (counter.acc_bytes_per_unique), less
    one merge's staged cells, and halved, since a row may grow to twice
    its share (La_max)."""
    from ..counter import acc_bytes_per_unique, acc_cap_bytes
    slots = max(0, acc_cap_bytes(device) - reserved_bytes) // share \
        // acc_bytes_per_unique(k)
    return max(1, (slots - staged_slots) // 2)


def combine_stats(stats) -> dict:
    """The hatch counters of a count from its ranks' `stats` dicts:
    spills and steps of the first rank (equal on every rank), captured
    windows and recounted chunks summed."""
    return {key: stats[0][key] if key in ("spills", "steps")
            else sum(s[key] for s in stats) for key in stats[0]}


def publish_stats(counters) -> None:
    """LAST_SHARD_STATS of a count over this process's ranks
    `counters`."""
    LAST_SHARD_STATS.clear()
    LAST_SHARD_STATS.update(combine_stats([c.stats for c in counters]),
                            members=len(counters),
                            peer_bytes=sum(c.peer_bytes for c in counters))
