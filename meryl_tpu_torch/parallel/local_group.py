"""The groups a ShardedCounter exchanges over: several devices of one
process (LocalGroup, one Python thread a device), the ranks of a
torch.distributed job (DistGroup, one process a rank), or a job of
processes with several devices each (JobGroup: D threads in each of P
processes).

Each hands the counter a member with `rank`, `size`, `device`, `share`
(the members of its process on its device), `local` (its index among
its process's members) and the four collectives it makes, with the
torch.distributed semantics:

  all_to_all_single(out, inp)  split inp into size equal blocks along
                               dim 0; block d goes to member d, and what
                               member s sends lands in out's block s
  all_reduce(t, op)            t becomes the SUM, MAX or MIN over the
                               members, in place
  all_gather(tensors, t)       tensors[s] becomes member s's t
  barrier()

A LocalGroup is the counterpart of the reference's mesh of devices in
one process (meryl_tpu/counter.py count_to_arrays_sharded(mesh=)).  A
collective is two rendezvous on a threading.Barrier: every member posts
its tensor (and, on the card, a CUDA event recorded on its stream once
the tensor is ready), then reads the others' tensors, its stream
waiting on each sender's event; it posts an event of its own once its
reads are queued, and after the second rendezvous its stream waits on
every reader's event before it writes its own tensor or lets its send
buffer go.  A copy between two cards is a peer copy (NVLink where
torch.cuda.can_device_access_peer allows).  Nothing is fetched to the
host.  Devices may repeat: several members may share one device (the
tests' CPU members, a card shared by logical members).

A JobGroup is the counterpart of the reference's mesh over the devices
of several processes (meryl_tpu/parallel/multihost.py): member (p, l)
has global rank p * D + l, so rows ascend with the global device id, as
jax.devices() orders them.  Inside a process its members meet on a
LocalGroup's rendezvous; only the leader (l = 0) calls
torch.distributed, once a collective, on the process's stacked tensors
(NCCL refuses two ranks on one card, so one rank a thread cannot
serve).  A two-level collective is three rendezvous: every member posts
its tensor; the leader's stream waits on each member's ready event, it
gathers them and makes the distributed call (NCCL's stream runs after
the leader's current stream, and the leader's stream after NCCL's), and
posts the result with an event; every member's stream waits on that
event before it reads its share, and on every reader's event before
the buffers may be reused.

A member that raises aborts the barrier, so every other member raises
at its next rendezvous instead of waiting out the timeout; run()
re-raises the first member's own exception in the caller.  A process
of a job whose member failed exits, and the launcher ends the others.
"""

from __future__ import annotations

import threading
from datetime import timedelta

import torch
import torch.distributed as dist

from .. import resolve_device, trace

SUM, MAX, MIN = "sum", "max", "min"
_DIST_OPS = {SUM: "SUM", MAX: "MAX", MIN: "MIN"}

# how long a collective may wait for the other members before the group
# fails, so that a member that raised alone cannot hang the others
GROUP_TIMEOUT = timedelta(seconds=600)


def backend_for(device) -> str:
    """The collective backend of a device: NCCL for cuda, gloo for cpu."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    """A member's device: cuda without an index is the current one."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _reduce(tensors, op):
    x = torch.stack(tensors)
    if op == SUM:
        return x.sum(0, dtype=x.dtype)
    if op == MAX:
        return x.amax(0)
    if op == MIN:
        return x.amin(0)
    raise ValueError(f"op must be {SUM}, {MAX} or {MIN}, got {op!r}")


def _dist_op(op):
    return getattr(dist.ReduceOp, _DIST_OPS[op])


def _dist_barrier(device) -> None:
    """dist.barrier; on NCCL, on `device`'s card."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.device(device).index])
    else:
        dist.barrier()


class GroupFailed(RuntimeError):
    """A member of a LocalGroup could not complete a collective: another
    member failed, or the barrier timed out."""


class LocalGroup:
    """Members over an ordered list of devices of this process, one
    thread each while run() runs; a rendezvous waits GROUP_TIMEOUT."""

    def __init__(self, devices):
        self.devices = [rank_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a LocalGroup needs at least one device")
        n = len(self.devices)
        self.timeout = GROUP_TIMEOUT.total_seconds()
        self._barrier = threading.Barrier(n, timeout=self.timeout)
        self._posted = [None] * n   # (tensor, ready event)
        self._read = [None] * n     # reads-queued event
        self.members = [self._member(i) for i in range(n)]
        self.size = self.members[0].size

    def _member(self, local: int):
        return LocalMember(self, local)

    def peer_access(self) -> bool:
        """Whether every pair of distinct cards of the group copies
        peer to peer (True when the group has no two distinct cards)."""
        cards = sorted({d.index for d in self.devices if d.type == "cuda"})
        return all(torch.cuda.can_device_access_peer(a, b)
                   for a in cards for b in cards if a != b)

    def run(self, fn):
        """Call fn(member) on one thread a member; -> their results in
        member order.  A member that raises aborts the group; the first
        member exception (not a GroupFailed that it caused) re-raises
        here once every thread has ended."""
        n = len(self.members)
        results = [None] * n
        errors = []     # in the order the members failed
        lock = threading.Lock()

        def body(m):
            try:
                if m.device.type == "cuda":
                    torch.cuda.set_device(m.device)
                results[m.local] = fn(m)
            except BaseException as e:  # noqa: BLE001 - re-raised in run
                with lock:
                    errors.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(m,), daemon=True,
                                    name=f"meryl-member-{m.rank}")
                   for m in self.members]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._posted = [None] * n
        self._read = [None] * n
        if errors:
            self._barrier.reset()
            own = [e for e in errors if not isinstance(e, GroupFailed)]
            raise (own or errors)[0]
        return results

    # ------------------------------------------------------ rendezvous

    def _wait(self, rank: int) -> None:
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise GroupFailed(
                f"member {rank}: the group broke (another member failed, "
                f"or a rendezvous outwaited {self.timeout:g} s)") from None


def _event(device):
    """A CUDA event recorded on the current stream of device, or None
    on the CPU."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _wait_event(device, ev) -> None:
    if ev is not None:
        torch.cuda.current_stream(device).wait_event(ev)


class LocalMember:
    """One member of a LocalGroup: rank, size, device and the four
    collectives.  Its methods run on the member's own thread."""

    # cell grids the group's own buffers hold on this member's device
    # (default_acc_cap's reserve): a LocalGroup keeps none
    exchange_grids = 0

    def __init__(self, group: LocalGroup, local: int):
        self.group = group
        self.local = local
        self.rank = local
        self.size = len(group.devices)
        self.device = group.devices[local]
        self.share = sum(d == self.device for d in group.devices)

    def _exchange(self, t, read):
        """Post t, call read(posted) with every member's (tensor, ready
        event) once all have posted, then wait until every member's
        reads are queued (so t may be written or freed).  Span
        shard.exchange: the host time of one collective."""
        g = self.group
        with trace.span("shard.exchange"):
            g._posted[self.local] = (t, _event(self.device))
            g._wait(self.rank)
            out = read(g._posted)
            g._read[self.local] = _event(self.device)
            g._wait(self.rank)
            for ev in g._read:
                _wait_event(self.device, ev)
        return out

    def _fetch(self, src, ev):
        """A posted tensor on this member's device: the tensor itself on
        the same device, else a peer copy.  The copy runs on the current
        stream of the sender's device (PyTorch's copy between cards),
        so that stream waits on the sender's event first; PyTorch then
        has this member's stream wait on the copy."""
        _wait_event(src.device, ev)
        if src.device == self.device:
            return src
        return src.to(self.device, non_blocking=True)

    def all_to_all_single(self, out: torch.Tensor, inp: torch.Tensor):
        n = self.size
        if inp.shape[0] % n or out.shape != inp.shape:
            raise ValueError(f"all_to_all_single: {tuple(inp.shape)} into "
                             f"{tuple(out.shape)} over {n} members")
        blk = inp.shape[0] // n
        lo, hi = self.rank * blk, (self.rank + 1) * blk

        def read(posted):
            for s, (src, ev) in enumerate(posted):
                _wait_event(src.device, ev)
                out[s * blk:(s + 1) * blk].copy_(src[lo:hi],
                                                 non_blocking=True)
        self._exchange(inp, read)

    def all_reduce(self, t: torch.Tensor, op: str = SUM):
        red = self._exchange(t, lambda posted: _reduce(
            [self._fetch(src, ev) for src, ev in posted], op))
        t.copy_(red)

    def all_gather(self, tensors, t: torch.Tensor):
        def read(posted):
            for dst, (src, ev) in zip(tensors, posted):
                _wait_event(src.device, ev)
                dst.copy_(src, non_blocking=True)
        self._exchange(t, read)

    def barrier(self):
        self.group._wait(self.rank)


def _check_backend(device) -> None:
    """The default group must exist and run the device's backend."""
    if not dist.is_initialized():
        raise RuntimeError(
            "ShardedCounter needs a torch.distributed process group "
            "(parallel.multihost.init_from_env, or one_rank_group), "
            "or a LocalGroup member (group=)")
    want = backend_for(device)
    if dist.get_backend() != want:
        raise ValueError(f"device {device} needs the {want} backend; the "
                         f"group runs {dist.get_backend()}")


class DistGroup:
    """This process's rank of the default torch.distributed group, one
    device a rank (NCCL for cuda, gloo for cpu), with a LocalMember's
    interface.  run(fn) calls fn(self): the other ranks run in their own
    processes."""

    share = 1
    local = 0
    exchange_grids = 0

    def __init__(self, device="cuda"):
        self.device = rank_device(device)
        _check_backend(self.device)
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.members = [self]   # this process's

    def run(self, fn):
        return [fn(self)]

    def all_to_all_single(self, out, inp):
        dist.all_to_all_single(out, inp)

    def all_reduce(self, t, op: str = SUM):
        dist.all_reduce(t, op=_dist_op(op))

    def all_gather(self, tensors, t):
        dist.all_gather(tensors, t)

    def barrier(self):
        _dist_barrier(self.device)


class JobGroup(LocalGroup):
    """This process's D members of a job of P processes: D threads here
    over `devices` (which may repeat), P processes over the default
    torch.distributed group (NCCL for cuda, gloo for cpu), P * D members
    in all.  Every process of the job makes one with the same D.  With
    P = 1 the distributed calls still run, over the 1-rank group."""

    def __init__(self, devices):
        devs = [rank_device(d) for d in devices]
        if not devs:
            raise ValueError("a JobGroup needs at least one device")
        _check_backend(devs[0])
        self.nprocs = dist.get_world_size()
        self.proc = dist.get_rank()
        self._shared = None     # the leader's (result, event)
        super().__init__(devs)

    def _member(self, local: int):
        return JobMember(self, local)

    def run(self, fn):
        try:
            return super().run(fn)
        finally:
            self._shared = None  # the last collective's buffers


class JobMember(LocalMember):
    """Member (p, l) of a JobGroup: global rank p * D + l of P * D.  Its
    methods run on the member's own thread; the leader's (l = 0) make
    the distributed calls."""

    def __init__(self, group: JobGroup, local: int):
        super().__init__(group, local)
        d = len(group.devices)
        self.rank = group.proc * d + local
        self.size = group.nprocs * d
        # the leader's send and receive buffers of all_to_all_single:
        # each holds the process's D cell grids
        self.exchange_grids = 2 * d if self.device == group.devices[0] \
            else 0

    def _two_level(self, t, lead, read):
        """Post t; once all have, the leader calls lead(posted), with
        every member's (tensor, ready event), and posts its result; then
        every member calls read(result) and waits until every member's
        reads are queued.  Span shard.exchange, as LocalMember's."""
        g = self.group
        with trace.span("shard.exchange"):
            g._posted[self.local] = (t, _event(self.device))
            g._wait(self.rank)
            if self.local == 0:
                res = lead(g._posted)
                g._shared = (res, _event(self.device))
            g._wait(self.rank)
            res, ev = g._shared
            _wait_event(g.devices[0], ev)
            out = read(res)
            g._read[self.local] = _event(self.device)
            g._wait(self.rank)
            for e in g._read:
                _wait_event(self.device, e)
        return out

    def _gather(self, posted, shape):
        """Leader: the members' (P * D * blk, ...) inputs into one
        (P, D_src, D_dst, blk, ...) send buffer, contiguous a
        destination process."""
        src0 = posted[0][0]
        send = torch.empty(shape, dtype=src0.dtype, device=self.device)
        for m, (src, ev) in enumerate(posted):
            _wait_event(src.device, ev)
            send[:, m].copy_(src.reshape(shape[:1] + shape[2:]),
                             non_blocking=True)
        return send

    def _procs_all_to_all(self, recv, send):
        """Leader: one all_to_all_single over the processes."""
        dist.all_to_all_single(recv, send)

    def _scatter(self, out, recv):
        """Member l's blocks from every source (q, m): recv[q, m, l]."""
        g = self.group
        out.view((g.nprocs, len(g.devices)) + recv.shape[3:]).copy_(
            recv[:, :, self.local], non_blocking=True)

    def all_to_all_single(self, out: torch.Tensor, inp: torch.Tensor):
        n = self.size
        if inp.shape[0] % n or out.shape != inp.shape:
            raise ValueError(f"all_to_all_single: {tuple(inp.shape)} into "
                             f"{tuple(out.shape)} over {n} members")
        g = self.group
        d = len(g.devices)
        shape = (g.nprocs, d, d, inp.shape[0] // n) + tuple(inp.shape[1:])

        def lead(posted):
            send = self._gather(posted, shape)
            recv = torch.empty_like(send)
            self._procs_all_to_all(recv, send)
            return recv
        self._two_level(inp, lead, lambda recv: self._scatter(out, recv))

    def all_reduce(self, t: torch.Tensor, op: str = SUM):
        def lead(posted):
            red = _reduce([self._fetch(src, ev) for src, ev in posted], op)
            dist.all_reduce(red, op=_dist_op(op))
            return red
        self._two_level(t, lead, lambda red: t.copy_(red, non_blocking=True))

    def all_gather(self, tensors, t: torch.Tensor):
        d = len(self.group.devices)

        def lead(posted):
            mine = torch.stack([self._fetch(src, ev) for src, ev in posted])
            got = [torch.empty_like(mine) for _ in range(self.group.nprocs)]
            dist.all_gather(got, mine)
            return got

        def read(got):
            for q, stacked in enumerate(got):
                for m in range(d):
                    tensors[q * d + m].copy_(stacked[m], non_blocking=True)
        self._two_level(t, lead, read)

    def barrier(self):
        g = self.group
        g._wait(self.rank)
        if self.local == 0:
            _dist_barrier(self.device)
        g._wait(self.rank)
