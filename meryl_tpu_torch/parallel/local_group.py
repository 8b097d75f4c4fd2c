"""The groups a ShardedCounter exchanges over: several devices of one
process (LocalGroup, one Python thread a device) or the ranks of a
torch.distributed job (DistGroup, one process a rank).

Both hand the counter a member with `rank`, `size`, `device`, `share`
(the members on its device) and the four collectives it makes, with
the torch.distributed semantics:

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

A member that raises aborts the barrier, so every other member raises
at its next rendezvous instead of waiting out the timeout; run()
re-raises the first member's own exception in the caller.
"""

from __future__ import annotations

import threading
from datetime import timedelta

import torch
import torch.distributed as dist

from .. import resolve_device

SUM, MAX, MIN = "sum", "max", "min"

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
        self.size = len(self.devices)
        self.timeout = GROUP_TIMEOUT.total_seconds()
        self._barrier = threading.Barrier(self.size, timeout=self.timeout)
        self._posted = [None] * self.size   # (tensor, ready event)
        self._read = [None] * self.size     # reads-queued event
        self.members = [LocalMember(self, r) for r in range(self.size)]

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
        results = [None] * self.size
        errors = []     # in the order the members failed
        lock = threading.Lock()

        def body(m):
            try:
                if m.device.type == "cuda":
                    torch.cuda.set_device(m.device)
                results[m.rank] = fn(m)
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
        self._posted = [None] * self.size
        self._read = [None] * self.size
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

    def __init__(self, group: LocalGroup, rank: int):
        self.group = group
        self.rank = rank
        self.size = group.size
        self.device = group.devices[rank]
        self.share = sum(d == self.device for d in group.devices)

    def _exchange(self, t, read):
        """Post t, call read(posted) with every member's (tensor, ready
        event) once all have posted, then wait until every member's
        reads are queued (so t may be written or freed)."""
        g = self.group
        g._posted[self.rank] = (t, _event(self.device))
        g._wait(self.rank)
        out = read(g._posted)
        g._read[self.rank] = _event(self.device)
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


_DIST_OPS = {SUM: "SUM", MAX: "MAX", MIN: "MIN"}


class DistGroup:
    """This process's rank of the default torch.distributed group, one
    device a rank (NCCL for cuda, gloo for cpu), with a LocalMember's
    interface.  run(fn) calls fn(self): the other ranks run in their own
    processes."""

    share = 1

    def __init__(self, device="cuda"):
        if not dist.is_initialized():
            raise RuntimeError(
                "ShardedCounter needs a torch.distributed process group "
                "(parallel.multihost.init_from_env, or one_rank_group), "
                "or a LocalGroup member (group=)")
        self.device = rank_device(device)
        want = backend_for(self.device)
        if dist.get_backend() != want:
            raise ValueError(
                f"device {self.device} needs the {want} backend; the group "
                f"runs {dist.get_backend()}")
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.members = [self]   # this process's

    def run(self, fn):
        return [fn(self)]

    def all_to_all_single(self, out, inp):
        dist.all_to_all_single(out, inp)

    def all_reduce(self, t, op: str = SUM):
        dist.all_reduce(t, op=getattr(dist.ReduceOp, _DIST_OPS[op]))

    def all_gather(self, tensors, t):
        dist.all_gather(tensors, t)

    def barrier(self):
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()
