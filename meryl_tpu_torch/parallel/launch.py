"""Multi-process launcher: run the meryl-torch CLI as one job of P
processes on this machine, each with D devices (counterpart of
meryl_tpu/parallel/launch.py).

    python -m meryl_tpu_torch.parallel.launch --nprocs 2 \\
        [--devices-per-proc 4] -- count k=21 reads.fa output out.meryl \\
        [device=cpu]

Every process runs the same CLI argv; `count` sees the job
(MERYL_TPU_COORD / MERYL_TPU_NPROCS / MERYL_TPU_PROCID, and
MERYL_TPU_LOCAL_DEVICES=D from --devices-per-proc) and counts through
parallel/multihost.py: D members a process, one thread each.  On cuda
(the default) every member takes a card of its own, and P * D may not
pass torch.cuda.device_count(): a card is never shared between
processes and the job never runs gloo instead; device=cpu runs gloo
processes on the CPU, each with D CPU members.  When one process exits
with an error, the launcher ends the others.  On several machines, run
each process with the variables set directly, MERYL_TPU_COORD pointing
at process 0.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _device_word(argv) -> str:
    """The CLI's device= word (the last one wins), default cuda."""
    dev = "cuda"
    for w in argv:
        w = w.rstrip("]")
        if w.startswith("device="):
            dev = w[len("device="):]
    return dev


def _wait_all(procs, poll_s: float = 0.1, grace_s: float = 10.0) -> int:
    """Wait for every process; when one exits non-zero, end the others
    (a process that stopped alone would leave them waiting in a
    collective).  -> a failed process's exit code, else 0."""
    live = list(procs)
    while live:
        live = [p for p in live if p.poll() is None]
        failed = [p.returncode for p in procs
                  if p.returncode not in (None, 0)]
        if failed:
            for q in live:
                q.terminate()
            deadline = time.monotonic() + grace_s
            for q in live:
                try:
                    q.wait(max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    q.kill()
                    q.wait()
            return failed[0]
        time.sleep(poll_s)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    nprocs = 2
    dev_per_proc = None
    while argv and argv[0].startswith("--"):
        if argv[0] == "--nprocs":
            nprocs = int(argv[1])
            argv = argv[2:]
        elif argv[0] == "--devices-per-proc":
            dev_per_proc = int(argv[1])
            argv = argv[2:]
        elif argv[0] == "--":
            argv = argv[1:]
            break
        else:
            sys.stderr.write(f"unknown flag {argv[0]}\n")
            return 2
    if not argv or nprocs < 1 or (dev_per_proc or 1) < 1:
        sys.stderr.write(__doc__)
        return 2
    per = dev_per_proc or int(os.environ.get("MERYL_TPU_LOCAL_DEVICES")
                              or 1)
    if _device_word(argv).startswith("cuda"):
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if nprocs * per > have:
            sys.stderr.write(
                f"--nprocs {nprocs} --devices-per-proc {per}: this machine "
                f"has {have} CUDA device(s), and each of the job's "
                f"{nprocs * per} devices takes one card of its own; pass "
                f"device=cpu to run gloo processes on the CPU\n")
            return 2

    port = free_port()
    pypath = os.environ.get("PYTHONPATH")
    procs = []
    for pid in range(nprocs):
        env = dict(os.environ)
        env["MERYL_TPU_COORD"] = f"127.0.0.1:{port}"
        env["MERYL_TPU_NPROCS"] = str(nprocs)
        env["MERYL_TPU_PROCID"] = str(pid)
        if dev_per_proc:
            env["MERYL_TPU_LOCAL_DEVICES"] = str(dev_per_proc)
        env["PYTHONPATH"] = ROOT + (os.pathsep + pypath if pypath else "")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "meryl_tpu_torch"] + argv, env=env,
            stdout=None if pid == 0 else subprocess.DEVNULL))
    try:
        return _wait_all(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


if __name__ == "__main__":
    sys.exit(main())
