"""One run of one cell: set-up, the measured window, the check.

A traffic mix (traffic/<mix>.json) is data:
  "metric"  {"name": end-to-end metric, "scale": factor}: the rate is
            the work of every job in the window, times the scale, over
            the window's seconds
  "inputs"  the files to make (harness/inputs.py)
  "setup"   commands run once before the warm job (not timed)
  "job"     the commands of one job, each {"command", "argv", "work"}:
            "command" is what a user types ("meryl", "meryl-lookup"),
            "argv" its words, "work" {"bases": input} (the bases of a
            generated input) or {"entries": [database, ...]} (their
            entries, as the reference counts them)
Words may name {k}, {work} (the set-up directory), {out} (the job's own
output directory, emptied before each job) and each input by its name.

The window is a closed loop of jobs: a job starts only while less than
`seconds` have passed, and the last one runs to its end.  The first
job of the window writes to one directory and every later job to
another, so the check reads the outputs of the first job and of the
last.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import importlib
import io
import os
import re
import shutil
import sys
import time
import traceback
from dataclasses import dataclass, field

import torch

from harness import check, devtrace
from harness.inputs import make_inputs
from reference.meryl import Reference

# a user's command -> the program's entry point, and the words that put
# it on the CPU (the tests' runs; on the card a command runs as typed)
ENTRIES = {
    "meryl": ("meryl_tpu_torch.cli", "main", ["device=cpu"]),
    "meryl-lookup": ("meryl_tpu_torch.lookup_cli", "main",
                     ["-device", "cpu"]),
}

BANNED = ("jax", "jaxlib", "flax", "meryl_tpu")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is banned, compared whole:
    meryl_tpu_torch is not meryl_tpu."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in BANNED)


class SetupFailed(RuntimeError):
    pass


@dataclass
class Command:
    command: str
    argv: list
    work: dict


@dataclass
class Done:
    """A command of the window as it ran."""
    cmd: Command
    job: int
    slot: str
    rc: int
    seconds: float
    stdout: str | None
    probes: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)


def _resolve(word: str, names: dict) -> str:
    return re.sub(r"\{([^{}]+)\}", lambda m: names[m.group(1)], word)


def _probe(spec: str):
    mod, attr = spec.split(":")
    return getattr(importlib.import_module(mod), attr)


class Runner:
    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: str, workdir: str, log=None):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = torch.device(device)
        self.workdir = workdir
        self.log = log or sys.stderr
        self.k = int(cell.config["k"])
        self.traffic = cell.traffic
        self.times: dict[str, float] = {}
        self.done: list[Done] = []
        self.probes_start: dict = {}
        self.trace_result = None

    # ---------------------------------------------------------- commands

    def _names(self, slot_dir: str) -> dict:
        names = {"k": str(self.k), "work": self.workdir, "out": slot_dir}
        names.update({n: i.path for n, i in self.inputs.items()})
        return names

    def commands(self, steps, slot_dir: str) -> list[Command]:
        names = self._names(slot_dir)
        return [Command(s["command"], [_resolve(w, names) for w in s["argv"]],
                        {kk: ([_resolve(x, names) for x in v]
                              if isinstance(v, list) else v)
                         for kk, v in s.get("work", {}).items()})
                for s in steps]

    def call(self, cmd: Command, capture: bool):
        """Run one command in this process -> (rc, stdout or None)."""
        mod, fn, cpu_words = ENTRIES[cmd.command]
        main = getattr(importlib.import_module(mod), fn)
        argv = list(cmd.argv) + (cpu_words if self.device.type == "cpu"
                                 else [])
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = main(argv)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
        except Exception:                       # a failed command counts
            traceback.print_exc(limit=4, file=self.log)
            rc = 1
        return int(rc or 0), (buf.getvalue() if capture else None)

    def _slot(self, name: str) -> str:
        d = os.path.join(self.workdir, "slot-" + name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        return d

    # ------------------------------------------------------------- phases

    def setup(self):
        t = time.perf_counter()
        self.inputs = make_inputs(self.cell.config, self.traffic["inputs"],
                                  self.seed, self.workdir)
        self.times["inputs_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for cmd in self.commands(self.traffic.get("setup", []),
                                 self.workdir):
            rc, _ = self.call(cmd, False)
            if rc:
                raise SetupFailed(f"set-up command {cmd.command} "
                                  f"{' '.join(cmd.argv)} exited {rc}")
        self.times["setup_commands_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for cmd in self.commands(self.traffic["job"], self._slot("warm")):
            rc, _ = self.call(cmd, False)
            if rc:
                raise SetupFailed(f"warm job: {cmd.command} "
                                  f"{' '.join(cmd.argv)} exited {rc}")
        shutil.rmtree(os.path.join(self.workdir, "slot-warm"))
        self.times["warm_job_s"] = time.perf_counter() - t

    def window(self, probe_specs=()):
        """The measured loop; -> seconds from its start to the end of its
        last job."""
        probes = {s: _probe(s) for s in probe_specs}
        snap = (lambda: {s: copy.deepcopy(v) for s, v in probes.items()})
        self.probes_start = snap()
        prof = None
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        span = (torch.profiler.record_function if self.trace
                else (lambda _name: contextlib.nullcontext()))
        t0 = time.perf_counter()
        jobs = 0
        with span(devtrace.WINDOW_SPAN):
            while True:
                slot = "first" if jobs == 0 else "last"
                for cmd in self.commands(self.traffic["job"],
                                         self._slot(slot)):
                    c0 = time.perf_counter()
                    with span(devtrace.SPAN_PREFIX + cmd.command + " "
                              + cmd.argv[0]):
                        rc, out = self.call(cmd, True)
                    self.done.append(Done(cmd, jobs, slot, rc,
                                          time.perf_counter() - c0, out,
                                          snap() if probes else {}))
                jobs += 1
                if time.perf_counter() - t0 >= self.seconds:
                    break
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            self.trace_result = devtrace.reduce(prof)
        self.jobs = jobs
        return window_s

    def check(self):
        """Work out every output of the first and last jobs with the
        reference and compare -> ({slot: mismatches}, detail lines).
        Also fills each command's work."""
        seqs = {i.path: i.reads for i in self.inputs.values()}
        ref = Reference(self.k, self.device, seqs)
        for cmd in self.commands(self.traffic.get("setup", []),
                                 self.workdir):
            ref.run(cmd.command, cmd.argv)
        last = {}
        for d in self.done:
            last[(d.slot, d.cmd.command, tuple(d.cmd.argv))] = d
        result, lines = {}, []
        slots = [s for s in ("first", "last")
                 if any(d.slot == s for d in self.done)]
        for slot in slots:
            n = 0
            for cmd in self.commands(self.traffic["job"],
                                     os.path.join(self.workdir,
                                                  "slot-" + slot)):
                want = ref.run(cmd.command, cmd.argv)
                got = last.get((slot, cmd.command, tuple(cmd.argv)))
                for path, (keys, counts) in want["db"].items():
                    m, why = check.compare_db(path, self.k, keys, counts)
                    n += m
                    if m:
                        lines.append(f"{slot} {os.path.basename(path)}: "
                                     f"{m} ({why})")
                for path, text in want["text"].items():
                    m, why = check.compare_file(path, text)
                    n += m
                    if m:
                        lines.append(f"{slot} {os.path.basename(path)}: "
                                     f"{m} ({why})")
                if want["stdout"] is not None:
                    m = check.compare_lines(got.stdout if got else None,
                                            want["stdout"])
                    n += m
                    if m:
                        lines.append(f"{slot} {cmd.argv[0]} stdout: {m} "
                                     f"lines differ")
            result[slot] = n
        if slots == ["first"]:             # one job: the first is the last
            result["last"] = result["first"]
        sizes = {p: len(keys) for p, (keys, _) in ref.dbs.items()}
        for d in self.done:
            self._fill_work(d, sizes)
        return result, lines

    def _fill_work(self, d: Done, sizes: dict):
        w = {"bases": 0, "reads": 0, "n_bases": 0, "entries": 0}
        spec = d.cmd.work
        if "bases" in spec:
            rs = self.inputs[spec["bases"]].reads
            w.update(bases=rs.bases, reads=rs.n_reads, n_bases=rs.n_n)
        if "entries" in spec:
            w["entries"] = sum(sizes[p] for p in spec["entries"])
        d.work = w

    def job_seconds(self) -> list[float]:
        out = [0.0] * self.jobs
        for d in self.done:
            out[d.job] += d.seconds
        return out

    def total_work(self, key: str) -> int:
        return sum(d.work[key] for d in self.done)


def free_device_memory():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
