"""The control of the benchmark's correctness check: the reference put in
the program's place with one guarantee broken, which the check has to
find.

  python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
      [--device cuda]

The guarantee broken is meryl's: a k-mer lies inside one sequence.  The
control counts (and looks up) the reads as one stream, so the windows
across the join of two reads count too, which is what a fault in the
wire's read boundaries (its exception list) would do.  Each control
command writes its outputs where the program's would go (databases in
the program's format, lookup text, printed reports); then the run's own
check compares them with the reference.  For each seed it prints the
numbers compared, as the benchmark's runs print them.  The benchmark's
own runs never run it.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)

from harness import registry, runner  # noqa: E402
from reference import dbfile  # noqa: E402
from reference.meryl import Reference  # noqa: E402


class ControlRunner(runner.Runner):
    """A Runner whose commands are the control's, not the program's."""

    _ctrl = None

    def call(self, cmd, capture):
        if self._ctrl is None:
            self._ctrl = Reference(
                self.k, self.device,
                {i.path: i.reads for i in self.inputs.values()},
                boundaries=False)
        res = self._ctrl.run(cmd.command, cmd.argv)
        for path, (keys, counts) in res["db"].items():
            shutil.rmtree(path, ignore_errors=True)
            dbfile.write(path, self.k, keys, counts)
        for path, text in res["text"].items():
            with open(path, "w") as f:
                f.write(text)
        return 0, (res["stdout"] or "") if capture else None


def control_run(cell, seed: int, device: str, workdir: str) -> dict:
    """One seed: set-up and one job by the control, then the check."""
    r = ControlRunner(cell, seed, 0.0, False, device, workdir)
    r.setup()
    r.window()
    mism, detail = r.check()
    return {"seed": seed, "mismatch": mism, "detail": detail}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = registry.find_cell(registry.load_benchmark(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        work = tempfile.mkdtemp(prefix="meryl-control-")
        try:
            res = control_run(cell, seed, args.device, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({"workload": cell.name, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
