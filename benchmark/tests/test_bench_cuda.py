"""On the card (marker cuda; each test looks for one itself):
`python -m pytest -m cuda benchmark/tests -q`."""

import io

import pytest
import torch

from conftest import tiny
from harness import devtrace, registry

pytestmark = pytest.mark.cuda


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def test_trace_sees_the_device():
    need_card()
    x = torch.randn(1 << 22, device="cuda")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(devtrace.WINDOW_SPAN):
            for _ in range(20):
                x = torch.sort(x).values
            torch.cuda.synchronize()
    t = devtrace.reduce(prof)
    assert 0 < t.busy_s <= t.window_s
    assert t.ops and t.breakdown()["device_ops"]


@pytest.mark.parametrize("name", ["ecoli-k12-illumina-k21.count",
                                  "ecoli-k12-illumina-k21.merqury"])
def test_small_run_on_the_card(bench, name, tmp_path):
    need_card()
    import run as bench_run
    cell = tiny(registry.find_cell(bench, name))
    res = bench_run.run_cell(cell, 7, 1.0, True, "cuda", str(tmp_path),
                             io.StringIO())
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
