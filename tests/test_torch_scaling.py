"""The port's analytic multi-GPU scaling model (parallel/scaling.py)
and the table `-C` prints from it.  Its stage costs are the H100's own
built-ins or the environment's, never the TPU's BENCH_r*.json; its
links are the published NVLink / InfiniBand figures."""

import glob
import os

import numpy as np
import pytest

from meryl_tpu.parallel import scaling as ref_scaling
from meryl_tpu_torch import cli
from meryl_tpu_torch.parallel import scaling as sc
from meryl_tpu_torch.parallel.shard_count import plan_shard_route

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"devices", "hosts", "t_local_ms", "t_ici_ms", "t_dcn_ms",
        "t_merge_ms", "efficiency", "bases_per_s"}


@pytest.fixture(autouse=True)
def no_overrides(monkeypatch):
    for key in ("MERYL_TPU_T_LOCAL_NS", "MERYL_TPU_T_MERGE_NS",
                "MERYL_TPU_ICI_GB_S", "MERYL_TPU_DCN_GB_S",
                "MERYL_TPU_SHARD_CHUNK"):
        monkeypatch.delenv(key, raising=False)


@pytest.mark.parametrize("chunk", [1 << 16, 1 << 22])
@pytest.mark.parametrize("k", [21, 33])
def test_single_device_is_unity(chunk, k):
    r = sc.predict_scaling(chunk, 1, k=k)
    assert r["efficiency"] == 1.0
    assert r["t_ici_ms"] == 0.0 and r["t_dcn_ms"] == 0.0
    cal = sc.calibration()
    want = chunk / ((chunk * cal["t_local_ns"] + plan_shard_route(
        chunk, k, 1)["B"] * plan_shard_route(chunk, k, 1)["Wc"]
        * cal["t_merge_ns"]) * 1e-9)
    assert abs(r["bases_per_s"] - want) <= 0.1 + 1e-9 * want


def test_report_shape():
    """The reference's table (8, 64, 256 devices) in the port's units:
    nodes of 8 GPUs, NVLink inside a node, InfiniBand across."""
    rows = sc.scaling_report(1 << 22)
    assert [r["devices"] for r in rows] == \
        [r["devices"] for r in ref_scaling.scaling_report(1 << 22)]
    assert [r["devices"] for r in rows] == [8, 64, 256]
    assert [r["hosts"] for r in rows] == [1, 8, 32]
    for r in rows:
        assert set(r) == KEYS
        assert 0 < r["efficiency"] <= 1
    # one node: NVLink only; past it, InfiniBand carries most of the wire
    assert rows[0]["t_dcn_ms"] == 0.0 and rows[0]["t_ici_ms"] > 0
    assert rows[1]["t_dcn_ms"] > rows[1]["t_ici_ms"]
    assert rows[1]["efficiency"] < rows[0]["efficiency"]


def test_wire_volume_follows_the_geometry():
    """t_ici of one node is the routing grid's int64 slots leaving a GPU
    over the NVLink rate; two key words at k > 32 double it."""
    for k, words in ((21, 1), (33, 2)):
        g = plan_shard_route(1 << 22, k, 8)
        want = g["B"] * g["Wc"] * 8 * words * 7 / 8 / 450e9 * 1e3
        got = sc.predict_scaling(1 << 22, 8, k=k)["t_ici_ms"]
        assert abs(got - want) <= 1e-3


def test_env_over_builtin(monkeypatch):
    base = sc.predict_scaling(1 << 22, 64)
    monkeypatch.setenv("MERYL_TPU_T_LOCAL_NS", "9.0")
    monkeypatch.setenv("MERYL_TPU_T_MERGE_NS", "2.5")
    monkeypatch.setenv("MERYL_TPU_ICI_GB_S", "900")
    monkeypatch.setenv("MERYL_TPU_DCN_GB_S", "25")
    cal = sc.calibration()
    assert (cal["t_local_ns"], cal["t_merge_ns"]) == (9.0, 2.5)
    assert cal["t_local_src"] == cal["t_merge_src"] == "env"
    r = sc.predict_scaling(1 << 22, 64)
    assert abs(r["t_local_ms"] - (1 << 22) * 9e-6) < 1e-3
    assert abs(r["t_dcn_ms"] - 2 * base["t_dcn_ms"]) < 2e-3
    assert abs(r["t_ici_ms"] - base["t_ici_ms"] / 2) < 2e-3


def test_builtins_are_the_h100_run_not_bench_json(monkeypatch, tmp_path):
    """The TPU's calibration files are not read: with BENCH_r*.json at
    the repo root (and MERYL_TPU_BENCH_JSON naming another) the stage
    costs stay the built-in H100 measurements."""
    assert glob.glob(os.path.join(REPO, "BENCH_r*.json"))
    p = tmp_path / "BENCH_r99.json"
    p.write_text('{"t_local_ns_per_base": 5.5, "t_merge_ns_per_elt": 2.25}')
    monkeypatch.setenv("MERYL_TPU_BENCH_JSON", str(p))
    monkeypatch.chdir(tmp_path)
    cal = sc.calibration()
    assert cal["t_local_ns"] == sc._BUILTIN_T_LOCAL_NS
    assert cal["t_merge_ns"] == sc._BUILTIN_T_MERGE_NS
    assert cal["t_local_src"].startswith("built-in (H100")
    assert (cal["ici_gb_s"], cal["dcn_gb_s"]) == (450.0, 50.0)
    with open(sc.__file__) as f:
        assert "BENCH_r" not in f.read().replace(
            "(BENCH_r*.json) are not read", "")


def test_cli_configure_prints_the_table(tmp_path, capsys, monkeypatch):
    fa = tmp_path / "r.fa"
    rng = np.random.default_rng(0)
    fa.write_text(">r\n" + "".join(
        "ACTG"[c] for c in rng.integers(0, 4, 500)) + "\n")
    monkeypatch.setenv("MERYL_TPU_T_LOCAL_NS", "1.5")
    out = str(tmp_path / "o.meryl")
    assert cli.main(["-C", "count", "k=21", str(fa), "output", out,
                     "device=cpu"]) == 0
    err = capsys.readouterr().err
    assert not os.path.exists(out)
    assert "predicted scaling (H100" in err and "published" in err
    assert "t_local 1.5 ns/base from env" in err
    assert "t_merge" in err and "from built-in (H100" in err
    rows = [ln for ln in err.splitlines() if "devices (" in ln]
    assert [int(ln.split()[0]) for ln in rows] == [8, 64, 256]
    for ln, r in zip(rows, sc.scaling_report(1 << 22)):
        assert f"eff {r['efficiency']:.2f}" in ln
        assert f"nvlink {r['t_ici_ms']}ms" in ln and \
            f"ib {r['t_dcn_ms']}ms" in ln
