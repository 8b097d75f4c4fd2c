"""meryl_tpu_torch's sharded counting against meryl_tpu's, owner by owner.

The reference's ShardedCounter runs in this process on a mesh of 1, 2
or 4 of the suite's virtual CPU devices (conftest.py); the port's runs
as 1, 2 or 4 gloo ranks (tests/torch_dist.py), every scenario of
tests/torch_shard_cases.py in one spawn a rank count.  Each owner's
finalized (hi, lo, counts) must be equal, bit for bit; so must the
spills and steps of every rank, and the captured windows and recounted
chunks summed over the ranks (each rank counts its own source's)."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from meryl_tpu import oracle
from meryl_tpu.ops import accum as ref_accum
from meryl_tpu.parallel import shard_count as ref_sc
from meryl_tpu_torch.ops import accum
from meryl_tpu_torch.ops import multiword as mw
from meryl_tpu_torch.parallel import shard_count as sc
from tests import torch_dist
from tests import torch_shard_cases as cases

NS = (1, 2, 4)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """{n: out_dir} of the port's ranks, each n spawned once."""
    runs = {}

    def get(n):
        if n not in runs:
            out = tmp_path_factory.mktemp(f"port_n{n}")
            torch_dist.run_ranks(n, cases.rank_scenarios,
                                 (str(out), list(cases.SCENARIOS)), out)
            runs[n] = str(out)
        return runs[n]
    return get


def _port(out_dir, name, n):
    ranks = []
    for r in range(n):
        with open(os.path.join(out_dir, f"{name}_r{r}.json")) as f:
            res = json.load(f)
        z = np.load(os.path.join(out_dir, f"{name}_r{r}.npz"))
        res["parts"] = [(row, z[f"hi{i}"], z[f"lo{i}"], z[f"c{i}"])
                        for i, row in enumerate(res.get("rows", []))]
        ranks.append(res)
    return ranks


def _reference(name, n, tmp_path):
    k, mode, chunk, _, acc_cap, spill, _, _ = cases.SCENARIOS[name]
    mesh = Mesh(np.array(jax.devices()[:n]), ("d",))
    spill_dir = str(tmp_path / "ref_spills") if spill else None
    try:
        c = ref_sc.ShardedCounter(mesh, k, chunk_len=chunk, mode=mode,
                                  acc_cap=acc_cap, spill_dir=spill_dir)
        for codes in cases.step_codes(name, n):
            c.add_codes(codes)
        return c.finalize_parts(), dict(c.stats), None
    except RuntimeError as e:
        return None, None, str(e)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", list(cases.SCENARIOS))
def test_sharded_counter_matches_reference(port_runs, tmp_path, name, n):
    assert_matches_reference(_port(port_runs(n), name, n), name, n,
                             tmp_path)


def assert_matches_reference(ranks, name, n, tmp_path):
    """The port's n ranks' results of a scenario (_port) against the
    reference's mesh of n devices: every owner's parts bit for bit, the
    spills and steps of every rank, the captures and recounts summed,
    and a second finalize refused on every rank."""
    parts, stats, err = _reference(name, n, tmp_path)
    if err is not None:
        # every rank raises alike (lockstep), as the reference does
        assert "overflow" in err
        assert all(r["error"] and "overflow" in r["error"] for r in ranks)
        return
    assert all(r["error"] is None for r in ranks), [r["error"] for r in ranks]
    want = {int(d): (hi, lo, c) for d, hi, lo, c in parts}
    for rank, res in enumerate(ranks):
        got = {int(d): (hi, lo, c) for d, hi, lo, c in res["parts"]}
        assert set(got) <= {rank}
        if rank not in want:
            assert not got or not len(got[rank][2])
            continue
        for g, w in zip(got[rank], want[rank]):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert got[rank][2].dtype == np.uint32
    for key in ("spills", "steps"):
        assert [r["stats"][key] for r in ranks] == [stats[key]] * n, key
    for key in ("captured_windows", "recount_chunks"):
        assert sum(r["stats"][key] for r in ranks) == stats[key], key
    # the finalize contract: a second call raises, on every rank
    for r in ranks:
        assert len(r["again"]) == 2
        assert all("already finalized" in e for e in r["again"])


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name,stat", [
    ("capture", "captured_windows"), ("bad_source", "recount_chunks"),
    ("spill", "spills"), ("spill_dir", "spills"),
    ("k21_three_steps", "steps")])
def test_scenario_walks_its_hatch(port_runs, name, stat, n):
    """Each hatch scenario really takes its hatch at every rank count,
    and its sum matches the oracle (the parity test holds the rest)."""
    ranks = _port(port_runs(n), name, n)
    assert sum(r["stats"][stat] for r in ranks) > 0
    if name == "bad_source":
        assert all(r["masked_steps"] == 1 for r in ranks)
    if name == "spill_dir":
        assert all(r["spill_files"] for r in ranks if r["parts"])
    k, mode, chunk, *_ = cases.SCENARIOS[name]
    seqs = []
    for codes in cases.step_codes(name, n):
        for s in range(n):
            seg = codes[s * chunk:(s + 1) * chunk]
            seqs.append("".join("ACTG"[c] if c < 4 else "N" for c in seg))
    ohi, olo, oc = oracle.count_kmers(seqs, k, mode)
    parts = sorted(p for r in ranks for p in r["parts"])
    lo = np.concatenate([p[2] for p in parts])
    c = np.concatenate([p[3] for p in parts])
    np.testing.assert_array_equal(lo, olo)
    np.testing.assert_array_equal(c, oc)


PLAN_GRID = [(chunk, k, n) for chunk in (192, 256, 1024, 1 << 16, 1 << 22)
             for k in (4, 13, 21, 33) for n in (1, 2, 3, 4, 8)]


@pytest.mark.parametrize("chunk,k,n", PLAN_GRID)
def test_plan_shard_route_matches_reference(chunk, k, n):
    assert sc.plan_shard_route(chunk, k, n) == \
        ref_sc.plan_shard_route(chunk, k, n)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [15, 16, 21, 31, 32, 33, 64])
def test_owner_of_keys_matches_reference_and_device_map(k, n):
    """The port's host owner map equals the reference's, and equals the
    row the port's route assigns on the device (accum._top_bits +
    row_from_prefix_int), for canonical and linear maps."""
    rng = np.random.default_rng(k * 10 + n)
    m = 3000
    twok = 2 * k
    lo = rng.integers(0, 1 << 63, size=m, dtype=np.uint64) * 2 + \
        rng.integers(0, 2, size=m, dtype=np.uint64)
    if twok < 64:
        lo &= np.uint64((1 << twok) - 1)
    hi = np.zeros(m, np.uint64) if twok <= 64 else \
        rng.integers(0, 1 << (twok - 64), size=m, dtype=np.uint64)
    lo[:2] = [0, (1 << min(64, twok)) - 1]
    hi[:2] = [0, (1 << max(0, twok - 64)) - 1]
    g = sc.plan_shard_route(1 << 12, k, n)
    for canonical in (True, False):
        got = sc.owner_of_keys(hi, lo, k, g["bits"], g["B"], g["rpo"],
                               canonical)
        want = ref_sc.owner_of_keys(hi, lo, k, g["bits"], g["B"],
                                    g["rpo"], canonical)
        np.testing.assert_array_equal(got, want)
        key = torch.from_numpy(mw.from_hilo(hi, lo, k))
        row = accum.row_from_prefix_int(accum._top_bits(key, k, g["bits"]),
                                        g["bits"], g["B"], canonical)
        np.testing.assert_array_equal(got, (row // g["rpo"]).numpy())
        assert got.min() >= 0 and got.max() < n


def test_row_map_matches_reference_on_every_prefix():
    """The integer row map under owner_of_keys, on every 16-bit prefix,
    against the reference's numpy map."""
    pref = np.arange(1 << 16, dtype=np.uint32)
    for B in (1, 2, 24, 96, 1024):
        for canon in (True, False):
            got = accum.row_from_prefix_int(
                torch.from_numpy(pref.astype(np.int64)), 16, B, canon)
            want = ref_accum.row_from_prefix_int(pref, 16, B, canon, xp=np)
            np.testing.assert_array_equal(got.numpy(), want)


def test_exchange_layout_at_one_rank(tmp_path):
    """At one rank the exchange is the identity on the cell grid, and
    mask_sources sets exactly a bad source's column block."""
    import torch.distributed as dist
    with sc.one_rank_group("cpu"):
        group = sc.DistGroup("cpu")
        cells = torch.arange(8 * 6, dtype=torch.int64).reshape(8, 6)
        assert torch.equal(sc.exchange_cells(cells, group), cells)
        wide = torch.arange(4 * 6 * 2, dtype=torch.int64).reshape(4, 6, 2)
        assert torch.equal(sc.exchange_cells(wide, group), wide)
    assert not dist.is_initialized()
    staged = torch.zeros((3, 3 * 4), dtype=torch.int64)
    out = sc.mask_sources(staged, np.array([False, True, False]), 4, 21)
    sent = mw.sentinel_words(21)[0]
    assert (out[:, 4:8] == sent).all() and (out[:, :4] == 0).all() \
        and (out[:, 8:] == 0).all()


def test_counter_refuses_wrong_backend_and_no_group():
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="process group"):
        sc.ShardedCounter(21, chunk_len=256, device="cpu")
    with sc.one_rank_group("cpu"):
        assert dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="multiple of 16"):
            sc.ShardedCounter(21, chunk_len=250, device="cpu")
        with pytest.raises(RuntimeError, match="is_available"):
            # no CUDA here: device=cuda fails, it never runs on gloo
            sc.ShardedCounter(21, chunk_len=256, device="cuda")


def test_default_acc_cap_from_the_device_budget(monkeypatch):
    """The default entry budget comes from the rank's device budget and
    the port's bytes a slot, not the reference's uint32-plane formula."""
    from meryl_tpu_torch import counter
    monkeypatch.setenv("MERYL_TPU_ACC_CAP_GB", "1")
    with sc.one_rank_group("cpu"):
        c = sc.ShardedCounter(21, chunk_len=1024, device="cpu")
        staged = c.MERGE_EVERY * c.B * c.Wc
        assert c.acc_cap == (10 ** 9 // counter.acc_bytes_per_unique(21)
                             - staged) // 2
        monkeypatch.setenv("MERYL_TPU_SHARD_ACC_CAP", "777")
        assert sc.ShardedCounter(21, chunk_len=1024,
                                 device="cpu").acc_cap == 777
