"""The DB writer's native pass (csrc/db_write.cpp) against its numpy
fallback and against meryl_tpu's db module: every file of every DB equal
byte for byte, histogram.tsv and merylIndex.json included."""

import os

import numpy as np
import pytest

from meryl_tpu import db as ref_db
from meryl_tpu_torch import cli, db
from meryl_tpu_torch import kmer as km

PATHS = ["native", "numpy"]


def _use(monkeypatch, path):
    if path == "numpy":
        monkeypatch.setenv("MERYL_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("MERYL_TPU_NO_NATIVE", raising=False)
        assert db._native_writer() is not None


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def _sorted_keys(rng, n, k, repeat=False):
    """-> (hi, lo) of n sorted keys of k bases (distinct unless repeat)."""
    bits = 2 * k
    lo = rng.integers(0, 1 << min(bits, 64), size=n, dtype=np.uint64)
    hi = rng.integers(0, 1 << (bits - 64), size=n, dtype=np.uint64) \
        if bits > 64 else np.zeros(n, np.uint64)
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    if not repeat:
        keep = np.ones(len(lo), bool)
        keep[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
        hi, lo = hi[keep], lo[keep]
    return hi, lo


def _write_all(tmp_path, monkeypatch, k, hi, lo, counts, **kw):
    """MerylDB.write through both paths and the reference -> their files,
    after checking that each path counted its DB."""
    out = {}
    for path in PATHS:
        _use(monkeypatch, path)
        before = dict(db.WRITE_STATS)
        db.MerylDB.write(str(tmp_path / path), k, hi, lo, counts, **kw)
        assert db.WRITE_STATS[path] == before[path] + 1
        assert sum(db.WRITE_STATS.values()) == sum(before.values()) + 1
        out[path] = _files(str(tmp_path / path))
    ref_db.MerylDB.write(str(tmp_path / "ref"), k, hi, lo, counts, **kw)
    out["ref"] = _files(str(tmp_path / "ref"))
    assert len(out["ref"]) == 66
    return out


def _assert_equal(out):
    assert out["native"] == out["ref"]
    assert out["numpy"] == out["ref"]


@pytest.mark.parametrize("k", [1, 2, 16, 21, 32, 33, 35, 64])
def test_every_k(tmp_path, monkeypatch, k):
    """Bounds by binary search split the keys as prefix6 does at every k:
    k <= 2, 2k <= 64, 64 < 2k < 70 and shift >= 64."""
    rng = np.random.default_rng(k)
    hi, lo = _sorted_keys(rng, 20000, k)
    counts = rng.integers(1, 100, size=len(lo)).astype(np.uint32)
    out = _write_all(tmp_path, monkeypatch, k, hi, lo, counts,
                     mode="forward")
    _assert_equal(out)
    if k >= 16:       # keys in most of the 64 buckets
        assert sum(len(v) > 24 for n, v in out["native"].items()
                   if n.endswith(".kmb")) > 48


@pytest.mark.parametrize("case", ["empty", "gaps", "one-bucket", "last-only"])
def test_empty_and_single_buckets(tmp_path, monkeypatch, case):
    rng = np.random.default_rng(len(case))
    hi, lo = _sorted_keys(rng, 5000, 21)
    pref = km.prefix6_from_hilo(hi, lo, 21)
    keep = {"empty": pref > 64, "gaps": (pref % 5 == 0) | (pref == 63),
            "one-bucket": pref == 17, "last-only": pref == 63}[case]
    hi, lo = hi[keep], lo[keep]
    counts = rng.integers(1, 9, size=len(lo)).astype(np.uint32)
    out = _write_all(tmp_path, monkeypatch, 21, hi, lo, counts)
    _assert_equal(out)
    full = sum(len(v) > 24 for n, v in out["native"].items()
               if n.endswith(".kmb"))
    assert full == {"empty": 0, "gaps": 14, "one-bucket": 1,
                    "last-only": 1}[case]


@pytest.mark.parametrize("k", [21, 33])
def test_multiset_repeated_keys(tmp_path, monkeypatch, k):
    rng = np.random.default_rng(k + 1)
    hi, lo = _sorted_keys(rng, 3000, k)
    reps = rng.integers(1, 4, size=len(lo))
    hi, lo = np.repeat(hi, reps), np.repeat(lo, reps)
    counts = rng.integers(1, 5, size=len(lo)).astype(np.uint32)
    out = _write_all(tmp_path, monkeypatch, k, hi, lo, counts,
                     multiset=True)
    _assert_equal(out)
    with open(tmp_path / "native" / "histogram.tsv") as f:
        assert sum(int(line.split()[1]) for line in f) == len(lo)


@pytest.mark.parametrize("dtype", ["uint32", "uint64", "int64", "int32"])
def test_counts_at_the_edges(tmp_path, monkeypatch, dtype):
    """Counts at 1, around the native histogram's dense table, at 2^32 - 1,
    and (8-byte counts) past 2^32, narrowed to u32 as numpy casts them."""
    _use(monkeypatch, "native")
    dense = db._native_writer().mt_db_dense()
    rng = np.random.default_rng(7)
    hi, lo = _sorted_keys(rng, 6000, 21)
    pick = np.array([1, 2, dense - 1, dense, dense + 1, 3 * dense,
                     (1 << 31) - 1, (1 << 32) - 1], np.int64)
    if dtype in ("uint64", "int64"):
        pick = np.concatenate([pick, [1 << 32, (1 << 32) + 1,
                                      (1 << 40) + dense]])
    if dtype == "int32":
        pick = pick[pick < (1 << 31)]
    counts = pick[rng.integers(0, len(pick), size=len(lo))].astype(dtype)
    out = _write_all(tmp_path, monkeypatch, 21, hi, lo, counts)
    _assert_equal(out)
    got = db.MerylDB.open(str(tmp_path / "native"))
    narrowed = counts.astype(np.uint32)
    vals, occ = np.unique(narrowed, return_counts=True)
    hv, ho = got.histogram()
    np.testing.assert_array_equal(hv, vals)
    np.testing.assert_array_equal(ho, occ)
    assert got.stats() == db.compute_stats(narrowed)


def test_strided_inputs(tmp_path, monkeypatch):
    """Views with strides are written as their values."""
    rng = np.random.default_rng(11)
    hi, lo = _sorted_keys(rng, 8000, 21)
    counts = rng.integers(1, 40, size=2 * len(lo)).astype(np.int64)
    out = _write_all(tmp_path, monkeypatch, 21, np.repeat(hi, 2)[::2],
                     np.repeat(lo, 2)[::2], counts[::2])
    _assert_equal(out)


def test_caller_histogram(tmp_path, monkeypatch):
    """histogram= replaces the pass's histogram in histogram.tsv; the
    statistics still come from the counts."""
    rng = np.random.default_rng(3)
    hi, lo = _sorted_keys(rng, 4000, 21)
    counts = rng.integers(1, 9, size=len(lo)).astype(np.uint32)
    given = (np.array([1, 5, 70], np.uint64), np.array([9, 8, 7], np.uint64))
    out = _write_all(tmp_path, monkeypatch, 21, hi, lo, counts,
                     histogram=given)
    _assert_equal(out)
    assert out["native"]["histogram.tsv"] == b"1\t9\n5\t8\n70\t7\n"


@pytest.mark.parametrize("bits", [0, 5, 8, 16, 32, 64])
def test_label_widths(tmp_path, monkeypatch, bits):
    rng = np.random.default_rng(bits)
    hi, lo = _sorted_keys(rng, 5000, 21)
    counts = rng.integers(1, 30, size=len(lo)).astype(np.uint32)
    labels = rng.integers(0, 1 << 63, size=len(lo), dtype=np.uint64) | \
        np.uint64(1 << 63)
    out = _write_all(tmp_path, monkeypatch, 21, hi, lo, counts,
                     labels=labels, label_bits=bits)
    _assert_equal(out)
    got = db.MerylDB.open(str(tmp_path / "native"))
    _, _, _, lab = got.load_bucket_labels(20)
    if bits == 0:
        assert lab is None
    else:
        assert lab is not None and len(lab) > 0
        assert (lab <= int(db.label_mask(bits))).all()


def test_threaded_branch(tmp_path, monkeypatch):
    """A DB past THREADED_MIN, written from every CPU the process may use,
    with counts past the dense table in many buckets."""
    rng = np.random.default_rng(2)
    n = max(3_000_000, db.THREADED_MIN)
    gaps = rng.integers(1, 2 * ((1 << 42) // n), size=n, dtype=np.uint64)
    lo = np.cumsum(gaps, dtype=np.uint64)
    hi = np.zeros(n, np.uint64)
    counts = rng.integers(1, 60, size=n).astype(np.uint32)
    counts[::1001] = rng.integers(1 << 14, 1 << 32, size=len(counts[::1001]),
                                  dtype=np.uint64).astype(np.uint32)
    out = _write_all(tmp_path, monkeypatch, 21, hi, lo, counts)
    _assert_equal(out)


def test_threads_past_the_cores(tmp_path, monkeypatch):
    """64 threads claim the 64 buckets (more threads than cores), over
    and over: every DB the same as the one-thread one."""
    rng = np.random.default_rng(4)
    hi, lo = _sorted_keys(rng, 200_000, 21)
    counts = rng.integers(1, 1 << 15, size=len(lo)).astype(np.uint32)
    _use(monkeypatch, "native")
    db.MerylDB.write(str(tmp_path / "one"), 21, hi, lo, counts)
    want = _files(str(tmp_path / "one"))
    monkeypatch.setattr(db, "THREADED_MIN", 0)
    monkeypatch.setattr(db.os, "sched_getaffinity", lambda pid: range(100))
    for rep in range(10):
        db.MerylDB.write(str(tmp_path / f"many{rep}"), 21, hi, lo, counts)
        assert _files(str(tmp_path / f"many{rep}")) == want


@pytest.mark.parametrize("path", PATHS)
def test_unwritable_output_raises(tmp_path, monkeypatch, path):
    """A DB under a regular file, and a bucket file that cannot be opened
    (a directory in its place), raise OSError naming the path; the index
    is not written."""
    _use(monkeypatch, path)
    rng = np.random.default_rng(5)
    hi, lo = _sorted_keys(rng, 3000, 21)
    counts = np.ones(len(lo), np.uint32)
    (tmp_path / "file").write_bytes(b"x")
    with pytest.raises(OSError):
        db.MerylDB.write(str(tmp_path / "file" / "db"), 21, hi, lo, counts)
    out = tmp_path / "db"
    (out / db.bucket_name(9)).mkdir(parents=True)
    with pytest.raises(OSError) as e:
        db.MerylDB.write(str(out), 21, hi, lo, counts)
    assert e.value.filename == str(out / db.bucket_name(9))
    assert not db.is_meryl_db(str(out))
    w = db.MerylDBWriter(str(out), 21)
    with pytest.raises(OSError) as e:
        w.add_bucket(9, hi[:5], lo[:5], counts[:5])
    assert e.value.filename == str(out / db.bucket_name(9))


@pytest.mark.parametrize("path", PATHS)
def test_add_bucket_refuses_a_bucket_past_the_64(tmp_path, monkeypatch, path):
    _use(monkeypatch, path)
    w = db.MerylDBWriter(str(tmp_path / "db"), 21)
    z = np.zeros(2, np.uint64)
    for ff in (-1, 64):
        with pytest.raises(ValueError):
            w.add_bucket(ff, z, z, np.ones(2, np.uint32))
    assert os.listdir(tmp_path / "db") == []


def test_native_refuses_unequal_lengths(tmp_path, monkeypatch):
    _use(monkeypatch, "native")
    z = np.zeros(4, np.uint64)
    with pytest.raises(ValueError):
        db.MerylDB.write(str(tmp_path / "db"), 21, z, z, np.ones(3, np.uint32))
    with pytest.raises(ValueError):
        db.MerylDB.write(str(tmp_path / "db"), 21, z, z, np.ones(4, np.uint32),
                         labels=np.zeros(5, np.uint64), label_bits=8)


def _fastq(path, rng, n, ln):
    with open(path, "w") as f:
        for i in range(n):
            s = "".join(rng.choice(list("ACGT"), size=ln))
            if i % 7 == 0:
                s = s[:40] + "N" + s[41:]
            f.write(f"@r{i}\n{s}\n+\n{'I' * ln}\n")


def test_cli_count_same_db_both_paths(tmp_path, monkeypatch):
    """A CPU `meryl count` writes the same DB through either path, and
    counts one DB written by the path it took."""
    rng = np.random.default_rng(8)
    fq = str(tmp_path / "r.fq")
    _fastq(fq, rng, 400, 150)
    out = {}
    for path in PATHS:
        _use(monkeypatch, path)
        before = dict(db.WRITE_STATS)
        dbp = str(tmp_path / f"{path}.meryl")
        assert cli.main(["count", "k=21", fq, "output", dbp,
                         "device=cpu"]) == 0
        assert db.WRITE_STATS[path] == before[path] + 1
        assert sum(db.WRITE_STATS.values()) == sum(before.values()) + 1
        out[path] = _files(dbp)
    assert len(out["native"]) == 66 and out["native"] == out["numpy"]
