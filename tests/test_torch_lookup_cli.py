"""meryl-lookup and position-lookup through both CLIs
(meryl_tpu_torch.lookup_cli / tools.position_lookup with -device cpu,
against meryl_tpu's) on the same FASTA/FASTQ and DBs: every mode and
option, output bytes equal."""

import contextlib
import io
import os

import numpy as np
import pytest

from meryl_tpu import lookup_cli as ref_cli
from meryl_tpu import oracle
from meryl_tpu.db import MerylDB
from meryl_tpu.tools import position_lookup as ref_pl
from meryl_tpu_torch import lookup_cli
from meryl_tpu_torch.tools import position_lookup

A = "ACTG"


def _seq(rng, n):
    return "".join(A[c] for c in rng.integers(0, 4, n))


@pytest.fixture(scope="module", params=[16, 21, 33])
def data(request, tmp_path_factory):
    """Two DBs of one k (a canonical, b with a share of a's k-mers and
    counts past 2^31), a forward-mode DB, an assembly past BULK_MIN
    positions with N runs, a palindrome-rich contig and a short one, and
    paired FASTQ reads of mixed lengths."""
    k = request.param
    d = tmp_path_factory.mktemp(f"lk{k}")
    rng = np.random.default_rng(k)
    g = _seq(rng, 12000)
    g2 = g[:6000] + _seq(rng, 6000)
    for name, s, mode in (("a", g, "canonical"), ("b", g2, "canonical"),
                          ("f", g, "forward")):
        hi, lo, c = oracle.count_kmers([s], k, mode=mode)
        c = c.astype(np.uint32)
        c[::7] += 3
        if name == "b":
            c[::11] = np.uint32(0xFFFFFFF0)
        MerylDB.write(str(d / f"{name}.meryl"), k, hi, lo, c, mode=mode)
    pal = "ACGT" * 30 + "AATT" * 20
    asm = g[1000:9000] + "NNNN" + _seq(rng, 60000) + g[:2000]
    with open(d / "asm.fa", "w") as f:
        f.write(f">c1\n{asm}\n>c2 desc\n{_seq(rng, 500)}{pal}\n"
                f">c3\n{g[50:50 + k + 3]}\n")
    with open(d / "r1.fq", "w") as f1, open(d / "r2.fq", "w") as f2:
        for i in range(300):
            p = int(rng.integers(0, 11000))
            s1 = g[p:p + 120] if i % 2 else _seq(rng, 120)
            # the reference raises on a read shorter than k - 2 at the end
            # of a batch (test_short_last_read_counts_nothing)
            s2 = _seq(rng, int(rng.integers(0, 90)) if i < 299 else 60)
            if i % 5 == 0:
                s1 = s1[:40] + "N" + s1[41:]
            f1.write(f"@r{i}\n{s1}\n+\n{'I' * len(s1)}\n")
            f2.write(f"@r{i}/2\n{s2}\n+\n{'#' * len(s2)}\n")
    return dict(k=k, d=d)


def _both(argv, outs, device_word=("-device", "cpu")):
    """Run both CLIs with `argv` (output names substituted per run) ->
    list of (rc, {name: bytes}, stderr) for reference and port."""
    res = []
    for tag, main, extra in (("ref", ref_cli.main, []),
                             ("port", lookup_cli.main, list(device_word))):
        paths = {o: f"{o}.{tag}" for o in outs}
        args = [paths.get(a, a) for a in argv] + extra
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            try:
                rc = main(args)
            except SystemExit as e:
                rc = ("exit", e.code)
        files = {}
        for o, p in paths.items():
            with open(p, "rb") as f:
                files[o] = f.read()
        res.append((rc, files, err.getvalue()))
    return res


MODES = [
    ("bed", ["-bed"], ["a"]),
    ("bed-runs", ["-bed-runs"], ["a"]),
    ("wig-count", ["-wig-count"], ["a"]),
    ("wig-count forward", ["-wig-count"], ["f"]),
    ("wig-depth", ["-wig-depth"], ["a"]),
    ("existence", ["-existence"], ["a", "b"]),
    ("bed forward", ["-bed"], ["f"]),
    ("bed two dbs", ["-bed"], ["a", "b"]),
    ("bed labels", ["-bed", "-labels", "A", "B"], ["a", "b"]),
    ("bed-runs labels", ["-bed-runs", "-labels", "A", "B"], ["a", "b"]),
    ("bed one label", ["-bed", "-labels", "A"], ["a"]),
    ("bed min max", ["-bed", "-min", "2", "-max", "20"], ["b"]),
    ("wig-count two dbs", ["-wig-count"], ["a", "b"]),
]


@pytest.mark.parametrize("name,words,dbs", MODES, ids=[m[0] for m in MODES])
def test_dump_modes_match_reference(data, name, words, dbs):
    d = data["d"]
    out = str(d / "out")
    argv = [words[0], "-sequence", str(d / "asm.fa"), "-output", out,
            "-mers", *[str(d / f"{x}.meryl") for x in dbs], *words[1:]]
    (rc0, f0, _), (rc1, f1, _) = _both(argv, [out])
    assert rc0 == rc1 == 0
    assert f0[out] == f1[out] and len(f0[out]) > 0


@pytest.mark.parametrize("mode", ["-include", "-exclude"])
@pytest.mark.parametrize("extra", [[], ["-10x"], ["-min", "2"]])
def test_filter_modes_match_reference(data, mode, extra):
    d = data["d"]
    o1, o2 = str(d / "o1"), str(d / "o2")
    argv = [mode, "-sequence", str(d / "r1.fq"), str(d / "r2.fq"),
            "-output", o1, o2, "-mers", str(d / "b.meryl"), *extra]
    (rc0, f0, e0), (rc1, f1, e1) = _both(argv, [o1, o2])
    assert rc0 == rc1 == 0
    assert f0[o1] == f1[o1] and f0[o2] == f1[o2] and e0 == e1
    assert "Including" in e1


def test_existence_of_reads_matches_reference(data):
    d = data["d"]
    out = str(d / "ex")
    argv = ["-existence", "-sequence", str(d / "r1.fq"), "-output", out,
            "-mers", str(d / "a.meryl"), str(d / "b.meryl")]
    (rc0, f0, _), (rc1, f1, _) = _both(argv, [out])
    assert rc0 == rc1 == 0 and f0[out] == f1[out]


def test_estimate_and_memory_match_reference(data):
    """-estimate exits 0 after the estimate (the port reports its own
    layout's bytes); -memory below the tables' need exits with the
    reference's message shape."""
    d = data["d"]
    dbs = [str(d / "a.meryl"), str(d / "b.meryl")]
    for tag, main, extra in (("ref", ref_cli.main, []),
                             ("port", lookup_cli.main, ["-device", "cpu"])):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as e:
            main(["-bed", "-sequence", str(d / "asm.fa"), "-mers", *dbs,
                  "-estimate", *extra])
        assert e.value.code == 0
        assert err.getvalue().startswith("Estimated memory usage: ")
        assert err.getvalue().endswith(" GB for 2 database(s)\n")
        with pytest.raises(SystemExit) as e:
            main(["-bed", "-sequence", str(d / "asm.fa"), "-mers", *dbs,
                  "-memory", "0.000001", *extra])
        assert "meryl-lookup: tables need" in str(e.value.code)


def test_bulk_regimes_give_the_same_bytes(data, monkeypatch):
    """The assembly's positions through both bulk regimes (the binary
    search on a device-resident table, the grid join on a table that
    MERYL_TPU_LOOKUP_DEVICE_GB keeps on the host) give one output."""
    from meryl_tpu_torch import lookup
    from meryl_tpu_torch.lookup import ExactLookup

    d = data["d"]
    outs = []
    for env, attrs, stat in (
            ({}, {}, "bsearch_calls"),
            ({"MERYL_TPU_LOOKUP_DEVICE_GB": "1e-6"},
             dict(JOIN_MIN_Q=1, BACJ_SLAB=1 << 14), "bacj_slabs")):
        with monkeypatch.context() as m:
            for a, v in env.items():
                m.setenv(a, v)
            for a, v in attrs.items():
                m.setattr(ExactLookup, a, v)
            out = str(d / "regime.txt")
            lookup.reset_stats()
            assert lookup_cli.main(["-wig-count", "-sequence",
                                    str(d / "asm.fa"), "-mers",
                                    str(d / "b.meryl"), "-output", out,
                                    "-device", "cpu"]) == 0
            assert lookup.STATS[stat] > 0, lookup.STATS
            with open(out, "rb") as f:
                outs.append(f.read())
    assert outs[0] == outs[1] and outs[0]


def test_position_lookup_matches_reference(data):
    d = data["d"]
    got = []
    for tag, main, extra in (("ref", ref_pl.main, []),
                             ("port", position_lookup.main,
                              ["-device", "cpu"])):
        names = {x: str(d / f"pl_{tag}.{x}") for x in ("hpq", "mpb", "qpb")}
        assert main(["-m", str(d / "a.meryl"), "-s", str(d / "asm.fa"),
                     "-hpq", names["hpq"], "-mpb", names["mpb"],
                     "-qpb", names["qpb"], *extra, str(d / "r1.fq"),
                     str(d / "r2.fq")]) == 0
        files = {}
        for x, p in names.items():
            with open(p, "rb") as f:
                files[x] = f.read()
        got.append(files)
    assert got[0] == got[1]
    assert all(got[1].values())


def test_short_last_read_counts_nothing(tmp_path, data):
    """A read shorter than k - 2 at the end of a batch: the reference
    indexes past its prefix sums and raises; the port counts it 0."""
    d, k = data["d"], data["k"]
    fq = str(tmp_path / "short.fq")
    with open(fq, "w") as f:
        f.write("@x\nACGTACGTACGTACGTACGTACGTACGTACGTACGTAC\n+\n"
                + "I" * 38 + "\n@y\nAC\n+\nII\n")
    argv = ["-include", "-sequence", fq, "-mers", str(d / "a.meryl")]
    with pytest.raises(IndexError):
        ref_cli.main(argv + ["-output", str(tmp_path / "r.fq")])
    out = str(tmp_path / "p.fq")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert lookup_cli.main(argv + ["-output", out, "-device", "cpu"]) == 0
    assert "out of 2." in err.getvalue()
    ex = str(tmp_path / "e.txt")
    assert lookup_cli.main(["-existence", "-sequence", fq, "-mers",
                            str(d / "a.meryl"), "-output", ex,
                            "-device", "cpu"]) == 0
    with open(ex) as f:
        lines = f.read().splitlines()
    assert lines[1].split("\t")[:2] == ["y", "0"]
    assert lines[0].split("\t")[1] == str(38 - k + 1)


def test_cuda_default_without_cuda_fails_clearly(data, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = data["d"]
    assert lookup_cli.main(["-bed", "-sequence", str(d / "asm.fa"),
                            "-mers", str(d / "a.meryl")]) == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
    assert position_lookup.main(["-m", str(d / "a.meryl"), "-s",
                                 str(d / "asm.fa")]) == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
    assert not os.path.exists(str(d / "never"))
