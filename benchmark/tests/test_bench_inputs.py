"""The inputs a run writes (harness/inputs.py): plain files byte for byte
as they were before `compress` and `quality` existed, a `quality` model
that changes the quality lines alone, and a `"compress": "gzip"` input
as the plain file's bytes in one gzip stream that the program opens as
plain gzip, not BGZF."""

import gzip
import hashlib
import json
import os
import struct

import zlib

import pytest

from conftest import BENCH_DIR, TINY_GENOME
from harness import inputs
from harness.inputs import make_inputs
from meryl_tpu_torch.io.bgzf import is_bgzf
from meryl_tpu_torch.io.sequence import open_maybe_compressed

SEED = 2 ** 31 + 99
SPEC = {"reads.fq": {"kind": "reads", "prefix": "r"},
        "asm.fa": {"kind": "assembly"}}
# the count-gz mix's model
QUALITY = {"symbols": "F:,#", "start": [0.92, 0.05, 0.02, 0.01],
           "end": [0.80, 0.11, 0.06, 0.03]}
# sha256 of each plain file at TINY_GENOME and SEED, written by the
# harness before inputs could be compressed; they also pin numpy's
# generator streams, which every cell's inputs rest on
PLAIN_SHA256 = {
    "reads.fq": "3b1bd026bffd1737af84b3013084fb16"
                "ac8dcb53db62f5546c5927b1ab941175",
    "asm.fa": "eaa5ab5e9549d45aade656ee4c5918a0"
              "74e6fee5525e24b796113f6e178b9a48",
}


@pytest.fixture
def config():
    with open(os.path.join(BENCH_DIR, "configs",
                           "ecoli-k12-illumina-k21.json")) as f:
        cfg = json.load(f)
    cfg["genome"]["length_bp"] = TINY_GENOME
    return cfg


def binned(spec):
    return {n: dict(s, quality=QUALITY) if s["kind"] == "reads" else s
            for n, s in spec.items()}


def gz_spec(spec=SPEC):
    return {n: dict(s, compress="gzip") for n, s in spec.items()}


def fastq_lines(data):
    lines = data.split(b"\n")
    return lines[0::4], lines[1::4], lines[2::4], lines[3::4]


def read(path):
    with open(path, "rb") as f:
        return f.read()


def test_plain_inputs_as_before(config, tmp_path):
    got = make_inputs(config, SPEC, SEED, str(tmp_path))
    for name, i in got.items():
        assert i.path == str(tmp_path / name)
        data = read(i.path)
        assert i.file_bytes == len(data)
        assert hashlib.sha256(data).hexdigest() == PLAIN_SHA256[name]


@pytest.mark.parametrize("spec", [SPEC, binned(SPEC)],
                         ids=["constant", "binned"])
def test_gzip_inflates_to_the_plain_file(config, tmp_path, spec):
    (tmp_path / "p").mkdir()
    (tmp_path / "z").mkdir()
    plain = make_inputs(config, spec, SEED, str(tmp_path / "p"))
    gz = make_inputs(config, gz_spec(spec), SEED, str(tmp_path / "z"))
    assert sorted(os.listdir(tmp_path / "z")) == ["asm.fa.gz", "reads.fq.gz"]
    for name in spec:
        p, z = plain[name], gz[name]
        assert z.path == str(tmp_path / "z" / name) + ".gz"
        data = read(z.path)
        assert z.file_bytes == len(data) < p.file_bytes
        assert gzip.decompress(data) == read(p.path)
        assert (z.reads.codes == p.reads.codes).all()
        assert (z.reads.lens == p.reads.lens).all()


def test_quality_changes_the_quality_lines_alone(config, tmp_path):
    (tmp_path / "i").mkdir()
    (tmp_path / "b").mkdir()
    const = make_inputs(config, SPEC, SEED, str(tmp_path / "i"))
    bins = make_inputs(config, binned(SPEC), SEED, str(tmp_path / "b"))
    assert read(bins["asm.fa"].path) == read(const["asm.fa"].path)
    *same_c, qual_c = fastq_lines(read(const["reads.fq"].path))
    *same_b, qual_b = fastq_lines(read(bins["reads.fq"].path))
    assert same_b == same_c
    assert set(b"".join(qual_c)) == {ord("I")}
    q = b"".join(qual_b)
    assert len(q) == len(b"".join(qual_c)) and set(q) == set(b"F:,#")
    # mostly F, and fewer F at a read's end than at its start
    assert 0.8 < q.count(b"F") / len(q) < 0.92
    head = b"".join(r[:20] for r in qual_b if r)
    tail = b"".join(r[-20:] for r in qual_b if r)
    assert head.count(b"F") > tail.count(b"F")
    (tmp_path / "s").mkdir()
    other = make_inputs(config, binned(SPEC), SEED + 1, str(tmp_path / "s"))
    assert fastq_lines(read(other["reads.fq"].path))[3] != qual_b


def test_quality_on_fasta_raises(config, tmp_path):
    with pytest.raises(ValueError, match="quality"):
        make_inputs(config, {"asm.fa": {"kind": "assembly",
                                        "quality": QUALITY}},
                    SEED, str(tmp_path))


def test_gzip_blocks_join_into_one_stream(config, tmp_path, monkeypatch):
    monkeypatch.setattr(inputs, "BLOCK", 1 << 13)
    (tmp_path / "p").mkdir()
    (tmp_path / "z").mkdir()
    spec = binned({"reads.fq": SPEC["reads.fq"]})
    plain = make_inputs(config, spec, SEED, str(tmp_path / "p"))
    gz = make_inputs(config, gz_spec(spec), SEED, str(tmp_path / "z"))
    data = read(gz["reads.fq"].path)
    text = read(plain["reads.fq"].path)
    assert len(text) > 40 * inputs.BLOCK
    d = zlib.decompressobj(31)
    assert d.decompress(data) == text
    assert d.eof and d.unused_data == b""         # one member
    assert not is_bgzf(gz["reads.fq"].path)
    # primed blocks lose little against one pass, even 8 KiB ones (each
    # carries its own Huffman tables; at BLOCK the loss is under 0.1 %)
    one = zlib.compressobj(inputs.GZIP_LEVEL, zlib.DEFLATED, 31)
    single = len(one.compress(text) + one.flush())
    assert len(data) < 1.05 * single


def test_gzip_header_is_plain_gzip(config, tmp_path):
    got = make_inputs(config, gz_spec(), SEED, str(tmp_path))
    for i in got.values():
        head = read(i.path)[:10]
        magic, method, flags, mtime = struct.unpack_from("<2sBBI", head)
        assert magic == b"\x1f\x8b" and method == 8
        assert flags == 0          # no extra field (no BGZF BC), no name
        assert mtime == 0
        assert not is_bgzf(i.path)
        with open_maybe_compressed(i.path) as f:
            assert isinstance(f, gzip.GzipFile)


def test_gzip_same_seed_same_file(config, tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    ga = make_inputs(config, gz_spec(binned(SPEC)), SEED, str(a))
    gb = make_inputs(config, gz_spec(binned(SPEC)), SEED, str(b))
    for name in SPEC:
        assert read(ga[name].path) == read(gb[name].path)


@pytest.mark.parametrize("value", ["bgzf", "xz", "GZIP", True, ""])
def test_unknown_compress_raises(config, tmp_path, value):
    spec = {"reads.fq": {"kind": "reads", "compress": value}}
    with pytest.raises(ValueError, match="compress"):
        make_inputs(config, spec, SEED, str(tmp_path))
    assert os.listdir(tmp_path) == []
