"""``coverage_analysis`` of the port against the JAX package's CLI, on the CPU.

Both subcommands through ``run(argv)`` with ``--backend cpu``, on BAMs of
mixed reads: the parquet files read by ``pd.read_parquet`` equal to the
reference's (dtypes and index), the ``.coverage_stats.h5`` frames read by
the JAX package's ``read_hdf`` (``histogram`` and ``percentiles`` equal,
``stats`` to 1e-6 relative, the same columns and dtypes), the bedGraph on
its inflated bytes and the ``.bw`` byte for byte. ``-c``, ``-w``, ``-r``,
``-q/-Q/-l``, the contig length rule with four contigs, the ``.bw`` output
names, CRAM input, the plain reader; bad arguments and ``--backend gpu``
without a card (exit 2).
"""

import gzip
import os

import numpy as np
import pandas as pd
import pytest

from tests import torch_worlds
from tests.cram_fixtures import GZIP, write_cram
from variantcalling_tpu.pipelines import coverage_analysis as jca
from variantcalling_tpu.utils.h5_utils import read_hdf as jread
from variantcalling_tpu_torch import native
from variantcalling_tpu_torch.pipelines import coverage_analysis as tca
from variantcalling_tpu_torch.utils import degrade


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("cov_cli")
    bam = torch_worlds.write_alignment_world(str(d / "reads.bam"), seed=21, contigs={"chr1": 6000, "chr2": 3000,
                                                                                     "chrM": 500}, n_reads=1500)
    (d / "exome.bed").write_text("chr1\t100\t400\nchr1\t2000\t2300\nchr2\t50\t900\nchr9\t1\t10\n")
    (d / "spike.bed").write_text("chrM\t0\t500\n")
    (d / "cats.tsv").write_text(f"exome\t{d / 'exome.bed'}\nspike\t{d / 'spike.bed'}\n\nnone\t{d / 'spike.bed'}\n")
    return d, bam


def _full(d, bam, extra, tmp_path):
    argv = ["full_analysis", "-i", bam, *extra]
    assert tca.run([*argv, "-o", str(tmp_path / "p" / "out"), "--backend", "cpu"]) == 0
    assert jca.run([*argv, "-o", str(tmp_path / "r" / "out")]) == 0
    return tmp_path / "p" / "out", tmp_path / "r" / "out"


def _assert_full_equal(port, ref, windows):
    for w in windows:
        got, want = pd.read_parquet(f"{port}.w{w}.parquet"), pd.read_parquet(f"{ref}.w{w}.parquet")
        pd.testing.assert_frame_equal(got, want)
    h5p, h5r = f"{port}.coverage_stats.h5", f"{ref}.coverage_stats.h5"
    for key in ("histogram", "percentiles"):
        pd.testing.assert_frame_equal(jread(h5p, key), jread(h5r, key))
    got, want = jread(h5p, "stats"), jread(h5r, "stats")
    assert list(got.columns) == list(want.columns) and list(got.dtypes) == list(want.dtypes)
    assert got["stat"].tolist() == want["stat"].tolist()
    np.testing.assert_allclose(got.iloc[:, 1:].to_numpy(), want.iloc[:, 1:].to_numpy(), rtol=1e-6, atol=0)
    assert not os.path.exists(f"{port}.coverage_boxplot.png")


@pytest.mark.parametrize("extra,windows", [
    ([], jca.DEFAULT_WINDOWS),
    (["-c", "CATS"], jca.DEFAULT_WINDOWS),
    (["-w", "50", "333", "-c", "CATS"], [50, 333]),
    (["-q", "20", "-Q", "20", "-l", "40"], jca.DEFAULT_WINDOWS),
    (["-r", "chr2", "chrM", "-w", "100"], [100]),
], ids=["default", "categories", "windows", "filters", "regions"])
def test_full_analysis_equals_the_reference(world, extra, windows, tmp_path):
    d, bam = world
    extra = [str(d / "cats.tsv") if a == "CATS" else a for a in extra]
    degrade.clear_for_tests()
    port, ref = _full(d, bam, extra, tmp_path)
    _assert_full_equal(port, ref, windows)
    hist = jread(f"{port}.coverage_stats.h5", "histogram")
    assert list(hist.columns) == (["Genome", "exome", "spike", "none"] if "-c" in extra else ["Genome"])
    assert degrade.events_for("coverage_analysis.plots")


def test_full_analysis_on_cram_equals_the_bam(tmp_path):
    rng = np.random.default_rng(3)
    quals = [rng.integers(2, 41, 40).tolist() for _ in range(200)]
    pos = np.sort(rng.integers(1, 900, 200))
    cram = [{"flag": 0, "pos": int(p), "read_len": 40, "mapq": 60, "quals": q,
             "features": [("D", 11, 2)] if i % 4 == 0 else []} for i, (p, q) in enumerate(zip(pos, quals))]
    bam = [{"contig": "chr1", "pos": int(p) - 1, "cigar": [("M", 10), ("D", 2), ("M", 30)] if i % 4 == 0
            else [("M", 40)], "quals": q} for i, (p, q) in enumerate(zip(pos, quals))]
    write_cram(str(tmp_path / "x.cram"), "@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:1000\n", cram, method=GZIP)
    from tests import fixtures

    fixtures.write_bam(str(tmp_path / "x.bam"), {"chr1": 1000}, bam)
    for src in ("cram", "bam"):
        assert tca.run(["full_analysis", "-i", str(tmp_path / f"x.{src}"), "-o", str(tmp_path / src), "-q", "20",
                        "--backend", "cpu"]) == 0
    _assert_full_equal(tmp_path / "cram", tmp_path / "bam", jca.DEFAULT_WINDOWS)


def test_plain_reader_gives_the_same_files(world, tmp_path, monkeypatch):
    d, bam = world
    port, _ = _full(d, bam, ["-c", str(d / "cats.tsv")], tmp_path)
    monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    assert tca.run(["full_analysis", "-i", bam, "-c", str(d / "cats.tsv"), "-o", str(tmp_path / "plain"),
                    "--backend", "cpu"]) == 0
    _assert_full_equal(tmp_path / "plain", port, jca.DEFAULT_WINDOWS)


@pytest.mark.parametrize("n_long", [0, 1, 2])
def test_length_rule_with_four_contigs(tmp_path, n_long):
    """Four contigs: only those of at least 1 Mbp are kept (none kept: the
    reference's SystemExit)."""
    contigs = {"chrA": 1_000_000 if n_long > 0 else 999_999, "chrB": 2000, "chrC": 1_200_000 if n_long > 1 else 3000,
               "chrD": 500}
    bam = torch_worlds.write_alignment_world(str(tmp_path / "four.bam"), seed=n_long, contigs=contigs, n_reads=400)
    argv = ["full_analysis", "-i", bam, "-w", "100000"]
    if n_long == 0:
        with pytest.raises(SystemExit):
            tca.run([*argv, "-o", str(tmp_path / "p"), "--backend", "cpu"])
        with pytest.raises(SystemExit):
            jca.run([*argv, "-o", str(tmp_path / "r")])
        return
    port, ref = _full(tmp_path, bam, ["-w", "100000"], tmp_path)
    _assert_full_equal(port, ref, [100000])
    kept = pd.read_parquet(f"{port}.w100000.parquet")["chrom"].unique().tolist()
    assert kept == [c for c in contigs if contigs[c] >= 1_000_000]


@pytest.mark.parametrize("name", ["cov", "cov.bedgraph", "cov.bedgraph.gz", "cov.bg", "cov.bg.gz", "cov.bw",
                                  "cov.bigwig", "cov.bigWig"])
@pytest.mark.parametrize("extra", [[], ["-q", "25", "-r", "chr1"]], ids=["default", "q25_region"])
def test_collect_coverage_equals_the_reference(world, name, extra, tmp_path):
    d, bam = world
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    assert tca.run(["collect_coverage", "-i", bam, "-o", str(tmp_path / "p" / name), *extra, "--backend", "cpu"]) == 0
    assert jca.run(["collect_coverage", "-i", bam, "-o", str(tmp_path / "r" / name), *extra]) == 0
    got, want = sorted(os.listdir(tmp_path / "p")), sorted(os.listdir(tmp_path / "r"))
    assert got == want
    for f in want:
        a, b = (tmp_path / "p" / f).read_bytes(), (tmp_path / "r" / f).read_bytes()
        if f.endswith(".gz"):
            a, b = gzip.decompress(a), gzip.decompress(b)
        assert a == b, f
    if not name.endswith(("bw", "bigwig", "bigWig")):
        assert len(want) == 2


def test_bedgraph_text_of_large_and_negative_values():
    starts = np.array([0, 5, 10**9], np.int64)
    ends = np.array([5, 10**9, 10**9 + 3], np.int64)
    vals = np.array([0, -7, 2**31 - 1], np.int64)
    want = "".join(f"c\t{s}\t{e}\t{v}\n" for s, e, v in zip(starts, ends, vals)).encode()
    assert tca.bedgraph_text("c", starts, ends, vals) == want
    assert tca.bedgraph_text("c", starts[:0], ends[:0], vals[:0]) == b""
    if native.available():
        assert native.bedgraph_lines("c", starts, ends, vals) == want
        assert native.bedgraph_lines("c", starts[:0], ends[:0], vals[:0]) == b""


def test_bigwig_runs_merge_where_float32_merges():
    """Depths of 2^24 and more: runs whose values round to one float32 are
    one bigWig run, as the reference's float32 run-length finds them."""
    from variantcalling_tpu.io.bigwig import _runlength

    depth = np.array([0, 2**24, 2**24 + 1, 2**24 + 1, 5, 2**24 + 2, 2**24 + 3, 7], np.int64)
    change = np.flatnonzero(np.diff(depth)) + 1
    starts = np.concatenate([[0], change])
    runs = tca._bigwig_runs(starts, np.append(starts[1:], len(depth)), depth[starts])
    want = _runlength(depth)
    assert all(np.array_equal(a, b) for a, b in zip(runs, want)) and runs[2].dtype == np.float32


def test_bedgraph_lines_native_equal_plain():
    """The engine's formatter against its plain version on a million runs."""
    if not native.available():
        pytest.skip("needs the native host engine (g++)")
    rng = np.random.default_rng(2)
    starts = np.sort(rng.choice(250_000_000, 1_000_000, replace=False)).astype(np.int64)
    ends = np.append(starts[1:], 250_000_001)
    vals = rng.integers(0, 5000, len(starts))
    assert native.bedgraph_lines("chr1_alt", starts, ends, vals) == tca.bedgraph_text("chr1_alt", starts, ends, vals)


def test_collect_coverage_plain_engine_gives_the_same_bytes(world, tmp_path, monkeypatch):
    d, bam = world
    assert tca.run(["collect_coverage", "-i", bam, "-o", str(tmp_path / "a.bedgraph.gz"), "--backend", "cpu"]) == 0
    monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    assert tca.run(["collect_coverage", "-i", bam, "-o", str(tmp_path / "b.bedgraph.gz"), "--backend", "cpu"]) == 0
    assert gzip.decompress((tmp_path / "a.bedgraph.gz").read_bytes()) == \
        gzip.decompress((tmp_path / "b.bedgraph.gz").read_bytes())
    assert (tmp_path / "a.bw").read_bytes() == (tmp_path / "b.bw").read_bytes()


@pytest.mark.parametrize("argv", [[], ["nope"], ["full_analysis"], ["collect_coverage", "-i", "x.bam"],
                                  ["full_analysis", "-i", "x", "-o", "y", "--backend", "tpu"]],
                         ids=["empty", "unknown", "no_input", "no_output", "bad_backend"])
def test_bad_arguments(argv):
    if not argv or argv[0] not in ("full_analysis", "collect_coverage"):
        assert tca.run(argv) == 2
        return
    with pytest.raises(SystemExit) as e:
        tca.run(argv)
    assert e.value.code == 2


def test_backend_gpu_without_a_card_exits_2(world, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, bam = world
    for sub in ("full_analysis", "collect_coverage"):
        assert tca.run([sub, "-i", bam, "-o", str(tmp_path / "x")]) == 2
    assert not list(tmp_path.iterdir())


def test_world_bam_bytes_do_not_depend_on_the_writer_threads(tmp_path, monkeypatch):
    """The coverage world's BAM record chunks built on a thread pool are
    written in order: the bytes of one thread."""
    from variantcalling_tpu_torch import synthetic

    monkeypatch.setattr(synthetic, "_COVERAGE_CHUNK", 64 * len(synthetic.COVERAGE_SHAPE_CYCLE))
    reads = synthetic.coverage_reads(3, [("chr20", 200_000)], 30.0, ())
    assert len(reads["pos"]) > 10 * synthetic._COVERAGE_CHUNK
    out = {}
    for threads in (1, 4):
        monkeypatch.setattr(synthetic, "_COVERAGE_WRITERS", threads)
        path = tmp_path / f"t{threads}.bam"
        out[threads] = (synthetic.write_coverage_bam(str(path), reads), path.read_bytes())
    assert out[1] == out[4]
