"""Pileup fingerprinting of the port against the JAX package's, on the CPU.

The fingerprinting world (``synthetic_reports.write_fingerprint_world`` cut
to a 20 kbp region: samples A and B as their truths, C holding another
individual's reads, D a mix; each as a BAM and a CRAM of
``tests/cram_fixtures``) through ``quick_fingerprinting`` and
``training_set_consistency_check`` of both packages: the same results and
hit files, the same printed lines, the same errors in the same order, and
the errors the world planted. Then the parts: the pileup counts of the
engine's BAM walk, its plain version (``VCTPU_NO_NATIVE=1``), the CRAM
decoder and the JAX package's walk, equal; ``call_snvs`` with loci planted
exactly at the float32 gate and with ties for the major alt;
``snp_set_from_vcf`` and ``read_vcf(region=)``; the native entry points'
counts.
"""

import contextlib
import io
import json

import numpy as np
import pytest

from tests import cram_fixtures
from tests.fixtures import write_bam, write_fasta
from variantcalling_tpu.comparison import pileup_caller as jpile
from variantcalling_tpu.io.vcf import read_vcf as jread_vcf
from variantcalling_tpu.pipelines import quick_fingerprinting as jqf
from variantcalling_tpu.pipelines import training_set_consistency_check as jtscc
from variantcalling_tpu_torch import native, synthetic_reports
from variantcalling_tpu_torch.comparison import pileup_caller as tpile
from variantcalling_tpu_torch.io.vcf import read_vcf
from variantcalling_tpu_torch.pipelines import quick_fingerprinting as tqf
from variantcalling_tpu_torch.pipelines import training_set_consistency_check as ttscc

REGION = (100_000, 120_000)


def _cram_writer(path, header, records):
    cram_fixtures.write_cram(path, header, records, method=cram_fixtures.GZIP)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("fingerprint")
    w = synthetic_reports.write_fingerprint_world(str(d), seed=3, length=300_000, region=REGION, snv_every=200,
                                                  cram_writer=_cram_writer)
    w["confs"] = synthetic_reports.fingerprint_confs(w, str(d))
    return w


def _quick(run, world, out, extra):
    try:
        rc = run(["--json_conf", world["confs"]["qf"], "--region_str", world["region_str"], "--out_dir", str(out),
                  *extra])
        return rc, None
    except RuntimeError as e:
        return None, str(e)


def test_quick_fingerprinting_against_jax(world, tmp_path):
    _, got = _quick(tqf.run, world, tmp_path / "t", ["--backend", "cpu"])
    _, want = _quick(jqf.run, world, tmp_path / "j", [])
    assert got == want
    lines = got.strip().split("\n")
    assert [(f, ln.startswith(start)) for (f, start), ln in zip(world["confs"]["qf_errors"], lines)] == \
        [(f, True) for f, _ in world["confs"]["qf_errors"]]
    assert len(lines) == len(world["confs"]["qf_errors"])
    for path in sorted((tmp_path / "j").iterdir()):
        assert (tmp_path / "t" / path.name).read_text() == path.read_text(), path.name
    assert len(list((tmp_path / "t").iterdir())) == 1 + 8 * 3


def test_quick_fingerprinting_of_matching_samples_passes(world, tmp_path):
    conf = json.loads(open(world["confs"]["qf"]).read())
    conf["cram_files"] = {s: conf["cram_files"][s] for s in ("A", "B")}
    path = tmp_path / "ok.json"
    path.write_text(json.dumps(conf))
    for run, extra in ((tqf.run, ["--backend", "cpu"]), (jqf.run, [])):
        assert run(["--json_conf", str(path), "--region_str", world["region_str"], "--out_dir",
                    str(tmp_path / run.__module__), *extra]) == 0


def _tscc(run, conf, world, out, extra):
    buf = io.StringIO()
    err = None
    with contextlib.redirect_stdout(buf):
        try:
            run(["--training_json_conf", conf, "--region_str", world["region_str"], "--out_dir", str(out), *extra])
        except RuntimeError as e:
            err = str(e)
    return buf.getvalue(), err


def test_training_set_consistency_check_against_jax(world, tmp_path):
    got = _tscc(ttscc.run, world["confs"]["tscc"], world, tmp_path / "t", ["--backend", "cpu"])
    want = _tscc(jtscc.run, world["confs"]["tscc"], world, tmp_path / "j", [])
    assert got == want
    errors = got[1].split("\n")
    assert len(errors) == len(world["confs"]["tscc_errors"])
    assert all(e.startswith(start) for e, (_, start) in zip(errors, world["confs"]["tscc_errors"]))
    assert "suspected normal-in-tumor sample matches" in got[0] and got[0].count("subset ") == 2


@pytest.mark.parametrize("variant", ["no_background", "mismatched_background"])
def test_training_set_conf_variants_against_jax(world, tmp_path, variant):
    conf = json.loads(open(world["confs"]["tscc"]).read())
    conf["fingerprint.background_cram_files"] = [] if variant == "no_background" else [[world["bam"]["C"]]]
    path = str(tmp_path / "conf.json")
    with open(path, "w") as fh:
        json.dump(conf, fh)
    assert _tscc(ttscc.run, path, world, tmp_path / "t", ["--backend", "cpu"]) == \
        _tscc(jtscc.run, path, world, tmp_path / "j", [])


@pytest.mark.parametrize("sample", ["A", "D"])
@pytest.mark.parametrize("window", [REGION, (0, 300_000), (119_990, 120_500)])
def test_pileup_counts_every_route(world, monkeypatch, sample, window):
    """The engine's BAM walk, its plain version, the CRAM decoder and the JAX package's walk."""
    chrom = "chr20"
    native.reset_calls()
    got = tpile.pileup_counts(world["bam"][sample], chrom, *window)
    assert native.CALLS["bam_pileup"]["native"] == 1
    cram = tpile.pileup_counts(world["cram"][sample], chrom, *window, ref_path=world["fasta"])
    assert native.CALLS["cram_pileup"]["native"] == 1
    want = jpile.pileup_counts(world["bam"][sample], chrom, *window)
    monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    plain = tpile.pileup_counts(world["bam"][sample], chrom, *window)
    assert native.CALLS["bam_pileup"]["plain"] == 1
    assert got.dtype == np.int32 and got.shape == (window[1] - window[0], 4)
    assert np.array_equal(got, want) and np.array_equal(plain, want) and np.array_equal(cram, want)
    assert np.array_equal(cram, jpile.pileup_counts(world["cram"][sample], chrom, *window, ref_path=world["fasta"]))


def test_pileup_of_hand_made_reads_and_the_depth_cap(tmp_path, monkeypatch):
    """The JAX package's unit shapes (a duplicate, a deletion, an insertion, a
    soft clip, an N base, another contig), and 600 reads over the 500 cap."""
    reads = [
        {"contig": "chr1", "pos": 0, "cigar": [("M", 10)], "seq": "AAAAAGAAAA"},
        {"contig": "chr1", "pos": 3, "cigar": [("M", 10)], "seq": "AACAANAAAA"},
        {"contig": "chr1", "pos": 0, "cigar": [("M", 10)], "seq": "AAAAAAAAAA", "flag": 0x400},
        {"contig": "chr1", "pos": 10, "cigar": [("M", 5), ("D", 3), ("M", 5)], "seq": "AAAAACCCCC"},
        {"contig": "chr1", "pos": 30, "cigar": [("S", 2), ("M", 3), ("I", 2), ("M", 3)], "seq": "GGTTTAACCC"},
        {"contig": "chr2", "pos": 0, "cigar": [("M", 10)], "seq": "TTTTTTTTTT"},
    ] + [{"contig": "chr1", "pos": 50, "cigar": [("M", 4)], "seq": "ACGT"}] * 600
    bam = str(tmp_path / "t.bam")
    write_bam(bam, {"chr1": 200, "chr2": 50}, reads)
    for window in ((0, 200), (5, 40), (52, 60)):
        want = jpile.pileup_counts(bam, "chr1", *window)
        assert np.array_equal(tpile.pileup_counts(bam, "chr1", *window), want)
        monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
        assert np.array_equal(tpile.pileup_counts(bam, "chr1", *window), want)
        monkeypatch.delenv("VCTPU_NO_NATIVE")
    assert tpile.pileup_counts(bam, "chr1", 50, 54).max() == tpile.MAX_DEPTH
    assert np.array_equal(tpile.pileup_counts(bam, "chrX", 0, 10), np.zeros((10, 4), np.int32))


def test_call_snvs_at_the_gate_and_at_ties():
    """Loci exactly at float32(min_af) (called), one count below (not), ties for
    the major alt (the first base), zero depth, N reference; random counts."""
    rng = np.random.default_rng(5)
    rows, refs = [], []
    for depth in (33, 100, 300, 2000):
        for alt in range(0, depth // 5):
            counts = np.array([depth - alt, alt, 0, 0])
            rows.append(counts)
            refs.append(0)
    rows += [[10, 5, 5, 0], [0, 7, 7, 7], [0, 0, 0, 0], [3, 3, 3, 3], [5, 0, 5, 0]]
    refs += [0, 0, 0, 4, 2]
    counts = np.concatenate([np.array(rows, np.int32), rng.integers(0, 60, (5000, 4)).astype(np.int32)])
    refs = np.concatenate([np.array(refs, np.int8), rng.integers(0, 5, 5000).astype(np.int8)])
    for min_af in (0.03, 0.1, 0.2, 1 / 3, 0.5):
        got = tpile.call_snvs(counts, refs, min_af)
        want = jpile.call_snvs(counts, refs, min_af)
        assert all(np.array_equal(g, w) and g.dtype == np.asarray(w).dtype for g, w in zip(got, want)), min_af
    at_gate = [i for i, (c, r) in enumerate(zip(counts[:200], refs[:200]))
               if c.sum() and np.float32(c[1]) / np.float32(c.sum()) == np.float32(0.03)]
    assert at_gate and set(at_gate) <= set(tpile.call_snvs(counts, refs, 0.03)[0].tolist())


def test_snp_sets_and_region_reads(world):
    from variantcalling_tpu.io.bed import read_bed as jread_bed
    from variantcalling_tpu_torch.io.bed import read_bed

    chrom, lo, hi = "chr20", REGION[0] + 1, REGION[1]
    for ind, path in world["truth"].items():
        for region in ((chrom, lo, hi), (chrom, lo + 5_000, lo + 9_000), ("chr1", 1, 10), None):
            t, j = read_vcf(path, region=region), jread_vcf(path, region=region)
            assert t.pos.tolist() == j.pos.tolist() and t.alt.tolist() == j.alt.tolist()
            for hcr in (None, world["hcr"]):
                got = tpile.snp_set_from_vcf(path, region, None if hcr is None else read_bed(hcr))
                assert got == jpile.snp_set_from_vcf(path, region, None if hcr is None else jread_bed(hcr))
        assert len(tpile.snp_set_from_vcf(path, (chrom, lo, hi))) == len(world["truth_snvs"][ind])


def test_hit_fraction_and_caller_against_jax(world, tmp_path):
    write_fasta(str(tmp_path / "ref.fa"), {"chr1": "ACGT" * 50})
    called = {("chr1", 10, "A", "G"), ("chr1", 20, "C", "T"), ("chr1", 30, "G", "A")}
    truth = {("chr1", 10, "A", "G"), ("chr1", 20, "C", "T"), ("chr1", 99, "T", "C")}
    assert tpile.VariantHitFractionCaller.calc_hit_fraction(called, truth) == \
        jpile.VariantHitFractionCaller.calc_hit_fraction(called, truth)
    t = tpile.VariantHitFractionCaller(world["fasta"], str(tmp_path), 0.03, world["region_str"])
    j = jpile.VariantHitFractionCaller(world["fasta"], str(tmp_path), 0.03, world["region_str"])
    for f in (world["bam"]["D"], world["cram"]["B"]):
        assert t.call_variants(f, "chr20", *REGION, 0.1) == j.call_variants(f, "chr20", *REGION, 0.1)
