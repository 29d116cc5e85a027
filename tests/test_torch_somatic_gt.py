"""create_somatic_gt_file of the port against the JAX package's, on the CPU.

A tumor and normal ground-truth pair made by
``synthetic_reports.write_somatic_gt_pair`` from a small SEC world's truth
(both hold its records; the tumor also planted SNVs at free positions and,
at truth SNV positions, another base or a deletion), through both CLIs with
and without ``--regions_bed``: the somatic ``.vcf.gz`` (inflated), its
``.tbi`` and the BEDs byte-equal; the planted records come back exactly, and
no planted problematic position is left in the comparison BED. Then the
problematic intervals alone, and a pair with nothing private.
"""

import gzip
from pathlib import Path

import numpy as np
import pytest

from variantcalling_tpu.io.vcf import read_vcf as jread_vcf
from variantcalling_tpu.pipelines import create_somatic_gt_file as jsom
from variantcalling_tpu_torch import synthetic, synthetic_reports
from variantcalling_tpu_torch.io.bed import read_bed
from variantcalling_tpu_torch.io.vcf import read_vcf
from variantcalling_tpu_torch.pipelines import create_somatic_gt_file as tsom

NAMES = ["--gt_tumor_name", "T1", "--gt_normal_name", "N1"]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("somatic_gt")
    w = synthetic.write_sec_world(str(d), seed=5, length=1_000_000, n_pool=800, n_samples=1, n_private=30,
                                  n_heldout=1_200)
    p = synthetic_reports.write_somatic_gt_pair(str(d / "pair"), seed=3, truth_vcf=w["truth"], fasta=w["fasta"],
                                                n_somatic=150, n_mismatch=60)
    return {**w, **p}


def _text(path: Path) -> bytes:
    data = path.read_bytes()
    return gzip.decompress(data) if path.suffix == ".gz" else data


@pytest.mark.parametrize("regions", [False, True])
def test_outputs_equal_the_reference(pair, tmp_path, regions):
    extra = ["--regions_bed", pair["exome"]] if regions else []
    for pkg, run in (("jax", jsom.run), ("torch", tsom.run)):
        assert run(["--gt_tumor", pair["tumor"], "--gt_normal", pair["normal"], *NAMES, "--cmp_intervals",
                    pair["hcr"], "--output_folder", str(tmp_path / pkg), *extra]) == 0
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == names
    assert len(names) == (4 if regions else 3)
    for name in names:
        assert _text(tmp_path / "torch" / name) == _text(tmp_path / "jax" / name), name
    gt = tmp_path / "torch" / "OUTPUT_gt_T1_minus_N1.vcf.gz"
    body = [ln for ln in _text(gt).decode().splitlines() if not ln.startswith("#")]
    assert body == pair["somatic"] and len(body) == pair["n_planted"] + 60
    bed = read_bed(str(tmp_path / "torch" / "hcr_no_problematic_positions.bed" if regions else
                       tmp_path / "torch" / "OUTPUT_hcr_no_problematic_positions.bed"))
    for chrom, start, end in pair["problematic"]:
        assert not bed.contains(np.array([chrom] * (end - start), dtype=object), np.arange(start, end)).any()


def test_problematic_intervals_equal_the_reference(pair):
    got = tsom.problematic_intervals(read_vcf(pair["tumor"]), read_vcf(pair["normal"]))
    want = jsom.problematic_intervals(jread_vcf(pair["tumor"]), jread_vcf(pair["normal"]))
    assert got.chrom.tolist() == want.chrom.tolist() and len(got) == 60
    assert np.array_equal(got.start, want.start) and np.array_equal(got.end, want.end)
    assert sorted((s, e) for _, s, e in pair["problematic"]) == list(zip(got.start.tolist(), got.end.tolist()))


def test_a_pair_with_nothing_private(pair, tmp_path):
    for pkg, run in (("jax", jsom.run), ("torch", tsom.run)):
        assert run(["--gt_tumor", pair["normal"], "--gt_normal", pair["normal"], *NAMES, "--cmp_intervals",
                    pair["hcr"], "--output_folder", str(tmp_path / pkg)]) == 0
    for name in ("OUTPUT_gt_T1_minus_N1.vcf.gz", "OUTPUT_hcr_no_problematic_positions.bed"):
        assert _text(tmp_path / "torch" / name) == _text(tmp_path / "jax" / name)
    assert not [ln for ln in _text(tmp_path / "torch" / "OUTPUT_gt_T1_minus_N1.vcf.gz").decode().splitlines()
                if not ln.startswith("#")]
    assert (tmp_path / "torch" / "OUTPUT_hcr_no_problematic_positions.bed").read_bytes() == \
        b"".join(f"{c}\t{s}\t{e}\n".encode() for c, s, e in zip(*(lambda b: (b.chrom, b.start, b.end))(
            read_bed(pair["hcr"]).merged())))
