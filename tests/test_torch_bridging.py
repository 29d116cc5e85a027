"""``calibrate_bridging_snvs`` of the port against the JAX package's, on the CPU.

The same VCF and FASTA through both tools: the output bytes equal (a rescued
record's QUAL rendered as the reference renders a changed QUAL, the rest
verbatim where the reference keeps it), on the cases of
``tests/unit/test_flow_and_misc_tools.py:104-128`` (a rescue, a tandem
repeat, a high normal VAF, a PASS record untouched) and on a seeded world
with planted rescues; ``bridging_hmer_lengths`` against the reference's on
random windows, run edges included.
"""

import gzip

import numpy as np
import pytest
import torch

from tests.fixtures import write_fasta
from tests.unit.test_flow_and_misc_tools import TestBridgingSnvs
from variantcalling_tpu.pipelines import calibrate_bridging_snvs as jbridge
from variantcalling_tpu_torch import synthetic_featuremap as sfm
from variantcalling_tpu_torch.io.vcf import read_vcf
from variantcalling_tpu_torch.pipelines import calibrate_bridging_snvs as tbridge

CPU = ["--backend", "cpu"]
FMT = "GT:AD:DP:BG_AD:BG_DP"
RESCUE = "A" * 16 + "GGGG" + "C" + "GGGG" + "A" * 75
TANDEM = "A" * 15 + "C" + "GG" + "C" + "GG" + "C" + "A" * 79

CASES = {
    "rescue": (RESCUE, [f"chr1\t21\t.\tC\tG\t10\tLowQual\t.\t{FMT}\t0/1:10,10:20:15,0:15"], "PASS"),
    "tandem": (TANDEM, [f"chr1\t19\t.\tC\tG\t10\tLowQual\t.\t{FMT}\t0/1:10,10:20:15,0:15"], "LowQual"),
    "high_normal_vaf": (RESCUE, [f"chr1\t21\t.\tC\tG\t10\tLowQual\t.\t{FMT}\t0/1:10,10:20:10,5:15"], "LowQual"),
    "pass_untouched": (RESCUE, [f"chr1\t21\t.\tC\tG\t50\tPASS\t.\t{FMT}\t0/1:10,10:20:15,0:15"], "PASS"),
    "gatk_qual_and_more": (RESCUE, [
        f"chr1\t3\t.\tA\tG\t12.50\tLowQual\t.\t{FMT}\t0/1:10,10:20:15,0:15",
        f"chr1\t21\t.\tC\tG\t9.25\tLowQual;Other\t.\t{FMT}\t0/1:10,10:20:15,0:15",
        f"chr1\t22\t.\tG\tGA\t10\tLowQual\t.\t{FMT}\t0/1:10,10:20:15,0:15",
        f"chr1\t23\t.\tG\tA,T\t10\tLowQual\t.\t{FMT}\t0/1:10,10:20:15,0:15",
        f"chr1\t99\t.\tA\tG\t.\tLowQual\t.\t{FMT}\t0/1:10,10:20:15,0:15",
        f"chr1\t100\t.\tA\tG\t30\tLowQual\t.\t{FMT}\t0/1:.:.:.:."], None),
}


def _run_both(tmp_path, seq, rows, extra=()):
    write_fasta(str(tmp_path / "ref.fa"), {"chr1": seq})
    (tmp_path / "in.vcf").write_text(TestBridgingSnvs.HEADER + "\n".join(rows) + "\n")
    argv = ["--vcf", str(tmp_path / "in.vcf"), "--reference", str(tmp_path / "ref.fa"), *extra]
    assert tbridge.run([*argv, "--output", str(tmp_path / "t.vcf"), *CPU]) == 0
    assert jbridge.run([*argv, "--output", str(tmp_path / "j.vcf")]) == 0
    got, want = ((tmp_path / f"{s}.vcf").read_bytes() for s in ("t", "j"))
    assert got == want
    return read_vcf(str(tmp_path / "t.vcf"))


@pytest.mark.parametrize("case", list(CASES))
def test_cases_equal_the_reference(case, tmp_path):
    seq, rows, want_filter = CASES[case]
    table = _run_both(tmp_path, seq, rows)
    if want_filter is not None:
        assert table.filters[0] == want_filter
    if case == "rescue":
        assert table.qual[0] == 20
    if case == "pass_untouched":
        assert table.qual[0] == 50


@pytest.mark.parametrize("extra", [["--min_query_hmer_size", "3"], ["--min_distance_from_edge", "5"],
                                   ["--set_qual", "7", "--min_initial_qual", "50"], ["--min_query_hmer_size", "1"]])
def test_options_equal_the_reference(extra, tmp_path):
    seq, rows, _ = CASES["gatk_qual_and_more"]
    _run_both(tmp_path, seq, rows, extra)


def test_world_rescues_exactly_the_planted(tmp_path):
    w = sfm.write_bridging_world(str(tmp_path / "w"), seed=5, length=600_000, n_records=4_000, n_rescue=60,
                                 n_tandem=30, n_high_normal=30)
    argv = ["--vcf", w["vcf"], "--reference", w["fasta"]]
    assert tbridge.run([*argv, "--output", str(tmp_path / "t.vcf.gz"), *CPU]) == 0
    assert jbridge.run([*argv, "--output", str(tmp_path / "j.vcf.gz")]) == 0
    got, want = (gzip.decompress((tmp_path / f"{s}.vcf.gz").read_bytes()) for s in ("t", "j"))
    assert got == want
    before, after = read_vcf(w["vcf"]), read_vcf(str(tmp_path / "t.vcf.gz"))
    rescued = (np.asarray(before.filters) != "PASS") & (np.asarray(after.filters) == "PASS")
    assert np.array_equal(np.sort(after.pos[rescued]), np.sort(w["rescue"]))
    was_pass = np.asarray(before.filters) == "PASS"
    assert int(was_pass.sum()) == w["n_pass"] and np.array_equal(after.qual[was_pass], before.qual[was_pass])


@pytest.mark.parametrize("radius", [1, 2, 5, 9])
def test_hmer_lengths_equal_the_reference(radius):
    rng = np.random.default_rng(radius)
    n = 4_000
    windows = rng.choice(np.array([0, 0, 0, 1, 2, 3, 4], dtype=np.uint8), (n, 2 * radius + 1))
    alt = rng.integers(0, 5, n).astype(np.int32)
    got = tbridge.bridging_hmer_lengths(windows, alt, radius, torch.device("cpu"))
    want = jbridge.bridging_hmer_lengths(windows, alt, radius)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
