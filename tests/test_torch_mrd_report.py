"""mrd_data_analysis of the port against the JAX package's, on the CPU.

A small featuremap world (``synthetic_featuremap.write_featuremap_world``)
through the port's ``srsnv_training``, ``srsnv_inference`` and
``mrd_analysis`` on the CPU, its signature copied with a seeded INFO ``AF``
(``synthetic_reports.write_signature_af``), then both packages'
``mrd_data_analysis`` on the same files: with no query, with read and
signature queries (the filters table, the six tumor-fraction tables),
``not in`` and chained comparisons, control signatures (two of one name),
the coverage and pass-fraction options, the summary alone and a featuremap
without a signature. Held exactly: every h5 key (stored columns and kinds,
index, dtypes, values) and the HTML once images are removed. A query the
whitelist refuses fails both packages the same way, and writes nothing.
"""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from tests.torch_report_compare import store_problems, strip_images
from variantcalling_tpu.pipelines import mrd_data_analysis as jmrd
from variantcalling_tpu_torch import synthetic_featuremap as sfm
from variantcalling_tpu_torch import synthetic_reports
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch.io.vcf import read_vcf
from variantcalling_tpu_torch.pipelines import mrd_data_analysis as tmrd
from variantcalling_tpu_torch.utils import h5_utils as th5

CPU = ["--backend", "cpu"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mrd_report")
    fm = sfm.write_featuremap_world(str(d / "fm"), seed=2, length=200_000, n_tp=400, n_fp=400, n_cfdna=4_000,
                                    n_signature=60, tumor_fraction=0.05, n_lpr_loci=60, lpr_reads=800, n_calls=200)
    model, scored, summary = str(d / "m.pkl"), str(d / "scored.vcf"), str(d / "mrd.h5")
    assert torch_main(["srsnv_training", "--tp_featuremap", fm["tp"], "--fp_featuremap", fm["fp"], "--output_model",
                       model, "--n_trees", "8", "--max_depth", "3", *CPU]) == 0
    assert torch_main(["srsnv_inference", "--featuremap", fm["cfdna"], "--model", model, "--output_featuremap",
                       scored, *CPU]) == 0
    assert torch_main(["mrd_analysis", "--signature_vcf", fm["signature"], "--featuremap", scored,
                       "--coverage_per_locus", "30", "--output_h5", summary, *CPU]) == 0
    sig = synthetic_reports.write_signature_af(str(d / "signature_af.vcf"), fm["signature"], seed=4)
    os.makedirs(d / "other", exist_ok=True)
    ctrl2 = str(d / "other" / "control.vcf")
    synthetic_reports.write_signature_af(ctrl2, fm["control"], seed=5)
    return {"summary": summary, "scored": scored, "signature": sig, "controls": [fm["control"], ctrl2], "dir": d}


def _both(tmp_path: Path, argv: list[str]) -> dict[str, Path]:
    out = {}
    tmp_path.mkdir(exist_ok=True)
    for pkg, run in (("jax", jmrd.run), ("torch", tmrd.run)):
        assert run([*argv, "--h5_output", str(tmp_path / "r.h5"), "--html_output", str(tmp_path / "r.html")]) == 0
        d = tmp_path / pkg
        d.mkdir()
        for name in ("r.h5", "r.html"):
            shutil.move(str(tmp_path / name), str(d / name))
        out[pkg] = d
    problems = store_problems(str(out["torch"] / "r.h5"), str(out["jax"] / "r.h5"))
    assert not problems, "\n".join(problems)
    got, n_got = strip_images((out["torch"] / "r.html").read_text())
    want, n_want = strip_images((out["jax"] / "r.html").read_text())
    assert got == want and n_got in (0, n_want)
    return out


CASES = {
    "plain": [],
    "queries": ["--read_filter_query", "ML_QUAL >= 5 and X_LENGTH < 220 and rq > 0.7", "--signature_filter_query",
                "AF >= 0.2"],
    "not_in": ["--read_filter_query", "(X_EDIST not in [2, 3]) | (X_SCORE > 3)", "--signature_filter_query",
               "not AF < 0.1"],
    "chained": ["--read_filter_query", "2 < X_EDIST <= 5", "--signature_filter_query", "pos % 3 != 0"],
    "denominator": ["--read_filter_query", "ML_QUAL > 1", "--coverage_per_locus", "12.5", "--read_pass_fraction",
                    "0.8"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_mrd_report_equals_the_reference(world, tmp_path, case):
    out = _both(tmp_path, ["--mrd_summary_h5", world["summary"], "--featuremap", world["scored"], "--signature_vcf",
                           world["signature"], *CASES[case]])
    keys = set(th5.list_keys(str(out["torch"] / "r.h5")))
    assert {"mrd_summary", "mutation_types", "allele_fractions", "ml_qual_distribution", "read_lengths"} <= keys
    assert len([k for k in keys if k.startswith("df_")]) == 6
    assert ("filters_applied" in keys) == any(a.endswith("_query") for a in CASES[case])


def test_mrd_report_with_controls(world, tmp_path):
    out = _both(tmp_path, ["--mrd_summary_h5", world["summary"], "--featuremap", world["scored"], "--signature_vcf",
                           world["signature"], "--control_signature_vcfs", *world["controls"],
                           "--signature_filter_query", "AF > 0.3"])
    keys = set(th5.list_keys(str(out["torch"] / "r.h5")))
    assert {"mutation_types_control", "mutation_types_control_2", "allele_fractions_control_2"} <= keys
    assert "allele_fractions_control" not in keys  # the first control carries no AF


def test_mrd_report_without_signature_or_featuremap(world, tmp_path):
    _both(tmp_path / "a", ["--mrd_summary_h5", world["summary"], "--featuremap", world["scored"]])
    out = _both(tmp_path / "b", ["--mrd_summary_h5", world["summary"], "--read_filter_query", "ML_QUAL > 2"])
    assert th5.list_keys(str(out["torch"] / "r.h5")) == ["filters_applied", "mrd_summary"]


def test_filtered_tables_select_what_numpy_selects(world, tmp_path):
    """The filtered per-locus table holds exactly the reads that pass the
    query on the signature loci that pass theirs (a selection written apart)."""
    h5 = str(tmp_path / "r.h5")
    assert tmrd.run(["--mrd_summary_h5", world["summary"], "--featuremap", world["scored"], "--signature_vcf",
                     world["signature"], "--read_filter_query", "ML_QUAL >= 5 and X_LENGTH < 220",
                     "--signature_filter_query", "AF >= 0.2", "--h5_output", h5,
                     "--html_output", str(tmp_path / "r.html")]) == 0
    fm, sig = read_vcf(world["scored"]), read_vcf(world["signature"])
    af = sig.info_field("AF")
    loci = {(c, int(p)) for c, p, a in zip(sig.chrom, sig.pos, af) if a >= 0.2}
    q, ln = fm.info_field("ML_QUAL"), fm.info_field("X_LENGTH")
    keep = [(c, int(p)) for c, p, a, b in zip(fm.chrom, fm.pos, q, ln) if a >= 5 and b < 220 and (c, int(p)) in loci]
    per = th5.read_hdf(h5, "df_supporting_reads_per_locus_filt_signature_filt_featuremap")
    counts = {}
    for k in keep:
        counts[k] = counts.get(k, 0) + 1
    assert list(zip(per["chrom"].tolist(), per["pos"].tolist())) == sorted(counts)
    assert per["n_supporting_reads"].tolist() == [counts[k] for k in sorted(counts)]
    tf = th5.read_hdf(h5, "df_tf_filt_signature_filt_featuremap")
    assert int(tf["n_supporting_reads"][0]) == len(keep) > 0 and int(tf["n_loci"][0]) == len(loci)


@pytest.mark.parametrize("query", ["__import__('os').getcwd() == ''", "ML_QUAL.real > 1", "ML_QUAL >",
                                   "ML_QUAL if rq else AF"])
def test_a_refused_query_fails_both_packages(world, tmp_path, query):
    for pkg, run in (("jax", jmrd.run), ("torch", tmrd.run)):
        with pytest.raises(ValueError, match=r"^filter query .* failed: "):
            run(["--mrd_summary_h5", world["summary"], "--featuremap", world["scored"], "--signature_vcf",
                 world["signature"], "--read_filter_query", query, "--h5_output", str(tmp_path / f"{pkg}.h5"),
                 "--html_output", str(tmp_path / f"{pkg}.html")])
    assert not (tmp_path / "torch.html").exists()


def test_describe_filters_and_mutation_types_equal_the_reference(world):
    from variantcalling_tpu.io.vcf import read_vcf as jread_vcf

    for q in ("ML_QUAL >= 40 and (not X_EDIST > 5) and ug_hcr", "()", "id and af > 0.1 and foo < 2"):
        got, want = tmrd.describe_filters(q), jmrd.describe_filters(q)
        assert got.columns == list(want.columns)
        assert all(got[c].tolist() == want[c].tolist() for c in want.columns)
    for path in (world["signature"], world["controls"][0]):
        got, want = tmrd.mutation_type_counts(read_vcf(path)), jmrd.mutation_type_counts(jread_vcf(path))
        assert got["mutation"].tolist() == want["mutation"].tolist()
        assert np.array_equal(got["count"], want["count"].to_numpy())
        assert np.array_equal(got["fraction"], want["fraction"].to_numpy())
