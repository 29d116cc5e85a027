"""The variant reports of the port against the JAX package's, on the CPU.

``create_var_report`` over two concordance frames: the port's own
``run_comparison_pipeline`` output on a small SEC world (annotated with its
exome track; no UG-HCR, LCR or mappability columns, so those sections skip)
and a seeded frame of ``synthetic_reports.write_concordance_h5`` in two
contigs with every annotation the report reads (every section, the SEC
refilter, every genotype error class), at verbosity 1, 2 and 3, with PNGs
under ``--plot_dir``, through a VarReport INI and on hg19 names. Held
exactly: every h5 key (stored columns and kinds, index, dtypes, values) and
the HTML. Then ``reports/report_utils`` alone (each category, the
counts and the curve against the reference's) and ``report_wo_gt`` on a
``run_no_gt_report full_analysis`` h5 (the HTML equal once images are
removed; as many figures drawn where matplotlib imports, all skipped and
counted where it does not).
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

from tests.torch_report_compare import store_problems, strip_images
from variantcalling_tpu.pipelines import create_var_report as jvar
from variantcalling_tpu.pipelines import report_wo_gt as jwo
from variantcalling_tpu.reports import report_utils as jru
from variantcalling_tpu.reports.report_data_loader import ReportDataLoader as JLoader
from variantcalling_tpu_torch import synthetic, synthetic_reports
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch.pipelines import create_var_report as tvar
from variantcalling_tpu_torch.pipelines import report_wo_gt as two
from variantcalling_tpu_torch.reports import report_utils as tru
from variantcalling_tpu_torch.reports.html import FIGURE_POINT
from variantcalling_tpu_torch.reports.report_data_loader import ReportDataLoader
from variantcalling_tpu_torch.utils import degrade
from variantcalling_tpu_torch.utils import h5_utils as th5


@pytest.fixture(scope="module")
def comparison(tmp_path_factory):
    """The port's comparison h5 of a held-out callset, annotated with the exome track."""
    d = tmp_path_factory.mktemp("var_cmp")
    w = synthetic.write_sec_world(str(d), seed=9, length=1_000_000, n_pool=800, n_samples=1, n_private=30,
                                  n_heldout=1_200)
    path = str(d / "cmp.h5")
    assert torch_main(["run_comparison_pipeline", "--input_prefix", w["heldout"], "--gtr_vcf", w["truth"],
                       "--highconf_intervals", w["hcr"], "--reference", w["fasta"], "--annotate_intervals",
                       w["exome"], "--output_file", path, "--output_interval", str(d / "cmp.bed"), "--backend", "cpu",
                       "--call_sample_name", "sm1", "--truth_sample_name", "HG001"]) == 0
    return path


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    d = tmp_path_factory.mktemp("var_seeded")
    return synthetic_reports.write_concordance_h5(str(d / "seeded.h5"), seed=11, n_rows=3_000)


def _both(tmp_path: Path, argv: list[str], html: bool = True) -> dict[str, Path]:
    """Each package's run with the same output names (the parameters table holds them), moved apart after."""
    out = {}
    for pkg, run in (("jax", jvar.run), ("torch", tvar.run)):
        files = ["--h5_output", str(tmp_path / "r.h5")] + (["--html_output", str(tmp_path / "r.html")] if html else [])
        assert run([*argv, *files]) == 0
        d = tmp_path / pkg
        d.mkdir()
        for name in ("r.h5", "r.html", "plots"):
            if (tmp_path / name).exists():
                shutil.move(str(tmp_path / name), str(d / name))
        out[pkg] = d
    return out


def _assert_same(out: dict[str, Path], html: bool = True) -> None:
    problems = store_problems(str(out["torch"] / "r.h5"), str(out["jax"] / "r.h5"))
    assert not problems, "\n".join(problems)
    if html:
        assert (out["torch"] / "r.html").read_bytes() == (out["jax"] / "r.html").read_bytes()


@pytest.mark.parametrize("verbosity", ["1", "2", "3"])
def test_var_report_on_a_comparison_equals_the_reference(comparison, tmp_path, verbosity):
    out = _both(tmp_path, ["--h5_concordance_file", comparison, "--exome_column_name", "exome", "--verbosity",
                           verbosity, "--run_id", "r1", "--pipeline_version", "v1"])
    _assert_same(out)
    keys = th5.list_keys(str(out["torch"] / "r.h5"))
    assert {"parameters", "all_data", "sec_data", "exome"} <= set(keys) and "ug_hcr" not in keys
    assert ("exome_snp_errors" in keys) == (verbosity != "1")
    assert ("wg_indel_analysis" in keys) == (verbosity == "3")


@pytest.mark.parametrize("verbosity", ["1", "2", "3"])
def test_var_report_on_every_section_equals_the_reference(seeded, tmp_path, verbosity):
    out = _both(tmp_path, ["--h5_concordance_file", seeded, "--verbosity", verbosity])
    _assert_same(out)
    keys = set(th5.list_keys(str(out["torch"] / "r.h5")))
    assert {"all_data", "sec_data", "ug_hcr", "ug_hcr_sec_data", "exome", "exome_sec_data"} <= keys
    if verbosity != "1":
        assert {"all_data_per_base", "all_data_homozygous", "good_cvg_data", "good_cvg_data_homozygous",
                "callable_data", "exome_hmer_indel_errors", "exome_snp_errors"} <= keys
    if verbosity == "3":
        assert {"wg_indel_analysis", "ug_hcr_indel_analysis", "exome_indel_analysis"} <= keys


def test_var_report_plots_config_and_hg19(seeded, tmp_path):
    """The PR grids' PNGs of the same names under --plot_dir (where matplotlib
    imports), the INI's values over the defaults, and hg19's renamed tracks."""
    conf = tmp_path / "var.ini"
    conf.write_text(f"[VarReport]\nrun_id = r9\npipeline_version = p9\nh5_concordance_file = {seeded}\n"
                    "verbosity = 2\nreference_version = hg19\n")
    out = _both(tmp_path, ["--config", str(conf), "--plot_dir", str(tmp_path / "plots")])
    _assert_same(out)
    got = sorted(p.name for p in (out["torch"] / "plots").iterdir()) if (out["torch"] / "plots").exists() else []
    want = sorted(p.name for p in (out["jax"] / "plots").iterdir())
    # hg19 names its tracks otherwise: the seeded frame's ug_hcr and mappability are not read
    assert got in ([], want) and want == ["pr_all_data.png", "pr_callable_data.png", "pr_exome.png"]


def test_indel_panel_is_saved_under_the_reference_name(frames, tmp_path):
    """One indel panel (verbosity 3) through both packages: the same file name, or skipped and counted."""
    port, ref = frames
    for ru, data in ((tru.ReportUtils(3, str(tmp_path / "t.h5"), plot_dir=str(tmp_path / "t")), port),
                     (jru.ReportUtils(3, str(tmp_path / "j.h5"), plot_dir=str(tmp_path / "j")), ref)):
        ru.INDEL_VARIABLES = ("indel_length",)
        ru.indel_analysis(data, "ug-hcr")
    want = sorted(p.name for p in (tmp_path / "j").iterdir())
    got = sorted(p.name for p in (tmp_path / "t").iterdir()) if (tmp_path / "t").exists() else []
    assert want == ["indel_ug-hcr_hmer_indels_indel_length.png", "indel_ug-hcr_non_hmer_indels_indel_length.png"]
    assert got in ([], want)


def test_var_report_refuses_to_overwrite_its_input(seeded, tmp_path):
    copy = tmp_path / "in.h5"
    shutil.copy(seeded, copy)
    with pytest.raises(SystemExit, match="must differ"):
        tvar.run(["--h5_concordance_file", str(copy), "--h5_output", str(copy)])
    assert copy.read_bytes() == Path(seeded).read_bytes()


def test_var_report_figures_are_skipped_and_counted_without_matplotlib(seeded, tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ModuleNotFoundError("No module named 'matplotlib'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    degrade.clear_for_tests()
    assert tvar.run(["--h5_concordance_file", seeded, "--h5_output", str(tmp_path / "r.h5"), "--verbosity", "2",
                     "--plot_dir", str(tmp_path / "plots")]) == 0
    # the PR grids of all data, UG-HCR, exome, good coverage and callable
    assert len(degrade.events_for(FIGURE_POINT)) == 5 and not (tmp_path / "plots").exists()


# -- report_utils alone ------------------------------------------------------------------------------------------------

CATEGORIES = tvar.FINE_CATEGORIES + [f"hmer Indel {i}" for i in (1, 2, 3, 9)]


@pytest.fixture(scope="module")
def frames(seeded):
    return ReportDataLoader(seeded).load_concordance_df(), JLoader(seeded).load_concordance_df()


@pytest.mark.parametrize("cat", CATEGORIES)
def test_each_category_and_its_counts_equal_the_reference(frames, cat):
    port, ref = frames
    got = tru.filter_by_category(port, cat)
    want = jru.filter_by_category(ref, cat)
    assert np.array_equal(np.asarray(got.index), want.index.to_numpy())
    ru, jr = tru.ReportUtils(2, "unused.h5"), jru.ReportUtils(2, "unused.h5")
    (gd, gcurve), (wd, wcurve) = ru.calc_performance(got), jr.calc_performance(want)
    assert gd.keys() == wd.keys()
    for k in wd:
        assert gd[k] == wd[k] or (gd[k] != gd[k] and wd[k] != wd[k]), (cat, k)
    assert gcurve.columns == list(wcurve.columns)
    for c in wcurve.columns:
        assert np.array_equal(gcurve[c], wcurve[c].to_numpy(), equal_nan=True), (cat, c)


def test_an_unknown_category_raises(frames):
    with pytest.raises(RuntimeError, match="No such category"):
        tru.filter_by_category(frames[0], "hmer Indel 10")


def test_the_direction_switch_follows_the_first_scores(frames):
    """The score is oriented by the mean of the first 20 scored records on each side."""
    port, ref = frames
    port = tru.filter_by_category(port, "SNP")
    flipped = th5.Frame(dict(port.data), port.index)
    flipped["tree_score"] = -np.asarray(port["tree_score"])
    ref_flipped = jru.filter_by_category(ref, "SNP").assign(tree_score=lambda d: -d["tree_score"])
    for frame, want in ((port, jru.filter_by_category(ref, "SNP")), (flipped, ref_flipped)):
        _, got_curve = tru.ReportUtils(2, "x.h5").calc_performance(frame)
        _, want_curve = jru.ReportUtils(2, "x.h5").calc_performance(want)
        assert np.array_equal(got_curve["tree_score"], want_curve["tree_score"].to_numpy(), equal_nan=True)


# -- report_wo_gt ----------------------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def no_gt_h5(tmp_path_factory):
    d = tmp_path_factory.mktemp("wo_gt")
    w = synthetic_reports.write_report_world(str(d), seed=7, length=1_000_000, n_records=1_500, control_records=300,
                                             n_extra_dbsnp=1_000)
    prefix = str(d / "f")
    assert torch_main(["run_no_gt_report", "full_analysis", "--input_file", w["case"], "--dbsnp", w["dbsnp"],
                       "--reference", w["fasta"], "--callable_region", w["callable"], "--output_prefix", prefix,
                       "--backend", "cpu"]) == 0
    return prefix + ".h5"


def test_report_wo_gt_equals_the_reference(no_gt_h5, tmp_path):
    for name, run in (("jax", jwo.run), ("torch", two.run)):
        assert run(["--input_h5", no_gt_h5, "--html_output", str(tmp_path / f"{name}.html"),
                    "--sample_name", "case"]) == 0
    got, n_got = strip_images((tmp_path / "torch.html").read_text())
    want, n_want = strip_images((tmp_path / "jax.html").read_text())
    assert got == want and n_want >= 5 and n_got in (0, n_want)


def test_report_wo_gt_skips_and_counts_every_figure_without_matplotlib(no_gt_h5, tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ModuleNotFoundError("No module named 'matplotlib'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    degrade.clear_for_tests()
    assert two.run(["--input_h5", no_gt_h5, "--html_output", str(tmp_path / "t.html")]) == 0
    assert "<img" not in (tmp_path / "t.html").read_text()
    assert len(degrade.events_for(FIGURE_POINT)) == len(th5.list_keys(no_gt_h5))
