"""The somatic composites of the port against the JAX package's, on the CPU.

``run_somatic_comparison_and_graphs`` (the comparison, then the evaluation,
in process) and ``detailed_var_report`` (the stratified report over a
comparison h5, through ``reports/report_data_loader``) on the small SEC
world (``synthetic.write_sec_world``: a held-out callset on a 2 Mbp contig
and its truth). Through both packages' CLIs: every h5 frame equal (columns,
dtypes, values, floats exactly; the evaluation's curves, arrays a row,
value for value), the BED, the evaluation's CSVs and the detailed report's
CSV byte-equal, and the HTML equal once ``<img>`` elements are removed
(``tests/torch_report_compare.strip_images``). The detailed report runs on
the composite's comparison h5 and on a comparison annotated with the
world's exome track (regions, the exome frame and the per-track accuracy
tables), and on a frame whose loader fails (no genotype columns).
``--make_plots``: the reference draws a figure through ``reports/nexusplt``;
the port skips and counts it.
"""

import filecmp

import numpy as np
import pytest

from tests.torch_report_compare import strip_images
from variantcalling_tpu.__main__ import main as jax_main
from variantcalling_tpu_torch import synthetic
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch.reports.html import FIGURE_POINT
from variantcalling_tpu_torch.utils import degrade
from variantcalling_tpu_torch.utils import h5_utils as th5

SAMPLES = ["--call_sample_name", "sm1", "--truth_sample_name", "HG001"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("somatic")
    w = synthetic.write_sec_world(str(d), seed=9, length=2_000_000, n_pool=1_500, n_samples=1, n_private=50,
                                  n_heldout=2_500)
    return {**w, "dir": d}


def _same_frames(got_path: str, want_path: str) -> None:
    """Every key of two h5 files of frames equal: columns, dtypes, index and
    values (floats exactly, NaN where NaN; array cells element by element)."""
    keys = th5.list_keys(want_path)
    assert th5.list_keys(got_path) == keys and keys
    for key in keys:
        got, want = th5.read_hdf(got_path, key), th5.read_hdf(want_path, key)
        assert got.columns == want.columns, key
        assert np.array_equal(np.asarray(got.index if got.index is not None else range(len(got))),
                              np.asarray(want.index if want.index is not None else range(len(want)))), key
        for c in want.columns:
            x, y = np.asarray(got[c]), np.asarray(want[c])
            assert x.dtype == y.dtype and len(x) == len(y), (key, c)
            if x.dtype == object:
                for a, b in zip(x, y):
                    if isinstance(b, np.ndarray):
                        assert np.array_equal(a, b, equal_nan=True), (key, c)
                    else:
                        assert a == b or (a != a and b != b), (key, c)
            else:
                assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), (key, c)


def _composite(world, out, main, extra=()) -> int:
    return main(["run_somatic_comparison_and_graphs", "--somatic_vcf", world["heldout"], "--gt_vcf", world["truth"],
                 "--highconf_bed", world["hcr"], "--reference", world["fasta"], "--output_folder", str(out),
                 *SAMPLES, *extra])


@pytest.fixture(scope="module")
def composites(world):
    d = world["dir"]
    assert _composite(world, d / "jax", jax_main) == 0
    degrade.clear_for_tests()
    assert _composite(world, d / "port", torch_main, ["--make_plots", "--backend", "cpu"]) == 0
    skipped = degrade.events_for(FIGURE_POINT)
    return d / "jax", d / "port", skipped


@pytest.mark.parametrize("name", ["somatic_comparison.h5", "somatic_eval.h5"])
def test_composite_frames_equal_the_reference(composites, name):
    jax_dir, port_dir, _ = composites
    _same_frames(str(port_dir / name), str(jax_dir / name))


@pytest.mark.parametrize("name", ["somatic_comparison.intervals.bed", "somatic_eval.stats.csv",
                                  "somatic_eval.thresholds.csv"])
def test_composite_files_equal_the_reference(composites, name):
    jax_dir, port_dir, _ = composites
    assert filecmp.cmp(port_dir / name, jax_dir / name, shallow=False)


def test_make_plots_skips_and_counts_its_figure(composites):
    jax_dir, port_dir, skipped = composites
    assert len(skipped) == 1 and "recall/precision" in skipped[0][2]
    assert not list(port_dir.glob("*.png")) and not list(port_dir.glob("*.html"))


@pytest.fixture(scope="module")
def annotated(world):
    """A comparison annotated with the world's exome track."""
    d = world["dir"]
    path = str(d / "annotated.h5")
    assert torch_main(["run_comparison_pipeline", "--input_prefix", world["heldout"], "--gtr_vcf", world["truth"],
                       "--highconf_intervals", world["hcr"], "--reference", world["fasta"], "--annotate_intervals",
                       world["exome"], "--output_file", path, "--output_interval", str(d / "annotated.bed"),
                       "--backend", "cpu", *SAMPLES]) == 0
    return path


@pytest.fixture(scope="module")
def no_genotypes(world, annotated):
    """The annotated frame without its genotype columns: the loader raises
    KeyError and the report reads the whole frame."""
    d = world["dir"]
    frame = th5.read_hdf(annotated, "chr20")
    keep = [c for c in frame.columns if c not in ("gt_ultima", "gt_ground_truth")]
    path = str(d / "no_gt.h5")
    th5.write_hdf(frame.select(keep), path, key="chr20", mode="w")
    return path


@pytest.mark.parametrize("source", ["composite", "annotated", "no_genotypes"])
def test_detailed_var_report_equals_the_reference(world, composites, annotated, no_genotypes, source, tmp_path):
    h5 = {"composite": str(composites[0] / "somatic_comparison.h5"), "annotated": annotated,
          "no_genotypes": no_genotypes}[source]
    exome = ["--exome_column_name", "exome"]
    for pkg, main, extra in (("jax", jax_main, []), ("port", torch_main, ["--backend", "cpu"])):
        assert main(["detailed_var_report", "--h5_concordance_file", h5, "--h5_output", str(tmp_path / f"{pkg}.h5"),
                     "--csv_output", str(tmp_path / f"{pkg}.csv"), "--html_output", str(tmp_path / f"{pkg}.html"),
                     *exome, *extra]) == 0
    _same_frames(str(tmp_path / "port.h5"), str(tmp_path / "jax.h5"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    got, n_got = strip_images((tmp_path / "port.html").read_text())
    want, n_want = strip_images((tmp_path / "jax.html").read_text())
    assert got == want
    # figures: drawn where matplotlib imports (both), none where it does not (the port skips them)
    assert n_got in (0, n_want)
    keys = th5.list_keys(str(tmp_path / "port.h5"))
    if source == "annotated":
        assert {"detailed_vars_exome", "inside_exome", "outside_exome"} <= set(keys)


@pytest.mark.parametrize("tool", ["run_somatic_comparison_and_graphs", "detailed_var_report"])
def test_without_a_card_the_default_backend_exits_2(world, tool, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["--somatic_vcf", world["heldout"], "--gt_vcf", world["truth"], "--highconf_bed", world["hcr"],
             "--reference", world["fasta"], "--output_folder", str(tmp_path / "out")]
            if tool == "run_somatic_comparison_and_graphs" else
            ["--h5_concordance_file", str(tmp_path / "missing.h5"), "--h5_output", str(tmp_path / "x.h5")])
    assert torch_main([tool, *argv]) == 2
    assert not (tmp_path / "out").exists() and not (tmp_path / "x.h5").exists()


def test_matrix_figures_are_skipped_and_counted_without_matplotlib(annotated, tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ModuleNotFoundError("No module named 'matplotlib'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    degrade.clear_for_tests()
    assert torch_main(["detailed_var_report", "--h5_concordance_file", annotated, "--h5_output",
                       str(tmp_path / "d.h5"), "--html_output", str(tmp_path / "d.html"), "--exome_column_name",
                       "exome", "--backend", "cpu"]) == 0
    assert len(degrade.events_for(FIGURE_POINT)) == 5  # two genome and three exome matrices
    assert "<img" not in (tmp_path / "d.html").read_text()
