"""The six QC metrics tools of the port against the JAX package's, on the CPU.

Seeded inputs of ``synthetic_reports.write_qc_world`` (two samples' picard
metric files with picard's header lines, empty fields, texts, rates of many
decimals, tiny and past 1e16, and coverage histograms; the sorter's stats
CSV with quoted fields, a repeated column name and bools, its JSON with
nested objects, a list, a null and a bool; a name mapping; an h5 of two
frames) through ``import_metrics``, ``collect_existing_metrics``,
``sorter_to_h5`` (with and without the mapping),
``sorter_stats_to_mean_coverage``, ``create_qc_report`` (arguments and an
INI) and ``convert_h5_to_json`` (of every h5 above). Held exactly: every h5
key (stored columns and kinds, index, dtypes, values), the text and JSON
bytes, the HTML once images are removed.
"""

import shutil
from pathlib import Path

import pytest

from tests.torch_report_compare import store_problems, strip_images
from variantcalling_tpu.pipelines import create_qc_report as jqc
from variantcalling_tpu.pipelines import import_metrics as jim
from variantcalling_tpu.pipelines.misc import collect_existing_metrics as jcol
from variantcalling_tpu.pipelines.misc import convert_h5_to_json as jjson
from variantcalling_tpu.pipelines.misc import sorter_stats_to_mean_coverage as jcov
from variantcalling_tpu.pipelines.misc import sorter_to_h5 as jsort
from variantcalling_tpu_torch import synthetic_reports
from variantcalling_tpu_torch.pipelines import create_qc_report as tqc
from variantcalling_tpu_torch.pipelines import import_metrics as tim
from variantcalling_tpu_torch.pipelines.misc import collect_existing_metrics as tcol
from variantcalling_tpu_torch.pipelines.misc import convert_h5_to_json as tjson
from variantcalling_tpu_torch.pipelines.misc import sorter_stats_to_mean_coverage as tcov
from variantcalling_tpu_torch.pipelines.misc import sorter_to_h5 as tsort
from variantcalling_tpu_torch.utils import h5_utils as th5


@pytest.fixture(scope="module", params=[5, 6])
def qc(request, tmp_path_factory):
    """The seeded world, and each sample's metrics h5 from both packages."""
    d = tmp_path_factory.mktemp(f"qc{request.param}")
    w = synthetic_reports.write_qc_world(str(d / "w"), seed=request.param)
    for pkg, run in (("jax", jim.run), ("torch", tim.run)):
        (d / pkg).mkdir()
        for s in w["samples"]:
            assert run(["--metrics_prefix", w["prefix"][s], "--output_h5", str(d / pkg / f"{s}.metrics.h5")]) == 0
    return {**w, "dir": d}


def _both(tmp_path: Path, jrun, trun, argv_of) -> dict[str, Path]:
    out = {}
    for pkg, run in (("jax", jrun), ("torch", trun)):
        out[pkg] = tmp_path / pkg
        out[pkg].mkdir(parents=True, exist_ok=True)
        assert run(argv_of(out[pkg])) == 0
    return out


def _same_h5(got: Path, want: Path) -> None:
    problems = store_problems(str(got), str(want))
    assert not problems, "\n".join(problems)


def test_import_metrics_equals_the_reference(qc):
    for s in qc["samples"]:
        _same_h5(qc["dir"] / "torch" / f"{s}.metrics.h5", qc["dir"] / "jax" / f"{s}.metrics.h5")
        keys = th5.list_keys(str(qc["dir"] / "torch" / f"{s}.metrics.h5"))
        assert keys == ["coverage_histograms", "metrics", "params"]


def test_collect_existing_metrics_equals_the_reference(qc, tmp_path):
    files = [*qc["files"]["s1"], qc["sorter_csv"], qc["frames_h5"]]
    out = _both(tmp_path, jcol.run, tcol.run, lambda d: ["--metric_files", *files, "--output_h5", str(d / "c.h5")])
    _same_h5(out["torch"] / "c.h5", out["jax"] / "c.h5")
    assert {"s1_metrics", "s1_histogram", "sorter_stats", "frames_table", "frames_indexed"} <= \
        set(th5.list_keys(str(out["torch"] / "c.h5")))


@pytest.mark.parametrize("mapping", [False, True])
def test_sorter_to_h5_equals_the_reference(qc, tmp_path, mapping):
    extra = ["--metric_mapping_file", qc["mapping_csv"]] if mapping else []
    out = _both(tmp_path, jsort.run, tsort.run, lambda d: ["--input_csv_file", qc["sorter_csv"], "--input_json_file",
                                                           qc["sorter_json"], *extra, "--output_file", str(d / "s.h5")])
    _same_h5(out["torch"] / "s.h5", out["jax"] / "s.h5")
    cols = th5.read_hdf(str(out["torch"] / "s.h5"), "scalar_stats").columns
    assert ("mean_coverage" in cols) == mapping and "qc.reads.tiny" in cols and "empty" not in cols


def test_sorter_stats_to_mean_coverage_equals_the_reference(qc, tmp_path):
    out = _both(tmp_path, jcov.run, tcov.run, lambda d: ["--input_sorter_stats_json", qc["sorter_json"],
                                                         "--output_file", str(d / "cov.txt"), "--genome_length",
                                                         "3000000000"])
    assert (out["torch"] / "cov.txt").read_bytes() == (out["jax"] / "cov.txt").read_bytes()


def _qc_report(qc, tmp_path, use_config: bool) -> dict[str, Path]:
    def argv(d: Path) -> list[str]:
        metrics = [str(qc["dir"] / d.name / f"{s}.metrics.h5") for s in qc["samples"]]
        if use_config:
            conf = d / "qc.ini"
            conf.write_text(f"[QCReport]\nrun_id = run7\nsamples = {', '.join(qc['samples'])}\n")
            return ["--config", str(conf), "--metrics_h5", *metrics, "--h5_output", str(d / "qc.h5"),
                    "--html_output", str(d / "qc.html")]
        return ["--samples", *qc["samples"], "--metrics_h5", *metrics, "--run_id", "r1", "--h5_output",
                str(d / "qc.h5"), "--html_output", str(d / "qc.html")]

    return _both(tmp_path, jqc.run, tqc.run, argv)


@pytest.mark.parametrize("use_config", [False, True])
def test_create_qc_report_equals_the_reference(qc, tmp_path, use_config):
    out = _qc_report(qc, tmp_path, use_config)
    _same_h5(out["torch"] / "qc.h5", out["jax"] / "qc.h5")
    assert th5.list_keys(str(out["torch"] / "qc.h5")) == ["coverage", "error", "throughput", "top_metrics"]
    got, n_got = strip_images((out["torch"] / "qc.html").read_text())
    want, n_want = strip_images((out["jax"] / "qc.html").read_text())
    assert got == want and n_want == 2 and n_got in (0, n_want)


def test_convert_h5_to_json_equals_the_reference(qc, tmp_path):
    report = _qc_report(qc, tmp_path / "qc", False)["torch"] / "qc.h5"
    sorter = _both(tmp_path / "sorter", jsort.run, tsort.run, lambda d: [
        "--input_csv_file", qc["sorter_csv"], "--input_json_file", qc["sorter_json"], "--output_file",
        str(d / "s.h5")])["torch"] / "s.h5"
    sources = [report, sorter, qc["dir"] / "torch" / "s1.metrics.h5", Path(qc["frames_h5"])]
    for k, src in enumerate(sources):
        for ignored in ([], ["--ignored_h5_key_substring", "cover", "param"]):
            out = _both(tmp_path / f"j{k}{len(ignored)}", jjson.run, tjson.run, lambda d: [
                "--input_h5", str(src), "--output_json", str(d / "o.json"), *ignored])
            assert (out["torch"] / "o.json").read_bytes() == (out["jax"] / "o.json").read_bytes(), src.name


def test_the_json_holds_every_key_of_the_qc_report(qc, tmp_path):
    import json

    report = _qc_report(qc, tmp_path / "qc", False)["torch"] / "qc.h5"
    assert tjson.run(["--input_h5", str(report), "--output_json", str(tmp_path / "o.json")]) == 0
    doc = json.loads((tmp_path / "o.json").read_text())
    assert sorted(doc) == th5.list_keys(str(report))
    for key, rows in doc.items():
        frame = th5.read_hdf(str(report), key)
        assert len(rows) == len(frame) and all(list(r) == frame.columns for r in rows)
    shutil.rmtree(tmp_path / "qc")
