"""create_qc_report — sequence-data QC report over per-sample metrics h5s.

Counterpart of ``variantcalling_tpu/pipelines/create_qc_report.py``, without
pandas, with the same arguments (a host tool: no ``--backend``): the
``import_metrics`` h5s of N samples (long File/Parameter/Value tables and
coverage histograms) to the top-metrics, throughput, coverage and error
tables (h5 keys ``top_metrics``, ``throughput``, ``coverage``, ``error``)
and an HTML report with the first sample's raw tables. Figures through
``reports/html.add_figure_safe``.
"""

from __future__ import annotations

import argparse
import configparser
import logging
import sys

import numpy as np

from variantcalling_tpu_torch.reports.html import HtmlReport, add_figure_safe
from variantcalling_tpu_torch.utils.h5_utils import Frame, object_column, read_hdf, write_frames

log = logging.getLogger(__name__)

# the reference's top_metrics_for_tbl.csv (key, metric file)
TOP_METRICS = [
    ("TOTAL_READS", "quality_yield_metrics"),
    ("PCT_PF_READS", "alignment_summary_metrics"),
    ("PCT_PF_READS_ALIGNED", "alignment_summary_metrics"),
    ("PF_BASES", "quality_yield_metrics"),
    ("PF_Q30_BASES", "quality_yield_metrics"),
    ("MEAN_READ_LENGTH", "alignment_summary_metrics"),
    ("MEAN_COVERAGE", "raw_wgs_metrics"),
    ("FOLD_90_BASE_PENALTY", "raw_wgs_metrics"),
    ("PCT_20X", "raw_wgs_metrics"),
    ("PERCENT_DUPLICATION", "duplication_metrics"),
    ("PF_INDEL_RATE", "alignment_summary_metrics"),
    ("PF_MISMATCH_RATE", "alignment_summary_metrics"),
]
THROUGHPUT = [("Total reads", "quality_yield_metrics", "TOTAL_READS"),
              ("PF reads", "quality_yield_metrics", "PF_READS"),
              ("Aligned reads", "alignment_summary_metrics", "PF_READS_ALIGNED"),
              ("PF bases", "quality_yield_metrics", "PF_BASES"),
              ("Q30 bases", "quality_yield_metrics", "PF_Q30_BASES")]
COVERAGE = [("Mean coverage", "raw_wgs_metrics", "MEAN_COVERAGE"),
            ("Median coverage", "raw_wgs_metrics", "MEDIAN_COVERAGE"),
            ("PCT_20X", "raw_wgs_metrics", "PCT_20X"),
            ("Fold-90 penalty", "raw_wgs_metrics", "FOLD_90_BASE_PENALTY")]
ERROR = [("Mismatch rate", "alignment_summary_metrics", "PF_MISMATCH_RATE"),
         ("Indel rate", "alignment_summary_metrics", "PF_INDEL_RATE"),
         ("Duplication", "duplication_metrics", "PERCENT_DUPLICATION")]


def _contains(column, text: str) -> np.ndarray:
    """``Series.str.contains(text, regex=False)``, a missing value False."""
    return np.array([isinstance(v, str) and text in v for v in np.asarray(column).tolist()], dtype=bool)


def file_mask(metrics: Frame, file_substr: str) -> np.ndarray:
    """The rows of ``file_substr``'s metric file. 'wgs_metrics' also matches
    'raw_wgs_metrics' as a substring: the longer name is left out when the
    shorter one is asked for."""
    m = _contains(metrics["File"], file_substr)
    if file_substr == "wgs_metrics":
        m &= ~_contains(metrics["File"], "raw_wgs_metrics")
    return m


def get_metric(metrics: Frame, file_substr: str, param: str) -> float:
    rows = np.flatnonzero(file_mask(metrics, file_substr) & (np.asarray(metrics["Parameter"], dtype=object) == param))
    if not len(rows):
        return np.nan
    try:
        return float(np.asarray(metrics["Value"])[rows[0]])
    except (TypeError, ValueError):
        return np.nan


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="create_qc_report", description=run.__doc__)
    ap.add_argument("--config", help="QCReport INI (qc_report.config surface)")
    ap.add_argument("--samples", nargs="*", default=None, help="sample names")
    ap.add_argument("--metrics_h5", nargs="*", default=None, help="per-sample import_metrics h5 (same order)")
    ap.add_argument("--run_id", default="NA")
    ap.add_argument("--h5_output", default="qc_report.h5")
    ap.add_argument("--html_output", default=None)
    return ap.parse_args(argv)


def _table(per_sample: dict[str, Frame], samples: list[str], rows: list[tuple[str, str, str]]) -> Frame:
    """A row a metric, a float64 column a sample (``pd.DataFrame`` of per-sample dicts)."""
    cols = {s: np.array([get_metric(per_sample[s], f, p) for _, f, p in rows], dtype=np.float64)
            for s in dict.fromkeys(samples)}
    return Frame(cols, object_column([name for name, _, _ in rows]))


def _with_metric(table: Frame) -> Frame:
    """``table.reset_index().rename(columns={"index": "metric"})``."""
    return Frame({"metric": object_column(np.asarray(table.index).tolist()), **table.data})


def _row_sum(table: Frame) -> np.ndarray:
    """``table.sum(axis=1)``: each row's values added column after column, NaN skipped."""
    total = np.zeros(len(table))
    for c in table.columns:
        v = np.asarray(table[c], dtype=np.float64)
        total = total + np.where(np.isnan(v), 0.0, v)
    return total


def run(argv) -> int:
    """Generate the QC report from per-sample metrics stores."""
    args = parse_args(argv)
    samples = args.samples or []
    metrics_files = args.metrics_h5 or []
    run_id = args.run_id
    if args.config:
        cp = configparser.ConfigParser()
        cp.read(args.config)
        sec = cp["QCReport"]
        run_id = sec.get("run_id", run_id)
        if not samples:
            samples = [s.strip() for s in sec.get("samples", "").split(",") if s.strip()]
        if not metrics_files:
            metrics_files = [f"{s}.metrics.h5" for s in samples]
    if not samples or len(samples) != len(metrics_files):
        raise SystemExit("need --samples and --metrics_h5 of equal length (or a --config)")

    per_sample = {s: read_hdf(f, key="metrics") for s, f in zip(samples, metrics_files)}
    rep = HtmlReport(f"Sequence data QC Report — run {run_id}")
    rep.add_params({"run_id": run_id, "samples": ", ".join(samples)})
    tables: dict[str, Frame] = {}

    top = _table(per_sample, samples, [(k, f, k) for k, f in TOP_METRICS])
    rep.add_section("Top metrics")
    rep.add_table(top)
    tables["top_metrics"] = _with_metric(top)

    tp = _table(per_sample, samples, THROUGHPUT)
    tp["Total"] = _row_sum(tp)  # the notebook's total row
    rep.add_section("Throughput")
    rep.add_table(tp)
    tables["throughput"] = _with_metric(tp)

    def _attrition(plt):
        # read attrition bars: total -> PF -> aligned, per sample
        fig, ax = plt.subplots(figsize=(7, 3.5))
        names = list(dict.fromkeys(samples))
        x = np.arange(len(names))
        for k, label in enumerate(("Total reads", "PF reads", "Aligned reads")):
            ax.bar(x + (k - 1) * 0.25, [tp[s][k] for s in names], width=0.25, label=label)
        ax.set_xticks(x)
        ax.set_xticklabels(names, rotation=90)
        ax.legend()
        ax.set_ylabel("# reads")
        return fig

    add_figure_safe(rep, _attrition, "throughput figure")

    cm = _table(per_sample, samples, COVERAGE)
    rep.add_section("Coverage")
    rep.add_table(cm)
    tables["coverage"] = _with_metric(cm)

    # the coverage histogram and its cumulative share, with median lines
    def _coverage_fig(plt):
        hists = {}
        for sample, f in zip(samples, metrics_files):
            try:
                hists[sample] = read_hdf(f, key="coverage_histograms")
            except KeyError:
                pass
        if not hists:
            return None
        fig, ax = plt.subplots(1, 2, figsize=(14, 4))
        for sample, h in hists.items():
            # the frame holds every picard file's histogram: the wgs_metrics one only
            if "File" in h:
                files = Frame({"File": object_column([str(v) for v in np.asarray(h["File"]).tolist()])})
                wgs = h.take(file_mask(files, "wgs_metrics"))
                h = wgs if len(wgs) else h
            num = [c for c in h.columns if np.asarray(h[c]).dtype.kind in "iuf"]
            if len(num) < 2:
                continue
            cov, cnt = np.asarray(h[num[0]]), np.asarray(h[num[1]])
            ax[0].plot(cov, cnt, label=sample)
            ax[1].plot(cov, np.cumsum(cnt) / max(cnt.sum(), 1), label=sample)
            med = get_metric(per_sample[sample], "wgs_metrics", "MEDIAN_COVERAGE")
            if np.isfinite(med):
                ax[0].axvline(med, ls="--", alpha=0.5)
        ax[0].set_xlabel("coverage")
        ax[0].set_ylabel("# loci")
        ax[0].legend()
        ax[1].set_xlabel("coverage")
        ax[1].set_ylabel("cumulative fraction")
        return fig

    add_figure_safe(rep, _coverage_fig, "coverage figure")

    em = _table(per_sample, samples, ERROR)
    rep.add_section("Error")
    rep.add_table(em)
    tables["error"] = _with_metric(em)
    write_frames(args.h5_output, tables)

    # appendix: the first sample's raw metric tables, a file each
    first = per_sample[samples[0]]
    rep.add_section("Appendix — raw metrics")
    files = np.asarray(first["File"], dtype=object)
    for fname in dict.fromkeys(files.tolist()):
        rep.add_text(str(fname))
        rep.add_table(first.take(np.flatnonzero(files == fname)[:60]))

    if args.html_output:
        rep.write(args.html_output)
    log.info("QC report for %d samples (figures skipped %d) -> %s", len(samples), rep.figures_skipped,
             args.h5_output)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
