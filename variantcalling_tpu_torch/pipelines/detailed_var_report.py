"""detailed_var_report — stratified germline accuracy report.

Counterpart of ``variantcalling_tpu/pipelines/detailed_var_report.py``,
without pandas: the same arguments plus ``--backend gpu|cpu`` (default
``gpu``: the card, exit 2 without one), the same artifacts:

- the ``detailed_vars`` long frame (+ csv): one row per
  (Region, Category, Variant) cell over regions (All/annotation tracks),
  GC bins (0-20/20-80/80-100), coverage bins (0-20/20-40/40-100) and the
  notebook's variant categories (All/SNP/Indel/non-hmer/hmer bins), each
  carrying # pos/neg, avg coverage, max recall, static precision/recall/
  F1 at the shipped thresholds, and the re-optimized F1 from a
  tree_score threshold sweep;
- the colored performance-matrix figures (genome + exome, F1-stat and
  F1-opt), drawn through ``reports/html.add_figure_safe`` where matplotlib
  imports and otherwise skipped and counted (``figures_skipped``);
- per-track inside/outside accuracy tables
  (``concordance_utils.calc_accuracy_metrics``, whose tally runs on the
  run's device).

The frame is the port's :class:`~variantcalling_tpu_torch.utils.h5_utils.Frame`
(``reports/report_data_loader``); each pandas step of the reference is
replayed on numpy columns with its semantics (``astype(str)`` comparisons,
``to_numeric(errors="coerce").fillna``, boolean row selection).
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch.concordance.concordance_utils import calc_accuracy_metrics
from variantcalling_tpu_torch.reports.html import HtmlReport, add_figure_safe
from variantcalling_tpu_torch.utils.frame_ops import to_numeric
from variantcalling_tpu_torch.utils.h5_utils import Frame, object_column, write_hdf
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)

ANNOTATION_PREFIXES = ("LCR", "exome", "mappability", "ug_hcr", "callable")
VAR_CATS = ["All", "SNP", "Indel", "non-hmer", "hmer 0-1", "hmer 2-4",
            "hmer 5-8", "hmer 9-10", "hmer 11+"]
GC_BINS = [(0.0, 0.2), (0.2, 0.8), (0.8, 1.01)]
CVG_BINS = [(0, 20), (20, 40), (40, 100)]
#: the columns of the ``detailed_vars`` frame, in order
DETAIL_COLUMNS = ["Region", "Category", "Variant", "# pos", "# neg", "avg cvg", "max recall", "recall",
                  "precision", "F1-stat", "F1-opt"]


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="detailed_var_report", description=run.__doc__)
    ap.add_argument("--h5_concordance_file", required=True)
    ap.add_argument("--h5_output", default="detailed_var_report.h5")
    ap.add_argument("--csv_output", default=None, help="detailed_vars csv (config DetailedReport.csv)")
    ap.add_argument("--html_output", required=False, default=None)
    ap.add_argument("--reference_version", default="hg38")
    ap.add_argument("--exome_column_name", default="exome.twist")
    ap.add_argument("--coverage_column", default="well_mapped_coverage")
    ap.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                    help="device of the accuracy tallies (gpu: the card, exit 2 without one)")
    return ap.parse_args(argv)


def _numeric0(col: np.ndarray) -> np.ndarray:
    """``pd.to_numeric(col, errors="coerce").fillna(0)``."""
    out = to_numeric(np.asarray(col), coerce=True)
    return np.where(np.isnan(out), 0, out) if out.dtype.kind == "f" else out


def _texts(col) -> np.ndarray:
    """``Series.astype(str)`` for an equality test: a missing value never
    equals a class name, whatever text it takes."""
    return np.asarray(col).astype(str)


def _indel_len(d: Frame) -> np.ndarray:
    if "indel_length" not in d:
        return np.zeros(len(d))
    return _numeric0(d["indel_length"])


def _var_mask(d: Frame, cat: str) -> np.ndarray:
    indel = np.asarray(d["indel"]).astype(bool)
    # the loader renames hmer_indel_length -> hmer_length; accept either
    hmer_col = "hmer_length" if "hmer_length" in d else "hmer_indel_length"
    hmer = _numeric0(d[hmer_col]) if hmer_col in d else np.zeros(len(d))
    if cat == "All":
        return np.ones(len(d), dtype=bool)
    if cat == "SNP":
        return ~indel
    if cat == "Indel":
        return indel
    if cat == "non-hmer":
        return indel & (hmer == 0) & (_indel_len(d) > 1)
    if cat == "hmer 0-1":
        return indel & (hmer <= 1) & ~((hmer == 0) & (_indel_len(d) > 1))
    if cat == "hmer 2-4":
        return indel & (hmer >= 2) & (hmer <= 4)
    if cat == "hmer 5-8":
        return indel & (hmer >= 5) & (hmer <= 8)
    if cat == "hmer 9-10":
        return indel & (hmer >= 9) & (hmer <= 10)
    if cat == "hmer 11+":
        return indel & (hmer >= 11)
    raise ValueError(cat)


def _perf(classify: np.ndarray, filters: np.ndarray, score: np.ndarray | None, cvg) -> dict:
    """Static + threshold-reoptimized performance of one stratum cell, over
    the cell's class texts, FILTER texts and tree scores."""
    label = np.where(classify == "fp", 0, 1)
    n_pos = int(label.sum())
    n_neg = int(len(classify) - n_pos)
    if len(classify) == 0 or n_pos == 0:
        return {"# pos": n_pos, "# neg": n_neg, "avg cvg": float("nan"),
                "max recall": np.nan, "recall": np.nan, "precision": np.nan,
                "F1-stat": np.nan, "F1-opt": np.nan}
    is_fn = classify == "fn"
    passes = filters == "PASS"
    tp = int(((label == 1) & ~is_fn & passes).sum())
    fp = int(((label == 0) & passes).sum())
    fn = int((is_fn | ((label == 1) & ~passes)).sum())
    recall = tp / (tp + fn) if tp + fn else np.nan
    precision = tp / (tp + fp) if tp + fp else np.nan
    f1 = tp / (tp + 0.5 * fn + 0.5 * fp) if tp + fn + fp else np.nan
    max_recall = 1.0 - float(is_fn.sum()) / n_pos

    # threshold sweep over tree_score: at each cut, calls below it flip to
    # negatives — vectorized cumulative counts
    if score is None:
        score = np.zeros(len(classify))  # no score: the sweep is one point
    callable_mask = ~is_fn
    base_fn = int(is_fn.sum())
    order = np.argsort(score[callable_mask])
    lab = label[callable_mask][order]
    cum_pos_dropped = np.concatenate([[0], np.cumsum(lab)])
    cum_neg_dropped = np.concatenate([[0], np.cumsum(1 - lab)])
    total_pos = lab.sum()
    total_neg = len(lab) - total_pos
    tp_k = total_pos - cum_pos_dropped
    fp_k = total_neg - cum_neg_dropped
    fn_k = base_fn + cum_pos_dropped
    with np.errstate(invalid="ignore", divide="ignore"):
        f1_k = tp_k / (tp_k + 0.5 * fn_k + 0.5 * fp_k)
    # only cuts between distinct scores are thresholds that can be set
    s_sorted = score[callable_mask][order]
    realizable = np.ones(len(f1_k), dtype=bool)
    if len(s_sorted) > 1:
        realizable[1:-1] = s_sorted[1:] != s_sorted[:-1]
    f1_k = np.where(realizable, f1_k, np.nan)
    f1_opt = float(np.nanmax(f1_k)) if len(f1_k) and np.isfinite(f1_k).any() else np.nan

    has_cvg_vals = cvg is not None and len(cvg) and np.isfinite(cvg).any()
    return {"# pos": n_pos, "# neg": n_neg,
            "avg cvg": float(np.nanmean(cvg)) if has_cvg_vals else np.nan,
            "max recall": max_recall, "recall": recall, "precision": precision,
            "F1-stat": f1, "F1-opt": f1_opt}


def _bool_mask(vals) -> np.ndarray:
    """Annotation-column truthiness that survives h5 object-string round
    trips (``astype(bool)`` would map the string 'False' to True)."""
    vals = np.asarray(vals)
    if vals.dtype == object:
        return np.isin(vals.astype(str), ["True", "1", "1.0", "true"])
    return vals.astype(bool)


def build_detailed_vars(df: Frame, regions: list[str], classify_col: str, coverage_column: str) -> Frame:
    """All strata cells from boolean masks computed once on the whole frame
    and combined per cell."""
    rows = []
    classify = _texts(df[classify_col])
    filters = _texts(df["filter"])
    score = _numeric0(df["tree_score"]).astype(np.float64) if "tree_score" in df else None
    cvg_arr = to_numeric(np.asarray(df[coverage_column]), coerce=True) if coverage_column in df else None
    gc_arr = to_numeric(np.asarray(df["gc_content"]), coerce=True) if "gc_content" in df else None
    var_masks = {v: _var_mask(df, v) for v in VAR_CATS}
    region_masks = {"All": np.ones(len(df), dtype=bool)}
    for region in regions:
        if region.startswith("Non-"):
            region_masks[region] = ~_bool_mask(df[region[4:]])
        else:
            region_masks[region] = _bool_mask(df[region])

    def add(mask: np.ndarray, region: str, category: str, var: str):
        p = _perf(classify[mask], filters[mask], None if score is None else score[mask],
                  cvg_arr[mask] if cvg_arr is not None else None)
        rows.append({"Region": region, "Category": category, "Variant": var, **p})

    for region, rmask in region_masks.items():
        for var in VAR_CATS:
            m = rmask & var_masks[var]
            add(m, region, "All", var)
            if gc_arr is not None:
                for lo, hi in GC_BINS:
                    add(m & (gc_arr >= lo) & (gc_arr < hi), region,
                        f"GC {lo * 100:.0f}-{min(hi, 1) * 100:.0f}", var)
            if cvg_arr is not None:
                for lo, hi in CVG_BINS:
                    add(m & (cvg_arr >= lo) & (cvg_arr < hi), region, f"CVG {lo}-{hi}", var)
    cols = {}
    for name in DETAIL_COLUMNS:
        vals = [r[name] for r in rows]
        if name in ("Region", "Category", "Variant"):
            cols[name] = object_column(vals)
        elif name in ("# pos", "# neg"):
            cols[name] = np.asarray(vals, dtype=np.int64)
        else:
            cols[name] = np.asarray(vals, dtype=np.float64)
    return Frame(cols, range(len(rows)))


def _matrix_figure(plt, out: Frame, rows: list[str], metric: str, title: str):
    """Colored performance matrix (``plt``: matplotlib's pyplot, handed over
    by ``add_figure_safe``)."""
    region, category, variant = (np.asarray(out[c], dtype=object) for c in ("Region", "Category", "Variant"))

    def cell(r, var):
        sel = np.flatnonzero((((category == "All") & (region == r)) | ((category == r) & (region == "All")))
                             & (variant == var))
        if not len(sel):
            return "-", "white"
        v = out[metric][sel[0]]
        n = out["# pos"][sel[0]]
        cvg = out["avg cvg"][sel[0]]
        if not np.isfinite(v):
            return "-", "white"
        num = f"{int(n / 1000):d}k" if n > 1000 else f"{int(n):d}"
        cvg_s = f"{cvg:.1f}" if np.isfinite(cvg) else "-"
        color = "white" if n < 30 else plt.cm.RdYlGn(max(min((v - 0.8) / 0.2, 1.0), 0.0))
        return f"{v:.1%}\n({num},{cvg_s})", color

    present = [r for r in rows if r == "All" or ((region == r) | (category == r)).any()]
    tabl, tabcol = [], []
    for r in present:
        txts, cols = zip(*(cell(r, c) for c in VAR_CATS))
        tabl.append(list(txts))
        tabcol.append(list(cols))
    fig, ax = plt.subplots(figsize=(20, 1 + len(present)))
    ax.set_axis_off()
    table = ax.table(cellText=tabl, rowLabels=present, colLabels=VAR_CATS,
                     cellColours=tabcol, cellLoc="center", loc="upper left")
    table.set_fontsize(12)
    table.scale(1, 2.2)
    ax.set_title(title, fontsize=18)
    return fig


def _head(frame: Frame, n: int) -> Frame:
    return frame.take(np.arange(min(n, len(frame))))


def run(argv) -> int:
    """Generate the detailed (context-stratified) variant report."""
    args = parse_args(argv)
    try:
        device = device_mod.resolve(args.backend)
    except device_mod.DeviceUnavailable as e:
        log.error("%s", e)
        return 2
    from variantcalling_tpu_torch.reports.report_data_loader import ReportDataLoader

    with stage("ingest"):
        try:
            loader = ReportDataLoader(args.h5_concordance_file, args.reference_version, args.exome_column_name)
            df = loader.load_concordance_df()
        except KeyError:
            # frames without the genotype columns (gt_ultima/gt_ground_truth)
            # still stratify on classify/filter alone
            from variantcalling_tpu_torch.utils.h5_utils import read_hdf

            df = read_hdf(args.h5_concordance_file, key="all")
    classify_col = "classify_gt" if "classify_gt" in df else "classify"
    rep = HtmlReport("Detailed Variant Report")
    rep.add_params({"input": args.h5_concordance_file, "records": len(df), "classify_column": classify_col})

    ann_cols = [c for c in df.columns if any(str(c).startswith(p) for p in ANNOTATION_PREFIXES)]
    regions = []
    for c in ann_cols:
        regions += [str(c), f"Non-{c}"]

    with stage("strata"):
        detailed = build_detailed_vars(df, regions, classify_col, args.coverage_column)
    params_df = Frame({"value": object_column([str(args.h5_concordance_file), str(len(df))])},
                      object_column(["h5_concordance_file", "records"]))
    with stage("writes"):
        write_hdf(params_df, args.h5_output, key="det_parameters", mode="w")
        write_hdf(detailed, args.h5_output, key="detailed_vars", mode="a")
        if args.csv_output:
            detailed.to_csv(args.csv_output)

    rep.add_section("Summary performance — Genome")
    matrix_rows = ["All", "GC 0-20", "GC 20-80", "GC 80-100", "CVG 0-20",
                   "CVG 20-40", "CVG 40-100"] + regions
    for metric, title in (("F1-stat", "Genome — F1 (n,cvg)"),
                          ("F1-opt", "Genome — re-optimized F1 (n,cvg)")):
        add_figure_safe(rep, lambda plt, m=metric, t=title: _matrix_figure(plt, detailed, matrix_rows, m, t),
                        "performance matrix")

    exome_col = args.exome_column_name if args.exome_column_name in df else None
    if exome_col:
        rep.add_section("Summary performance — Exome")
        with stage("strata"):
            exome_detailed = build_detailed_vars(
                df.take(_bool_mask(df[exome_col])),
                [r for r in regions if not r.startswith(("Non-" + exome_col, exome_col))],
                classify_col, args.coverage_column)
        write_hdf(exome_detailed, args.h5_output, key="detailed_vars_exome", mode="a")
        for metric, title in (("max recall", "Exome — max recall (n,cvg)"),
                              ("F1-stat", "Exome — F1 (n,cvg)"),
                              ("F1-opt", "Exome — re-optimized F1 (n,cvg)")):
            add_figure_safe(rep, lambda plt, m=metric, t=title: _matrix_figure(plt, exome_detailed, matrix_rows,
                                                                                m, t), "exome matrix")

    # per-track inside/outside accuracy tables
    with stage("tracks"):
        for col in ann_cols:
            mask = _bool_mask(df[col])
            for label, m in ((f"inside {col}", mask), (f"outside {col}", ~mask)):
                if not m.any():
                    continue
                tab = calc_accuracy_metrics(df.take(m), "classify", ["HPOL_RUN"], device=device)
                key = label.replace(" ", "_").replace(".", "_").replace("-", "_")
                rep.add_section(f"Accuracy {label} ({int(m.sum())} records)")
                rep.add_table(tab)
                write_hdf(tab, args.h5_output, key=key, mode="a")

    rep.add_section("Detailed performance (all strata)")
    rep.add_table(_head(detailed, 1000))
    if args.html_output:
        rep.write(args.html_output)
    log.info("detailed report: %d strata rows, %d tracks, figures_skipped %d -> %s",
             len(detailed), len(ann_cols), rep.figures_skipped, args.h5_output)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
