"""create_sv_report — SV accuracy report from sv_stats_collect results.

Counterpart of ``variantcalling_tpu/pipelines/create_sv_report.py`` without
pandas, with the same arguments. It reads the results pickle through
``utils/pandas_pickle``: the port's own (pandas constructor calls) and the
reference's (pandas 3's layout with Arrow strings). It writes the h5 keys
``parameters``, ``type_counts``, ``length_counts``, ``length_by_type_counts``,
``concordance``, ``recall_per_type``, ``recall_per_length_and_type`` and
``fp_counts_per_length_and_type`` as the reference does (``astype(str)``
texts, the pivot's string order of the length labels,
``fillna(0).astype(int)``), and the HTML over ``reports/html``. The six
figures are drawn where matplotlib imports, else skipped and counted. No
device program runs: the tool takes no ``--backend``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from variantcalling_tpu_torch.reports.html import HtmlReport, add_figure_safe
from variantcalling_tpu_torch.utils import pandas_pickle as pp
from variantcalling_tpu_torch.utils.frame_ops import astype_str, sorted_codes
from variantcalling_tpu_torch.utils.h5_utils import Frame, object_column, write_hdf

log = logging.getLogger(__name__)

SV_TYPE_ORDER = ["CNV", "DEL", "INS", "DUP", "BND"]  # notebook cell 19


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="create_sv_report", description=run.__doc__)
    ap.add_argument("--statistics_file", required=True, help="sv_stats_collect pickle")
    ap.add_argument("--run_id", default="NA")
    ap.add_argument("--pipeline_version", default="NA")
    ap.add_argument("--reference_version", default="hg38")
    ap.add_argument("--truth_sample_name", default="NA")
    ap.add_argument("--h5_output", default="sv_report.h5")
    ap.add_argument("--html_output", default=None)
    ap.add_argument("--plot_dir", default=None, help="directory for figure PNGs")
    return ap.parse_args(argv)


def _plots_dir(args):
    d = args.plot_dir
    if d is None and args.html_output:
        d = os.path.splitext(args.html_output)[0] + "_figs"
    if d:
        os.makedirs(d, exist_ok=True)
    return d


def _figure(rep: HtmlReport, plots: str | None, name: str, draw) -> None:
    """``draw(plt)`` embedded in the HTML and saved as ``plots/name``; skipped and counted without matplotlib."""

    def build(plt):
        fig = draw(plt)
        if plots:
            fig.savefig(os.path.join(plots, name), dpi=120, bbox_inches="tight")
        return fig

    add_figure_safe(rep, build, name)


def _texts(values) -> np.ndarray:
    """``Index.astype(str)`` of labels."""
    return object_column([str(v) for v in np.asarray(values, dtype=object).tolist()])


def _row_frame(series: pp.Series, index_text: str) -> tuple[Frame, dict]:
    """``pd.DataFrame(series).T``: one row named by the Series' name, a column a label."""
    labels = [str(v) for v in series.index.values.tolist()]
    return Frame({lab: series.values[i:i + 1] for i, lab in enumerate(labels)}, object_column([index_text])), \
        {"columns_name": series.index.name}


def _reset(frame: Frame, index_name: str = "index") -> Frame:
    """``reset_index()`` of a frame with an array index."""
    return Frame({index_name: object_column(np.asarray(frame.index).tolist()), **frame.data})


def _index_columns(index: pp.Labels | pp.MultiLabels, keep: np.ndarray) -> dict:
    """The index levels of the rows ``keep`` as columns (``reset_index()``), categoricals as their labels."""
    levels = index.levels if isinstance(index, pp.MultiLabels) else [index]
    return {(lv.name if lv.name is not None else f"level_{i}" if len(levels) > 1 else "index"):
            object_column(lv.values[keep].tolist()) for i, lv in enumerate(levels)}


def _length_mask(conc: pp.Table, overall: bool) -> np.ndarray | None:
    idx = conc.index
    if isinstance(idx, pp.MultiLabels) and "SV length" in idx.names:
        vals = idx.levels[idx.names.index("SV length")].values
        return (vals == "") if overall else (vals != "")
    return None


def _float_lists(cell) -> np.ndarray:
    return np.atleast_1d(np.asarray(cell, dtype=np.float64))


def _pivot(rows, cols, vals) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``pivot_table(index=rows, columns=cols, values=vals, aggfunc="sum").fillna(0).astype(int)``:
    (row labels, column labels, int64 grid), both sorted as strings."""
    r_uniq, r_code = sorted_codes(object_column(rows))
    c_uniq, c_code = sorted_codes(object_column(cols))
    grid = np.zeros((len(r_uniq), len(c_uniq)), dtype=np.float64)
    np.add.at(grid, (r_code, c_code), np.asarray(vals, dtype=np.float64))
    return r_uniq, c_uniq, grid.astype(np.int64)


def run(argv) -> int:
    """Generate the SV report (h5 sections + figures + optional HTML)."""
    args = parse_args(argv)
    with open(args.statistics_file, "rb") as fh:
        try:
            results = pp.loads(fh.read())
        except pp.UnsupportedPickle as e:
            log.error("%s: %s", args.statistics_file, e)
            return 2
    sv_stats = results.get("sv_stats", results if isinstance(results, dict) else {})
    concordance = results.get("concordance")
    fp_stats = results.get("fp_stats")
    plots = _plots_dir(args)

    rep = HtmlReport("SV/CNV Calling report")
    params = {
        "statistics_file": os.path.basename(args.statistics_file),
        "run_id": args.run_id,
        "reference_version": args.reference_version,
        "pipeline_version": args.pipeline_version,
        "truth_sample_name": args.truth_sample_name,
        "h5outfile": args.h5_output,
    }
    rep.add_params(params)
    write_hdf(Frame({"index": object_column(list(params)), "value": object_column([str(v) for v in params.values()])}),
              args.h5_output, key="parameters", mode="w")

    # --- general statistics (notebook cells 9-20) -------------------------
    if "type_counts" in sv_stats:
        tc, names = _row_frame(sv_stats["type_counts"], str(sv_stats["type_counts"].name))
        rep.add_section("SV type distribution")
        rep.add_table(tc, **names)
        write_hdf(_reset(tc), args.h5_output, key="type_counts", mode="a")
        counts, labels = [tc[c][0] for c in tc.columns], list(tc.columns)

        def pie(plt):
            fig, ax = plt.subplots(subplot_kw={"aspect": "equal"})
            ax.pie(counts, labels=labels, autopct="%1.1f%%", startangle=90, pctdistance=0.9, labeldistance=1.1)
            return fig

        _figure(rep, plots, "sv_type_pie.png", pie)

    if "length_counts" in sv_stats:
        lc, names = _row_frame(sv_stats["length_counts"], str(sv_stats["length_counts"].name))
        rep.add_section("SV length distribution")
        rep.add_table(lc, **names)
        write_hdf(_reset(lc), args.h5_output, key="length_counts", mode="a")
        lengths, counts = list(lc.columns), [lc[c][0] for c in lc.columns]

        def length_bar(plt):
            fig, ax = plt.subplots()
            ax.bar(range(len(counts)), counts)
            ax.set_xticks(range(len(counts)), lengths, rotation=90)
            ax.set_xlabel("Length")
            ax.set_ylabel("# Calls")
            ax.set_yscale("log")
            return fig

        _figure(rep, plots, "sv_length_bar.png", length_bar)

    if "length_by_type_counts" in sv_stats:
        lbt = sv_stats["length_by_type_counts"]
        if isinstance(lbt, pp.Series):
            lbt = pp.Table({lbt.name: lbt.values}, lbt.index)
        rows, cols = lbt.index, lbt.columns
        row_labels, col_labels, col_name = list(rows.values.tolist()), list(cols), lbt.columns_name
        grid = [np.asarray(cols[c]) for c in col_labels]  # a column a list of row values
        if any(t in row_labels for t in SV_TYPE_ORDER):  # the notebook's transpose: length on the index
            grid = [np.array([g[i] for g in grid]) for i in range(len(row_labels))]
            row_labels, col_labels = col_labels, row_labels
            row_name, col_name = col_name, rows.name
        else:
            row_name = rows.name
        order = [t for t in SV_TYPE_ORDER if t in col_labels] + [t for t in col_labels if t not in SV_TYPE_ORDER]
        by_label = dict(zip(col_labels, grid))
        table = Frame({c: by_label[c] for c in order}, object_column(row_labels))
        rep.add_section("Length and type distribution")
        rep.add_table(table, index_name=row_name, columns_name=col_name)
        save = Frame({"index": _texts(row_labels), **{str(c): by_label[c] for c in order}})
        write_hdf(save, args.h5_output, key="length_by_type_counts", mode="a")

        def by_type_bars(plt):
            fig, ax = plt.subplots(figsize=(8, 6))
            width = 0.8 / max(len(order), 1)
            for k, c in enumerate(order):
                ax.bar(np.arange(len(row_labels)) + k * width, by_label[c], width, label=str(c))
            ax.set_xticks(np.arange(len(row_labels)), [str(r) for r in row_labels], rotation=90)
            ax.set_xlabel("Length")
            ax.set_ylabel("# Calls")
            ax.set_yscale("log")
            ax.legend(title="SV Type", loc="upper right", fontsize=10)
            return fig

        _figure(rep, plots, "sv_length_by_type.png", by_type_bars)

    # --- concordance (notebook cells 21-27) -------------------------------
    if concordance is not None and len(concordance):
        conc = concordance
        rep.add_section("Concordance evaluation")
        roc_cols = [c for c in ("precision roc", "recall roc", "thresholds") if c in conc.columns]
        overall_mask = _length_mask(conc, overall=True)
        rows_overall = np.ones(len(conc), dtype=bool) if overall_mask is None else overall_mask
        value_cols = [c for c in conc.columns if c not in roc_cols]
        keep = [c for c in ("TP_base", "TP_calls", "FP", "FN", "Recall", "Precision", "F1") if c in value_cols]
        if keep:
            value_cols = keep
        values_df = Frame({**_index_columns(conc.index, rows_overall),
                           **{c: np.asarray(conc.columns[c])[rows_overall] for c in value_cols}})
        rep.add_table(values_df)
        as_text = Frame({c: astype_str(values_df[c]) for c in values_df.columns})
        write_hdf(as_text, args.h5_output, key="concordance", mode="a")
        # notebook cell 23 writes the same overall table under recall_per_type
        write_hdf(as_text, args.h5_output, key="recall_per_type", mode="a")

        # ROC grid per overall category
        if roc_cols and rows_overall.any():
            positions = np.flatnonzero(rows_overall)
            levels = conc.index.levels if isinstance(conc.index, pp.MultiLabels) else [conc.index]
            rocs = [(levels[0].values[i], conc.columns.get("recall roc", np.empty(0, object))[i],
                     conc.columns["precision roc"][i])
                    for i in positions if "precision roc" in conc.columns
                    and len(np.atleast_1d(conc.columns["precision roc"][i]))]
            if rocs:
                def roc_grid(plt):
                    fig, axs = plt.subplots(1, len(rocs), figsize=(3 * len(rocs), 3), squeeze=False)
                    for ax, (title, rec, prec) in zip(axs[0], rocs):
                        ax.plot(_float_lists(rec), _float_lists(prec))
                        ax.set_title(str(title))
                        ax.set_xlabel("Recall")
                        ax.set_xlim(0, 0.8)
                        ax.set_ylim(0.6, 1)
                    axs[0][0].set_ylabel("Precision")
                    return fig

                _figure(rep, plots, "sv_pr_roc.png", roc_grid)

        # recall per length and type (length-binned rows)
        binned_mask = _length_mask(conc, overall=False)
        if binned_mask is not None:
            keep = [c for c in ("TP_base", "TP_calls", "FN", "Recall") if c in conc.columns]
            if binned_mask.any() and keep:
                rec = {c: np.asarray(conc.columns[c])[binned_mask] for c in keep}
                for c in ("TP_base", "TP_calls", "FN"):
                    if c in rec:
                        rec[c] = rec[c].astype(float).astype(int)
                shown = Frame({**_index_columns(conc.index, binned_mask), **rec})
                rep.add_section("Recall per variant length and type")
                rep.add_table(shown)
                out = Frame({str(c).replace(" ", "_"): shown[c] for c in shown.columns})
                write_hdf(Frame({c: astype_str(out[c]) for c in out.columns}), args.h5_output,
                          key="recall_per_length_and_type", mode="a")
                if {"SV_length", "SV_type", "Recall"} <= set(out.columns):
                    lens, types, _ = _pivot(out["SV_length"], out["SV_type"], np.zeros(len(out)))
                    recall = {(a, b): float(v) for a, b, v in zip(out["SV_length"].tolist(), out["SV_type"].tolist(),
                                                                   np.asarray(out["Recall"], dtype=float).tolist())}

                    def recall_bars(plt):
                        fig, ax = plt.subplots(figsize=(8, 4))
                        width = 0.8 / max(len(types), 1)
                        for k, t in enumerate(types.tolist()):
                            ax.bar(np.arange(len(lens)) + k * width,
                                   [recall.get((ln, t), np.nan) for ln in lens.tolist()], width, label=str(t))
                        ax.set_xticks(np.arange(len(lens)), [str(x) for x in lens.tolist()], rotation=90)
                        ax.set_ylabel("Recall")
                        ax.legend()
                        return fig

                    _figure(rep, plots, "sv_recall_per_length.png", recall_bars)

    if fp_stats is not None and len(fp_stats):
        rep.add_section("False positives per variant length and type")
        all_rows = np.ones(len(fp_stats), dtype=bool)
        cols = _index_columns(fp_stats.index, all_rows)
        renamed = {"svtype": "SV type", "binned_svlens": "SV length"}
        fp_df = Frame({**{renamed.get(k, k): v for k, v in cols.items()}, "FP count": fp_stats.values})
        rep.add_table(fp_df)
        if {"SV length", "SV type", "FP count"} <= set(fp_df.columns):
            lens, types, grid = _pivot(fp_df["SV length"], fp_df["SV type"], fp_df["FP count"])
            piv = Frame({"SV length": object_column(lens.tolist()),
                         **{str(t): astype_str(grid[:, k]) for k, t in enumerate(types.tolist())}})
            write_hdf(piv, args.h5_output, key="fp_counts_per_length_and_type", mode="a")

            def fp_bars(plt):
                fig, ax = plt.subplots(figsize=(10, 5))
                width = 0.8 / max(len(types), 1)
                for k, t in enumerate(types.tolist()):
                    ax.bar(np.arange(len(lens)) + k * width, grid[:, k], width, label=str(t))
                ax.set_xticks(np.arange(len(lens)), [str(x) for x in lens.tolist()], rotation=90)
                ax.legend(title="SV Type", bbox_to_anchor=(1.05, 1), loc="upper left")
                return fig

            _figure(rep, plots, "sv_fp_per_length.png", fp_bars)
        else:
            write_hdf(fp_df, args.h5_output, key="fp_counts_per_length_and_type", mode="a")

    if args.html_output:
        rep.write(args.html_output)
    log.info("SV report -> %s%s (figures skipped %d)", args.h5_output,
             f" + {args.html_output}" if args.html_output else "", rep.figures_skipped)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
