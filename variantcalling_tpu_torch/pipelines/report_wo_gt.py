"""report_wo_gt — HTML report over the no-ground-truth statistics h5.

Counterpart of ``variantcalling_tpu/pipelines/report_wo_gt.py``, without
pandas, with the same arguments (no device program runs: no
``--backend``): every section that ``run_no_gt_report full_analysis``
wrote (callable size, the indel tables by hmer length, the AF histogram,
the SNP 96-motif, ID83 and DBS78 spectra, VariantEval tables, signature
exposures) as a table of its first 120 rows, in the reference's order,
with the reference's figures drawn through ``reports/html.add_figure_safe``
where matplotlib imports, and skipped and counted where it does not.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch.reports.html import HtmlReport, add_figure_safe
from variantcalling_tpu_torch.utils.h5_utils import Frame, list_keys, read_hdf

log = logging.getLogger(__name__)

SECTION_TITLES = {
    "callable_size": "Callable region size",
    "variants_statistics": "Variants statistics",
    "ins_del_hete": "Heterozygous indels by hmer length",
    "ins_del_homo": "Homozygous indels by hmer length",
    "af_hist": "Allele-frequency histogram",
    "af_scatter": "Allele frequency along the genome / vs depth",
    "snp_motifs": "SNP 96-motif spectrum",
    "id83_channels": "Indel ID83 channel spectrum",
    "dbs78_channels": "Doublet DBS78 channel spectrum",
    "signature_exposures": "Mutational signature exposures",
}


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="report_wo_gt", description=run.__doc__)
    ap.add_argument("--input_h5", required=True, help="run_no_gt_report output h5")
    ap.add_argument("--html_output", required=True)
    ap.add_argument("--sample_name", default="NA")
    return ap.parse_args(argv)


# SBS96 class colors (the standard COSMIC palette order)
_SBS_CLASS_COLORS = {
    "C>A": "#03bcee", "C>G": "#010101", "C>T": "#e32926",
    "T>A": "#cac9c9", "T>C": "#a1ce63", "T>G": "#ebc6c4",
}

# ID83 group colors keyed on the SigProfiler label prefix: 1-bp indels by
# folded base, longer indels by repeat class, microhomology deletions
_ID83_GROUP_COLORS = {
    "1:Del:C": "#fdbe6f", "1:Del:T": "#ff8001", "1:Ins:C": "#b0dd8b",
    "1:Ins:T": "#36a12e", "Del:R": "#fca8a5", "Ins:R": "#aec7e8",
    "Del:M": "#b9a2ca",
}


def _id83_color(label: str) -> str:
    parts = str(label).split(":")
    if len(parts) != 4:
        return "#888888"
    ln, kind, cls = parts[0], parts[1], parts[2]
    if ln == "1":
        return _ID83_GROUP_COLORS.get(f"1:{kind}:{cls}", "#888888")
    if cls == "M":
        return _ID83_GROUP_COLORS["Del:M"]
    return _ID83_GROUP_COLORS.get(f"{kind}:R", "#888888")


# DBS78 ref-doublet group colors (10 canonical refs, COSMIC palette order)
_DBS_REF_COLORS = {
    "AC": "#03bcee", "AT": "#0266cc", "CC": "#a1ce63", "CG": "#016501",
    "CT": "#fd9898", "GC": "#e32926", "TA": "#fcc9b4", "TC": "#fd8001",
    "TG": "#cb98fd", "TT": "#4c0199",
}


def numeric_columns(df: Frame) -> list[str]:
    """``df.select_dtypes(include=[np.number])``: the int, uint and float columns (not bool)."""
    return [c for c in df.columns if np.asarray(df[c]).dtype.kind in "iuf"]


def _bars(plt, series: dict[str, np.ndarray], labels: list[str], figsize, legend: bool):
    """Grouped bars of ``series`` over ``labels``: ``DataFrame.plot.bar``'s figure."""
    fig, ax = plt.subplots(figsize=figsize)
    n = max(len(series), 1)
    x = np.arange(len(labels))
    for k, (name, vals) in enumerate(series.items()):
        ax.bar(x + (k - (n - 1) / 2) * 0.5 / n, np.asarray(vals, dtype=float), width=0.5 / n, label=name)
    ax.set_xticks(x)
    ax.set_xticklabels(labels, rotation=90)
    if legend:
        ax.legend()
    return fig, ax


def _index_labels(df: Frame) -> list[str]:
    index = range(len(df)) if df.index is None else df.index
    return [str(v) for v in (index.tolist() if isinstance(index, np.ndarray) else list(index))]


def _figure_for(plt, key: str, df: Frame):
    """The reference's figure for a known section (None: a table only)."""
    num = numeric_columns(df)
    if key == "af_hist" and len(df):
        if not num:
            raise TypeError("no numeric data to plot")
        fig, ax = _bars(plt, {c: df[c] for c in num}, _index_labels(df), (8, 3), len(num) > 1)
        ax.set_xlabel("Allele frequency bin")
        ax.set_ylabel("# variants")
        return fig
    if key == "snp_motifs" and len(df) >= 96:
        fig, ax = plt.subplots(figsize=(14, 3))
        counts = np.asarray(df[num[0]]) if num else np.zeros(len(df))
        first = df.columns[0]
        labels = [str(v) for v in np.asarray(df[first]).tolist()] if first not in num else _index_labels(df)
        colors = []
        for lab in labels:
            cls = next((c for c in _SBS_CLASS_COLORS if c in lab), None)
            colors.append(_SBS_CLASS_COLORS.get(cls, "#888888"))
        ax.bar(np.arange(len(counts)), counts, color=colors, width=0.8)
        ax.set_xticks(np.arange(0, len(counts), 16))
        ax.set_xlabel("96 trinucleotide channels")
        ax.set_ylabel("# SNVs")
        return fig
    if key in ("id83_channels", "dbs78_channels") and len(df) and "channel" in df:
        if not num:
            raise IndexError("no numeric column")
        counts = np.asarray(df[num[0]])
        labels = [str(v) for v in np.asarray(df["channel"]).tolist()]
        colors = ([_id83_color(lab) for lab in labels] if key == "id83_channels"
                  else [_DBS_REF_COLORS.get(lab.split(">")[0], "#888888") for lab in labels])
        fig, ax = plt.subplots(figsize=(14, 3))
        ax.bar(np.arange(len(counts)), counts, color=colors, width=0.8)
        step = 6 if key == "id83_channels" else 9
        ax.set_xticks(np.arange(0, len(counts), step))
        ax.set_xticklabels(labels[::step], fontsize=6, rotation=90)
        ax.set_xlabel("83 COSMIC indel channels" if key == "id83_channels" else "78 COSMIC doublet channels")
        ax.set_ylabel("# indels" if key == "id83_channels" else "# doublets")
        return fig
    if key in ("ins_del_hete", "ins_del_homo") and len(df):
        if not num:
            raise TypeError("no numeric data to plot")
        cols = [c for c in num if c != "hmer_len"]
        labels = [str(v) for v in np.asarray(df["hmer_len"]).tolist()] if "hmer_len" in num else _index_labels(df)
        fig, ax = _bars(plt, {c: df[c] for c in cols}, labels, (9, 3), True)
        ax.set_xlabel("hmer length")
        ax.set_ylabel("# indels")
        ax.legend(fontsize=8)
        return fig
    if key == "af_scatter" and "af" in df and "dp" in df and len(df):
        # AF along the genome, and AF against depth
        fig, axs = plt.subplots(1, 2, figsize=(13, 3))
        _, chrom_idx = np.unique(np.asarray(df["chrom"]).astype(str), return_inverse=True)
        axs[0].scatter(np.arange(len(df)), df["af"], s=2, c=chrom_idx, cmap="tab20", alpha=0.5)
        axs[0].set_xlabel("variant rank along genome (color = contig)")
        axs[0].set_ylabel("allele frequency")
        axs[1].scatter(df["dp"], df["af"], s=2, alpha=0.4)
        axs[1].set_xlabel("depth")
        axs[1].set_ylabel("allele frequency")
        return fig
    if key == "signature_exposures" and len(df):
        if not num:
            raise IndexError("no numeric column")
        fig, _ = _bars(plt, {num[0]: df[num[0]]}, _index_labels(df), (8, 3), False)
        fig.axes[0].set_ylabel("Exposure")
        return fig
    return None


def run(argv) -> int:
    """Render the no-GT report HTML (tables + notebook-parity figures)."""
    args = parse_args(argv)
    rep = HtmlReport(f"Variant Report (no ground truth) — {args.sample_name}")
    rep.add_params({"input": args.input_h5, "sample": args.sample_name})
    n_sections = 0
    keys = list_keys(args.input_h5)
    ordered = [k for k in SECTION_TITLES if k in keys] + sorted(k for k in keys if k not in SECTION_TITLES)
    for key in ordered:
        df = read_hdf(args.input_h5, key=key)
        rep.add_section(SECTION_TITLES.get(key, key.replace("_", " ")))
        add_figure_safe(rep, lambda plt, k=key, d=df: _figure_for(plt, k, d), f"figure for {key}")
        if key == "af_hist" and len(df) > 25:
            # compact: the non-empty bins only
            num = numeric_columns(df)
            sums = np.nansum(np.stack([np.asarray(df[c], dtype=float) for c in num], axis=1), axis=1) if num \
                else np.zeros(len(df))
            df = df.take(sums > 0)
        if key == "af_scatter":  # thousands of points: the figure only
            n_sections += 1
            continue
        rep.add_table(df.take(np.arange(min(len(df), 120))))
        n_sections += 1
    rep.write(args.html_output)
    log.info("%d sections, figures skipped %d -> %s", n_sections, rep.figures_skipped, args.html_output)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
