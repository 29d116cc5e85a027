"""sv_stats_collect — SV size/type histograms and ground-truth concordance.

Counterpart of ``variantcalling_tpu/pipelines/sv_stats_collect.py``
without pandas: positional ``svcall_vcf output_file`` with
``--concordance_h5`` / ``--ignore_filter``; a pickled results dict with keys
``type_counts``, ``length_counts``, ``length_by_type_counts`` and, with a
concordance h5 (keys ``base``/``calls``), ``concordance`` and ``fp_stats``.
The frames are the port's (``utils/pandas_pickle``) and the pickle holds
them as pandas constructor calls, so pandas loads it to the reference's
objects: ``pd.cut(..., right=False)`` bins, ``value_counts`` orders (count
descending, ties in order of first appearance; a categorical in category
order), the ``groupby(...).size().unstack()`` table with CTX dropped, the
concordance frame's sorted column union, float64 cells and NaN, and
``fp_stats`` with every length bin of each type that has a false positive.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from variantcalling_tpu_torch.io.vcf import MISSING, read_vcf
from variantcalling_tpu_torch.utils import pandas_pickle as pp
from variantcalling_tpu_torch.utils.frame_ops import sorted_codes, value_counts
from variantcalling_tpu_torch.utils.h5_utils import object_column, read_hdf
from variantcalling_tpu_torch.utils.stats_utils import precision_recall_curve

SVBINS = [0, 100, 300, 500, 1000, 2000, 3000, 5000, 10000, 100000, 1000000, float("inf")]
SVLABELS = ["50-100", "100-300", "300-500", "0.5-1k", "1k-2k", "2k-3k", "3k-5k", "5k-10k", "10k-100k", "100k-1M", ">1M"]

MIN_CLASS_COUNTS_TO_OUTPUT = 20


def bin_lengths(svlen: np.ndarray) -> np.ndarray:
    """Each |length|'s bin of :data:`SVLABELS` as ``pd.cut(bins=SVBINS,
    right=False)`` gives it (``[lo, hi)``), -1 for NaN or past the last edge."""
    x = np.abs(np.asarray(svlen, dtype=np.float64))
    code = np.searchsorted(np.asarray(SVBINS), x, side="right") - 1
    code[np.isnan(x) | (code >= len(SVLABELS)) | (code < 0)] = -1
    return code


def _info_str(info, key: str) -> str:
    if info in (None, MISSING, ""):
        return ""
    for part in info.split(";"):
        if part.startswith(key + "="):
            return part.split("=", 1)[1]
    return ""


def _length_labels(name: str = "binned_svlens") -> pp.Labels:
    return pp.Labels(object_column(SVLABELS), name, list(SVLABELS), True)


def collect_size_type_histograms(svcall_vcf: str, ignore_filter: bool = False) -> dict:
    """Size and type histograms from an SV call VCF."""
    table = read_vcf(svcall_vcf, drop_format=True)
    svlen = table.info_field("SVLEN", dtype=np.float64, missing=np.nan)
    svtype = object_column([_info_str(s, "SVTYPE") for s in table.info])
    if not ignore_filter:
        keep = np.isin(np.asarray(table.filters, dtype=object), ["PASS", "", MISSING])
        svlen, svtype = svlen[keep], svtype[keep]
    codes = bin_lengths(np.where(np.isnan(svlen), 0.0, svlen))

    types, counts = value_counts(svtype)
    type_counts = pp.Series(counts, pp.str_labels(types, "svtype"), "count")
    binned = codes >= 0
    length_counts = pp.Series(np.bincount(codes[binned], minlength=len(SVLABELS)).astype(np.int64),
                              _length_labels(), "count")
    uniq, tcode = sorted_codes(svtype)
    grid = np.zeros((len(uniq), len(SVLABELS)), dtype=np.int64)
    np.add.at(grid, (tcode[binned], codes[binned]), 1)
    rows = [i for i, t in enumerate(uniq.tolist()) if t != "CTX"]
    by_type = pp.Table({label: grid[rows, j] for j, label in enumerate(SVLABELS)},
                       pp.str_labels([uniq[i] for i in rows], "svtype"), "binned_svlens")
    return {"type_counts": type_counts, "length_counts": length_counts, "length_by_type_counts": by_type}


#: the concordance Series' entries, in the order the reference builds them
_CONCORDANCE_KEYS = ("TP_base", "TP_calls", "FN", "FP", "Precision", "Recall", "F1")


def concordance_with_gt(base_labels: np.ndarray, call_labels: np.ndarray) -> dict:
    """TP/FN/FP and precision/recall/F1 from labeled base and call rows."""
    tp_base = int((base_labels == "TP").sum())
    tp_calls = int((call_labels == "TP").sum())
    fn = int((base_labels == "FN").sum())
    fp = int((call_labels == "FP").sum())
    precision = tp_calls / (tp_calls + fp) if (tp_calls + fp) > 0 else 0
    recall = tp_base / (tp_base + fn) if (tp_base + fn) > 0 else 0
    f1 = 2 * precision * recall / (precision + recall) if (precision + recall) > 0 else 0
    return dict(zip(_CONCORDANCE_KEYS, (tp_base, tp_calls, fn, fp, precision, recall, f1)))


def concordance_with_gt_roc(base: dict, calls: dict) -> tuple:
    """(precision, recall, thresholds) arrays; FN records fold into recall."""
    fn_rows = base["label"] == "FN"
    labels = np.concatenate([base["label"][fn_rows], calls["label"]])
    qual = np.concatenate([base["qual"][fn_rows], calls["qual"]]).astype(np.float64)
    fn_mask = labels == "FN"
    labels = np.where(fn_mask, "TP", labels).astype(object)
    precision, recall, thresholds, _ = precision_recall_curve(
        labels, np.where(np.isnan(qual), 0.0, qual), fn_mask, pos_label="TP",
        min_class_counts_to_output=MIN_CLASS_COUNTS_TO_OUTPUT)
    return precision, recall, thresholds


def _columns(path: str, key: str) -> dict:
    f = read_hdf(path, key=key)
    out = {c: np.asarray(f[c]) for c in ("svlen_int", "svtype", "label", "qual")}
    out["label"] = out["label"].astype(object)
    out["svtype"] = out["svtype"].astype(object)
    out["bin"] = bin_lengths(out["svlen_int"])
    return out


def _rows(cols: dict, keep: np.ndarray) -> dict:
    return {k: v[keep] for k, v in cols.items()}


def collect_sv_stats(svcall_vcf: str, concordance_h5: str | None = None, ignore_filter: bool = False):
    """(histograms, the concordance frame or None, fp_stats or None)."""
    sv_stats = collect_size_type_histograms(svcall_vcf, ignore_filter=ignore_filter)
    if concordance_h5 is None:
        return sv_stats, None, None
    base, calls = _columns(concordance_h5, "base"), _columns(concordance_h5, "calls")
    rows: list[tuple[str, str, dict]] = []
    rocs = []
    for svtype in ["ALL", "DEL", "DUP", "INV", "INS", "CTX"]:
        b = base if svtype == "ALL" else _rows(base, base["svtype"] == svtype)
        c = calls if svtype == "ALL" else _rows(calls, calls["svtype"] == svtype)
        rows.append((svtype, "", concordance_with_gt(b["label"], c["label"])))
        rocs.append(concordance_with_gt_roc(b, c))
    for svtype in ["ALL", "DEL", "INS"]:
        b = base if svtype == "ALL" else _rows(base, base["svtype"] == svtype)
        c = calls if svtype == "ALL" else _rows(calls, calls["svtype"] == svtype)
        for j, len_bin in enumerate(SVLABELS):
            s = concordance_with_gt(b["label"][b["bin"] == j], c["label"][c["bin"] == j])
            rows.append((svtype, len_bin, {k: s[k] for k in ("TP_base", "TP_calls", "FN", "Recall")}))
    n = len(rows)
    columns = {}
    for name in sorted(_CONCORDANCE_KEYS):  # the union of the Series' indexes, sorted
        columns[name] = np.array([r[2].get(name, np.nan) for r in rows], dtype=np.float64)
    for j, name in enumerate(("precision roc", "recall roc", "thresholds")):
        col = np.empty(n, dtype=object)
        col[:] = np.nan
        for i, roc in enumerate(rocs):
            col[i] = roc[j]
        columns[name] = col
    index = pp.MultiLabels([pp.str_labels([r[0] for r in rows], "SV type"),
                            pp.str_labels([r[1] for r in rows], "SV length")])
    concordance = pp.Table(columns, index)

    fp = _rows(calls, (calls["label"] == "FP") & (calls["bin"] >= 0))
    types, tcode = sorted_codes(fp["svtype"])
    grid = np.zeros((len(types), len(SVLABELS)), dtype=np.int64)
    np.add.at(grid, (tcode, fp["bin"]), 1)
    fp_index = pp.MultiLabels([pp.str_labels(np.repeat(np.asarray(types, dtype=object), len(SVLABELS)), "svtype"),
                               pp.Labels(object_column(SVLABELS * len(types)), "binned_svlens", list(SVLABELS), True)])
    fp_stats = pp.Series(grid.ravel(), fp_index, "count")
    return sv_stats, concordance, fp_stats


def run(argv: list[str]):
    ap = argparse.ArgumentParser(
        prog="sv_stats_collect",
        description="Collect SV statistics from a VCF file and (optionally) concordance H5.",
    )
    ap.add_argument("svcall_vcf", type=str, help="Path to the SV call VCF file.")
    ap.add_argument("output_file", type=str, help="Output PKL file.")
    ap.add_argument("--concordance_h5", type=str, default=None)
    ap.add_argument("--ignore_filter", action="store_true", default=False)
    args = ap.parse_args(argv)

    sv_stats, concordance, fp_stats = collect_sv_stats(args.svcall_vcf, args.concordance_h5, args.ignore_filter)
    results: dict = {}
    if concordance is not None:
        results["concordance"] = concordance
        results["fp_stats"] = fp_stats
    results.update(sv_stats)
    with open(args.output_file, "wb") as f:
        f.write(pp.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
