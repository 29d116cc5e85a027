"""Per-category accuracy tables, error-type counts and cumulative PR curves.

Counterpart of ``variantcalling_tpu/reports/report_utils.py`` without
pandas: a table is a :class:`~variantcalling_tpu_torch.utils.h5_utils.Frame`
over the concordance frame of ``reports/report_data_loader``. Each pandas
step is replayed on numpy columns with its semantics: the category masks,
the SEC refilter, ``pd.concat`` of one-row tables (an int64 column stays
int64 only where every row holds an int), the index of a row subset, the
``"a|b"`` names of the reference's two-level columns. The PR curve is a
stable argsort and three cumulative sums, as in the reference.

Figures (the PR grid, the indel panels) go through
``reports/html.add_figure_safe`` into PNG files under ``plot_dir``: drawn
where matplotlib imports, skipped and counted (``figures_skipped``) where it
does not.
"""

from __future__ import annotations

import math
import os
from configparser import ConfigParser

import numpy as np

from variantcalling_tpu_torch.reports.html import add_figure_safe
from variantcalling_tpu_torch.reports.report_data_loader import ErrorType
from variantcalling_tpu_torch.utils.frame_ops import to_numeric
from variantcalling_tpu_torch.utils.h5_utils import Frame, object_column, write_hdf
from variantcalling_tpu_torch.utils.stats_utils import get_f1, get_precision, get_recall


def parse_config(config_file: str):
    """VarReport INI section -> (parameters, param_names)."""
    parser = ConfigParser()
    parser.read(config_file)
    param_names = ["run_id", "pipeline_version", "h5_concordance_file"]
    parameters = {p: parser.get("VarReport", p) for p in param_names}
    parameters["verbosity"] = parser.get("VarReport", "verbosity", fallback="5")
    param_names.append("verbosity")
    parameters["reference_version"] = parser.get("VarReport", "reference_version", fallback="hg38")
    parameters["truth_sample_name"] = parser.get("VarReport", "truth_sample_name", fallback="NA")
    parameters["h5outfile"] = parser.get("VarReport", "h5_output", fallback="var_report.h5")
    parameters["trained_w_gt"] = parser.get("VarReport", "h5_model_file", fallback=None)
    if parameters["truth_sample_name"]:
        param_names.append("truth_sample_name")
    for opt in ("model_name_with_gt", "model_name_without_gt", "model_pkl_with_gt", "model_pkl_without_gt",
                "model_name"):
        val = parser.get("VarReport", opt, fallback=None)
        if val:
            parameters[opt] = val
            param_names.append(opt)
    return parameters, param_names


def as_bool(col) -> np.ndarray:
    """``Series.astype(bool)``: None and 0 False, NaN and any other value True."""
    col = np.asarray(col)
    if col.dtype == object:
        return np.array([v is not None and bool(v) for v in col.tolist()], dtype=bool)
    return col.astype(bool)


def is_missing(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and v != v)


def fill_missing(col, value) -> np.ndarray:
    """``Series.fillna(value)`` of a column of objects: None and NaN become ``value``."""
    col = np.asarray(col, dtype=object)
    out = col.copy()
    out[(col == None) | (col != col)] = value  # noqa: E711 - element-wise, as numpy compares objects
    return out


def filter_by_category(data: Frame, cat: str) -> Frame:
    """The rows of ``data`` in category ``cat`` (the reference's category algebra)."""
    indel = as_bool(data["indel"])
    hmer = np.asarray(data["hmer_length"])
    with np.errstate(invalid="ignore"):
        if cat == "SNP":
            return data.take(~indel)
        if cat == "Indel":
            return data.take(indel)
        if cat == "non-hmer Indel":
            return data.take(indel & (hmer == 0) & (np.asarray(data["indel_length"]) > 0))
        if cat == "non-hmer Indel w/o LCR":
            # the LCR column's name varies by reference build; without one the
            # category is plain non-hmer Indel
            lcr_cols = [c for c in data.columns if str(c).startswith("LCR")]
            lcr = as_bool(data[lcr_cols[0]]) if lcr_cols else np.zeros(len(data), dtype=bool)
            return data.take(indel & (hmer == 0) & (np.asarray(data["indel_length"]) > 0) & ~lcr)
        bands = {"hmer Indel <=4": (0, 4), "hmer Indel >4,<=8": (4, 8), "hmer Indel >8,<=10": (8, 10),
                 "hmer Indel >10,<=12": (10, 12), "hmer Indel >12,<=14": (12, 14), "hmer Indel >15,<=19": (14, 19)}
        if cat in bands:
            lo, hi = bands[cat]
            return data.take(indel & (hmer > lo) & (hmer <= hi))
        if cat == "hmer Indel >=20":
            return data.take(indel & (hmer >= 20))
        for i in range(1, 10):
            if cat == f"hmer Indel {i:d}":
                return data.take(indel & (hmer == i))
    raise RuntimeError(f"No such category: {cat}")


def has_sec(x) -> bool:
    return not is_missing(x) and "SEC" in str(x)


def rows_frame(rows: list[dict], index: list[str]) -> Frame:
    """``pd.concat`` of one-row frames ``pd.DataFrame(row, index=[name])``:
    a column is int64 where every row holds an int, else float64; the index
    the row names (an empty list: an empty frame)."""
    if not rows:
        return Frame({})
    cols = {}
    for name in rows[0]:
        vals = [r[name] for r in rows]
        ints = all(isinstance(v, (int, np.integer)) and not isinstance(v, bool) for v in vals)
        cols[name] = np.array(vals, dtype=np.int64 if ints else np.float64)
    return Frame(cols, object_column(index))


def two_level(frame: Frame, top: str = "whole genome") -> Frame:
    """``make_multi_index`` then ``_to_hdf``'s flattening: each column named ``"top|name"``."""
    return Frame({f"{top}|{c}": frame[c] for c in frame.columns}, frame.index)


class _FigureFile:
    """A figure sink for ``add_figure_safe`` that saves the figure as one PNG file."""

    def __init__(self, path: str):
        self.path = path
        self.figures_skipped = 0

    def add_figure(self, fig) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fig.savefig(self.path)


class ReportUtils:
    def __init__(self, verbosity, h5outfile: str, num_plots_in_row: int = 6, min_value: float = 0.2,
                 plot_dir: str | None = None):
        self.verbosity = int(verbosity)
        self.h5outfile = h5outfile
        self.min_value = min_value
        self.num_plots_in_row = num_plots_in_row
        self.score_name = "tree_score"
        self.plot_dir = plot_dir
        self.figures_skipped = 0

    # -- the analyses -------------------------------------------------------

    def basic_analysis(self, data: Frame, categories: list[str], out_key: str, out_key_sec: str | None = None):
        data_sec = None
        if out_key_sec is not None and "blacklst" in data:
            is_sec = np.array([has_sec(v) for v in np.asarray(data["blacklst"]).tolist()], dtype=bool)
            sec_df = Frame(dict(data.data), data.index)
            filt = np.asarray(data["filter"]).astype(object)
            filt[is_sec] = "SEC"
            sec_df["filter"] = filt
            cgt = np.asarray(data["classify_gt"]).astype(object)
            cgt[is_sec & (cgt == "tp")] = "fn"
            sec_df["classify_gt"] = cgt
            data_sec = sec_df.take(~(is_sec & (cgt == "fp")))

        opt_tab, opt_res, perf_curve, error_types_tab = self.get_performance(data, categories)

        if data_sec is not None:
            sec_opt_tab, _, _, sec_error_types_tab = self.get_performance(data_sec, categories)
            self._to_hdf(sec_opt_tab, out_key_sec)
            self._to_hdf(sec_error_types_tab, f"{out_key_sec}_error_types")

        if self.plot_dir and self.verbosity > 1:
            self.plot_performance(perf_curve, opt_res, list(categories), out_key)

        self._to_hdf(two_level(opt_tab), out_key)
        self._to_hdf(error_types_tab, f"{out_key}_error_types")
        return opt_tab, error_types_tab

    def homozygous_genotyping_analysis(self, d: Frame, categories: list[str], out_key: str) -> Frame:
        hom = {(1, 1), "1/1", "1|1"}
        gt = np.array([_hashable_in(v, hom) for v in np.asarray(d["gt_ground_truth"]).tolist()], dtype=bool)
        hmz = d.take(gt & (np.asarray(d["classify"]) != "fn"))
        opt_tab, _, _, _ = self.get_performance(hmz, categories)
        self._to_hdf(two_level(opt_tab), out_key)
        return opt_tab

    def base_stratification_analysis(self, d: Frame, categories: list[str], bases: tuple) -> Frame:
        ref = np.asarray(d["ref"])
        nuc = np.asarray(d["hmer_indel_nuc"])
        with np.errstate(invalid="ignore"):
            keep = (~as_bool(d["indel"]) & ((ref == bases[0]) | (ref == bases[1]))) | \
                ((np.asarray(d["hmer_length"]) > 0) & ((nuc == bases[0]) | (nuc == bases[1])))
        opt_tab, _, _, _ = self.get_performance(d.take(keep), categories)
        return Frame(opt_tab.data, object_column([f"{a} ({bases[0]}/{bases[1]})" for a in opt_tab.index]))

    def get_performance(self, data: Frame, categories: list[str]):
        perf_curve: dict[str, Frame] = {}
        opt_res: dict[str, dict] = {}
        opt_rows, err_rows = [], []
        for cat in categories:
            performance_dict, pr_curve = self.calc_performance(filter_by_category(data, cat))
            perf_curve[cat] = pr_curve
            opt_res[cat] = performance_dict
            opt_rows.append(self._general_performance_row(performance_dict))
            if self.verbosity > 1:
                err_rows.append(self._error_types_row(performance_dict))
        opt_tab = rows_frame(opt_rows, list(categories))
        error_types_table = rows_frame(err_rows, list(categories)) if err_rows else Frame({})
        return opt_tab, opt_res, perf_curve, error_types_table

    # -- the counts and the curve --------------------------------------------

    def calc_performance(self, d: Frame) -> tuple[dict, Frame]:
        score_name = self.score_name
        n = len(d)
        call = fill_missing(d["call"], "NA") if "call" in d else np.full(n, "NA", dtype=object)
        base = fill_missing(d["base"], "NA") if "base" in d else np.full(n, "NA", dtype=object)
        score_col = np.asarray(to_numeric(np.asarray(d[score_name]), coerce=True))
        score_raw = score_col.astype(np.float64)
        tp_mask = np.asarray(d["tp"], dtype=bool)
        fp_mask = np.asarray(d["fp"], dtype=bool)
        fn_mask = np.asarray(d["fn"], dtype=bool)

        # orient the score so that PASS scores high: the mean of the first 20 scored records on each side
        is_pass = np.asarray(d["filter"], dtype=object) == "PASS"
        scored = ~np.isnan(score_raw)
        # summed in the column's own float dtype (float32 in float32), as pandas' mean sums
        head = score_col if score_col.dtype.kind == "f" else score_raw
        score_pass = _head_mean(head[is_pass & scored], 20)
        score_not_pass = _head_mean(head[~is_pass & scored], 20)
        dir_switch = -1 if (not math.isnan(score_pass) and not math.isnan(score_not_pass)
                            and score_pass <= score_not_pass) else 1
        score = score_raw * dir_switch
        if np.any(np.isfinite(score)):
            score = score - np.nanmin(score)

        missing_candidates_index = (base == "FN") & (call == "NA")
        missing_candidates = int(missing_candidates_index.sum())
        score = np.where(missing_candidates_index, -1, score)

        filtered_tp = int((tp_mask & ~is_pass).sum())
        filtered_fp = int((fp_mask & ~is_pass).sum())
        initial_fp = int(fp_mask.sum())
        initial_tp = int(tp_mask.sum())
        initial_fn = int(fn_mask.sum())
        total_variants = initial_tp + initial_fn
        fp = initial_fp - filtered_fp
        fn = initial_fn + filtered_tp
        tp = initial_tp - filtered_tp

        if "error_type" in d:
            et = np.asarray(d["error_type"], dtype=object)
            noise = int(((et == ErrorType.NOISE) & is_pass).sum())
            hom_to_het = int(((et == ErrorType.HOM_TO_HET) & is_pass).sum())
            het_to_hom = int(((et == ErrorType.HET_TO_HOM) & is_pass).sum())
            wrong_allele = int(((et == ErrorType.WRONG_ALLELE) & is_pass).sum())
        else:
            noise = hom_to_het = het_to_hom = wrong_allele = 0
        filtered_true = fn - missing_candidates - hom_to_het - het_to_hom - wrong_allele

        recall = get_recall(fn, tp, np.nan)
        max_recall = get_recall(missing_candidates, tp + fn - missing_candidates, np.nan)
        precision = get_precision(fp, tp, np.nan)
        f1 = get_f1(recall, precision, np.nan)

        result_dict = {
            "# pos": total_variants,
            "recall": recall,
            "precision": precision,
            "f1": f1,
            "max_recall": max_recall,
            "initial_tp": initial_tp,
            "initial_fp": initial_fp,
            "initial_fn": initial_fn,
            "tp": tp,
            "fp": fp,
            "fn": fn,
            "noise": noise,
            "wrong_allele": wrong_allele,
            "hom->het": hom_to_het,
            "het->hom": het_to_hom,
            "filter_true": filtered_true,
            "miss_candidate": missing_candidates,
        }
        if n < 10:
            return result_dict, Frame({})

        # the cumulative PR curve: one stable sort and three cumulative sums
        order = np.argsort(score, kind="stable")
        cum_tp = np.cumsum(tp_mask[order].astype(np.int64))
        fn_c = initial_fn + cum_tp
        tp_c = initial_tp - cum_tp
        fp_c = initial_fp - np.cumsum(fp_mask[order].astype(np.int64))
        with np.errstate(invalid="ignore", divide="ignore"):
            rec = np.where(tp_c + fn_c > 0, tp_c / np.maximum(tp_c + fn_c, 1), np.nan)
            prec = np.where(tp_c + fp_c > 0, tp_c / np.maximum(tp_c + fp_c, 1), np.nan)
            f1_c = 2 * rec * prec / np.where(rec + prec > 0, rec + prec, np.nan)
        return result_dict, Frame({score_name: score[order], "recall": rec, "precision": prec, "f1": f1_c})

    # -- table shaping ---------------------------------------------------------

    def _general_performance_row(self, p: dict) -> dict:
        if self.verbosity > 1:
            return {"# pos": p["# pos"], "# neg": p["initial_fp"], "fn": p["initial_fn"],
                    "max recall": p["max_recall"], "recall": p["recall"], "precision": p["precision"], "F1": p["f1"]}
        return {"true-vars": p["# pos"], "fn": p["initial_fn"], "fp": p["initial_fp"], "recall": p["recall"],
                "precision": p["precision"], "F1": p["f1"]}

    @staticmethod
    def _error_types_row(p: dict) -> dict:
        return {k: p[k] for k in ("noise", "wrong_allele", "hom->het", "het->hom", "filter_true", "miss_candidate")}

    # the reference's indel_analysis factor grid
    INDEL_VARIABLES = ("indel_length", "hmer_length", "max_vaf", "qual", "gq", "dp")
    INDEL_MINS = (1, 0, 0, 0, 0, 0)
    INDEL_MAXS = (15, 20, 1, 80, 80, 80)
    INDEL_BINS = (1, 1, 0.05, 3, 3, 3)

    def indel_analysis(self, data: Frame, data_name: str) -> Frame:
        """Per-factor indel error histograms and per-bin precision/recall: one
        long frame (h5 key ``{name}_indel_analysis``) of columns group,
        variable, bin_left, ins/del x fp/tp/fn, precision, recall; hmer and
        non-hmer indels apart, and PNG panels under ``plot_dir``."""
        indels = data.take(as_bool(data["indel"]))
        hmer_len = np.nan_to_num(np.asarray(indels["hmer_length"] if "hmer_length" in indels else 0, dtype=float))
        groups = (("hmer_indels", hmer_len > 0), ("non_hmer_indels", hmer_len == 0))
        rows = []
        for k, variable in enumerate(self.INDEL_VARIABLES):
            if variable not in indels:
                continue
            lo, hi, width = self.INDEL_MINS[k], self.INDEL_MAXS[k], self.INDEL_BINS[k]
            if hi > 1:
                hi += 1
            bins = np.arange(lo, hi + width / 2, width)
            vals = np.asarray(indels[variable], dtype=float)
            is_ins = np.asarray(indels["indel_classify"]) == "ins"
            for gname, gmask in groups:
                counts = {}
                for cls in ("fp", "tp", "fn"):
                    cmask = np.asarray(indels[cls], dtype=bool) & gmask
                    for side, smask in (("ins", is_ins), ("del", ~is_ins)):
                        v = vals[cmask & smask]
                        counts[f"{side}_{cls}"], _ = np.histogram(v[~np.isnan(v)], bins=bins)
                tp = counts["ins_tp"] + counts["del_tp"]
                fp = counts["ins_fp"] + counts["del_fp"]
                fn = counts["ins_fn"] + counts["del_fn"]
                with np.errstate(invalid="ignore", divide="ignore"):
                    precision = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), np.nan)
                    recall = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), np.nan)
                for b in range(len(bins) - 1):
                    rows.append({"group": gname, "variable": variable, "bin_left": bins[b],
                                 **{key: int(cnt[b]) for key, cnt in counts.items()},
                                 "precision": precision[b], "recall": recall[b]})
                if self.plot_dir and self.verbosity > 2:
                    self._plot_indel_panel(data_name, gname, variable, bins, counts, precision, recall)
        safe = data_name.replace("-", "_").replace(" ", "_")
        if not rows:
            return Frame({})
        texts, counts = ("group", "variable"), [f"{s}_{c}" for c in ("fp", "tp", "fn") for s in ("ins", "del")]
        out = Frame({name: object_column([r[name] for r in rows]) if name in texts
                     else np.array([r[name] for r in rows], dtype=np.int64 if name in counts else np.float64)
                     for name in rows[0]})
        self._to_hdf(out, f"{safe}_indel_analysis")
        return out

    # -- the figures (PNG files under plot_dir) -----------------------------------

    def _save_figure(self, build, path: str, what: str) -> None:
        sink = _FigureFile(path)
        add_figure_safe(sink, build, what)
        self.figures_skipped += sink.figures_skipped

    def _plot_indel_panel(self, data_name, gname, variable, bins, counts, precision, recall) -> None:
        def build(plt):
            fig, ax = plt.subplots(1, 5, figsize=(15, 3))
            centers = bins[:-1]
            for i, cls in enumerate(("fp", "tp", "fn")):
                ax[i].bar(centers, counts[f"ins_{cls}"], width=np.diff(bins), alpha=0.5, label="ins", align="edge")
                ax[i].bar(centers, counts[f"del_{cls}"], width=np.diff(bins), alpha=0.5, label="del", color="g",
                          align="edge")
                ax[i].set_title(cls)
                ax[i].set_xlabel(variable)
                ax[i].legend()
            ax[3].plot(centers, precision, "-o", markersize=3)
            ax[3].set_title("precision")
            ax[4].plot(centers, recall, "-o", markersize=3)
            ax[4].set_title("recall")
            fig.suptitle(f"{data_name} {gname} — {variable}")
            fig.tight_layout()
            return fig

        safe = f"{data_name}_{gname}_{variable}".replace("/", "_").replace(" ", "_")
        self._save_figure(build, os.path.join(self.plot_dir, f"indel_{safe}.png"), f"indel figure {safe}")

    def _to_hdf(self, df: Frame, key: str) -> None:
        write_hdf(df, self.h5outfile, key=key, mode="a")

    def plot_performance(self, perf_curve: dict, opt_res: dict, categories: list[str], name: str) -> None:
        """The PR grid of ``categories``, saved as ``pr_<name>.png`` under ``plot_dir``."""
        m = self.num_plots_in_row
        categories = [c for c in categories if not any(c == f"hmer Indel {i}" for i in range(4, 10))]
        n = max(1, math.ceil(len(categories) / m))

        def build(plt):
            fig_pr, ax_pr = plt.subplots(n, m, figsize=(3 * m, 3 * n + 0.5 * (n - 1)), squeeze=False)
            for k, cat in enumerate(categories):
                ax = ax_pr[k // m][k % m]
                perf = perf_curve.get(cat, Frame({}))
                opt = opt_res.get(cat, {})
                if len(perf) and not np.all(np.isnan(perf["precision"])):
                    ax.plot(perf["recall"], perf["precision"], "-", color="r")
                    ax.plot(opt.get("recall"), opt.get("precision"), "o", color="red")
                ax.set_title(cat)
                ax.grid(True)
            fig_pr.suptitle(f"Precision/Recall curve ({name})", fontsize=20)
            fig_pr.tight_layout()
            return fig_pr

        safe = name.replace("/", "_").replace(" ", "_")
        self._save_figure(build, os.path.join(self.plot_dir, f"pr_{safe}.png"), f"PR figure {safe}")


def _hashable_in(v, members: set) -> bool:
    """``Series.isin(members)`` of one value (an unhashable value is in no set)."""
    try:
        return v in members
    except TypeError:
        return False


def _head_mean(values: np.ndarray, k: int) -> float:
    """``Series.head(k).mean()`` of NaN-free float64 values: numpy's sum over the count, NaN when empty."""
    head = values[:k]
    return float(head.sum() / len(head)) if len(head) else float("nan")
