"""substitution_error_rate_report: per-motif substitution error report.

Counterpart of ``variantcalling_tpu/pipelines/substitution_error_rate_report.py``
with the same arguments; host code only, so it takes no ``--backend``. The
motif table (key ``motif_1``) is folded onto its pyrimidine-ref strand
(:func:`fold_strands`), summed by mutation type, the strand asymmetry ranked
and, where the input has one, the per-read-position table sorted, each as
pandas would compute it (its sums, its quicksort order), into the h5 under
the reference's keys and into the HTML report (figures drawn where
matplotlib imports, else skipped and counted: ``reports/html``).
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch.reports.html import HtmlReport, add_figure_safe
from variantcalling_tpu_torch.utils.frame_ops import kahan_sum, nargsort
from variantcalling_tpu_torch.utils.h5_utils import Frame, list_keys, object_column, read_hdf, write_frames

log = logging.getLogger(__name__)

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
_SUMMED = ("fwd_errors", "rev_errors", "fwd_bases", "rev_bases")


def revcomp(seq: str) -> str:
    return "".join(_COMP.get(b, "N") for b in reversed(seq))


def fold_strands(df: Frame) -> Frame:
    """Match each (ref, alt, left_motif, right_motif) row with its reverse
    complement; one row per canonical pyrimidine-ref channel with forward and
    reverse counts, rates and the asymmetry ratio (a later duplicate row of a
    key replaces an earlier one)."""
    need = {"ref", "alt", "left_motif", "right_motif"}
    if not need.issubset(df.columns):
        raise ValueError(f"motif table missing columns {sorted(need - set(df.columns))}")
    count_col = next((c for c in ("n_errors", "count", "n") if c in df), None)
    base_col = next((c for c in ("n_bases", "coverage", "total") if c in df), None)
    keyed: dict[tuple, int] = {}
    for i, key in enumerate(zip(*(df[c].tolist() for c in ("ref", "alt", "left_motif", "right_motif")))):
        keyed[key] = i
    counts = df[count_col].tolist() if count_col else None
    bases = df[base_col].tolist() if base_col else None
    rows = []
    seen = set()
    for key in keyed:
        ref, alt, left, right = key
        rc_key = (_COMP.get(ref, "N"), _COMP.get(alt, "N"), revcomp(right), revcomp(left))
        canon = key if ref in ("C", "T") else rc_key
        if canon in seen:
            continue
        seen.add(canon)
        fwd = keyed.get(canon)
        rev = keyed.get((_COMP.get(canon[0], "N"), _COMP.get(canon[1], "N"), revcomp(canon[3]), revcomp(canon[2])))
        out = {"ref": canon[0], "alt": canon[1], "left_motif": canon[2], "right_motif": canon[3],
               "mut_type": f"{canon[0]}>{canon[1]}"}
        for tag, r in (("fwd", fwd), ("rev", rev)):
            out[f"{tag}_errors"] = float(counts[r]) if r is not None and count_col else np.nan
            out[f"{tag}_bases"] = float(bases[r]) if r is not None and base_col else np.nan
        if count_col and base_col:
            out["fwd_rate"] = out["fwd_errors"] / max(out["fwd_bases"], 1.0)
            out["rev_rate"] = out["rev_errors"] / max(out["rev_bases"], 1.0)
            out["asymmetry"] = out["fwd_rate"] / max(out["rev_rate"], 1e-12)
        rows.append(out)
    names = list(rows[0]) if rows else []
    return Frame({n: object_column([r[n] for r in rows]) if n in ("ref", "alt", "left_motif", "right_motif", "mut_type")
                  else np.array([r[n] for r in rows], dtype=np.float64) for n in names})


def by_mutation_type(folded: Frame) -> Frame:
    """``folded.groupby("mut_type")[fwd/rev errors and bases].sum().reset_index()``
    and the error rate of each type."""
    types = sorted(set(folded["mut_type"].tolist()))
    codes = np.array([types.index(t) for t in folded["mut_type"].tolist()], dtype=np.int64)
    cols = {"mut_type": object_column(types)}
    for c in _SUMMED:
        cols[c] = np.array([kahan_sum(folded[c][codes == g]) for g in range(len(types))], dtype=np.float64)
    out = Frame(cols)
    out["error_rate"] = (out["fwd_errors"] + out["rev_errors"]) / np.maximum(out["fwd_bases"] + out["rev_bases"], 1.0)
    return out


def asymmetry_ranking(folded: Frame) -> Frame:
    """The channels with errors and coverage on both strands, most asymmetric
    first by ``|log2(((fwd_err + 0.5) / (fwd_bases + 1)) / ((rev_err + 0.5) / (rev_bases + 1)))|``."""
    asym = folded.take(~np.isnan(folded["asymmetry"]))
    z = {c: np.nan_to_num(asym[c]) for c in _SUMMED}
    keep = ((z["fwd_errors"] > 0) | (z["rev_errors"] > 0)) & (z["fwd_bases"] > 0) & (z["rev_bases"] > 0)
    asym = asym.take(keep)
    z = {c: np.nan_to_num(asym[c]) for c in _SUMMED}
    fwd = (z["fwd_errors"] + 0.5) / (z["fwd_bases"] + 1.0)
    rev = (z["rev_errors"] + 0.5) / (z["rev_bases"] + 1.0)
    asym["abs_log2_asymmetry"] = np.abs(np.log2(fwd / rev))
    return asym.take(nargsort(asym["abs_log2_asymmetry"], ascending=False))


def _head(frame: Frame, n: int) -> Frame:
    return frame.take(np.arange(min(n, len(frame))))


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="substitution_error_rate_report", description=run.__doc__)
    ap.add_argument("--h5_substitution_error_rate", required=True)
    ap.add_argument("--motif_key", default="motif_1")
    ap.add_argument("--h5_output", default="substitution_error_rate_report.h5")
    ap.add_argument("--html_output", default=None)
    ap.add_argument("--position_key", default="by_position",
                    help="input h5 key of the per-read-position error table")
    return ap.parse_args(argv)


def run(argv) -> int:
    """Fold strands and summarize substitution error rates."""
    args = parse_args(argv)
    folded = fold_strands(read_hdf(args.h5_substitution_error_rate, key=args.motif_key))
    by_type = by_mutation_type(folded)
    frames = {"folded_motifs": folded, "by_mut_type": by_type}
    rep = HtmlReport("Substitution Error Rate Report")

    total_bases = np.nansum(folded["fwd_bases"]) + np.nansum(folded["rev_bases"])
    if total_bases > 0:  # inputs without a base/coverage column: no rate
        tot = Frame({"errors": np.array([np.nansum(folded["fwd_errors"]) + np.nansum(folded["rev_errors"])]),
                     "bases": np.array([total_bases])})
        tot["avg_error_rate"] = tot["errors"] / tot["bases"]
        rep.add_section("Average substitution error rate")
        rep.add_table(tot)
        frames["average_error_rate"] = tot

    rep.add_section("Error rate by mutation type")
    rep.add_table(by_type)
    add_figure_safe(rep, lambda plt: _by_type_figure(plt, by_type), "mut-type figure")
    if {"fwd_rate", "rev_rate"}.issubset(folded.columns) and len(folded):
        rep.add_section("Error rate by trinucleotide context")
        add_figure_safe(rep, lambda plt: _context_figure(plt, folded), "context figure")
    if "asymmetry" in folded:
        asym = asymmetry_ranking(folded)
        rep.add_section("Strand asymmetry (top channels)")
        rep.add_table(_head(asym, 20))
        frames["asymmetry"] = asym
        add_figure_safe(rep, lambda plt: _asymmetry_figure(plt, asym), "asymmetry figure")

    if args.position_key in list_keys(args.h5_substitution_error_rate):
        pos = read_hdf(args.h5_substitution_error_rate, key=args.position_key)
        if {"position", "n_errors"}.issubset(pos.columns):
            pos = pos.take(nargsort(pos["position"]))
            pos.index = None  # reset_index(drop=True)
            if "n_bases" in pos:
                pos["error_rate"] = pos["n_errors"] / np.maximum(pos["n_bases"], 1.0)
            rep.add_section("Error rate by read position")
            rep.add_table(_head(pos, 40))
            frames["by_position"] = pos
            add_figure_safe(rep, lambda plt: _position_figure(plt, pos), "position figure")

    rep.add_section("Folded motif table (head)")
    rep.add_table(_head(folded, 50))
    write_frames(args.h5_output, frames)
    if args.html_output:
        rep.write(args.html_output)
    log.info("substitution error report: %d folded motifs -> %s (%d figures skipped)", len(folded), args.h5_output,
             rep.figures_skipped)
    return 0


_TYPE_COLORS = {"C>A": "#03bcee", "C>G": "#010101", "C>T": "#e32926",
                "T>A": "#cac9c9", "T>C": "#a1ce63", "T>G": "#ebc6c4"}


def _by_type_figure(plt, by_type: Frame):
    fig, ax = plt.subplots(figsize=(6, 3))
    types = by_type["mut_type"].tolist()
    ax.bar(types, by_type["error_rate"], color=[_TYPE_COLORS.get(t, "#888888") for t in types])
    ax.set_ylabel("error rate")
    ax.set_yscale("log")
    return fig


def _context_figure(plt, folded: Frame):
    """Each channel's error rate, grouped by mutation type and then by its motifs."""
    order = sorted(range(len(folded)), key=lambda i: (folded["mut_type"][i], folded["left_motif"][i],
                                                      folded["right_motif"][i]))
    z = {c: np.nan_to_num(folded[c][order]) for c in _SUMMED}
    rate = (z["fwd_errors"] + z["rev_errors"]) / np.maximum(z["fwd_bases"] + z["rev_bases"], 1.0)
    fig, ax = plt.subplots(figsize=(14, 3))
    ax.bar(np.arange(len(order)), rate, color=[_TYPE_COLORS.get(folded["mut_type"][i], "#888888") for i in order],
           width=0.8)
    ax.set_xlabel("trinucleotide channel (grouped by mutation type)")
    ax.set_ylabel("error rate")
    return fig


def _position_figure(plt, pos: Frame):
    rate = "error_rate" in pos.columns
    fig, ax = plt.subplots(figsize=(7, 3))
    ax.plot(pos["position"], pos["error_rate"] if rate else pos["n_errors"])
    ax.set_xlabel("position in read")
    ax.set_ylabel("error rate" if rate else "# errors")
    ax.set_yscale("log")
    return fig


def _asymmetry_figure(plt, asym: Frame):
    fig, ax = plt.subplots(figsize=(6, 3))
    ax.hist(np.log2(np.maximum(asym["asymmetry"].astype(np.float64), 1e-6)), bins=30)
    ax.set_xlabel("log2(fwd rate / rev rate)")
    ax.set_ylabel("# channels")
    return fig


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
