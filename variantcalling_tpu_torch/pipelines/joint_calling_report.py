"""joint_calling_report: cohort joint-calling statistics report.

Counterpart of ``variantcalling_tpu/pipelines/joint_calling_report.py``, with
its arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card; asking
for it without one exits 2). The eval tables (``reports/variant_eval``:
masked counts on the run's device), the cohort alt-allele-frequency
spectrum (``np.histogram`` of the called alleles, float64, as the
reference computes it) and the per-sample rows go to the h5 under the
reference's keys and to the HTML report (its figures drawn where matplotlib
imports, else skipped and counted: ``reports/html``).
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.io.vcf import read_vcf
from variantcalling_tpu_torch.reports.html import HtmlReport, add_figure_safe
from variantcalling_tpu_torch.reports.variant_eval import compute_eval_tables, dbsnp_membership
from variantcalling_tpu_torch.utils.h5_utils import Frame, object_column, write_frames
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="joint_calling_report", description=run.__doc__)
    ap.add_argument("--input_vcf", required=True, help="joint-called cohort VCF")
    ap.add_argument("--dbsnp", default=None, help="dbSNP VCF for known/novel split")
    ap.add_argument("--h5_output", default="joint_calling_report.h5")
    ap.add_argument("--html_output", default=None)
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def cohort_statistics(table) -> tuple[np.ndarray, list[dict]]:
    """(each site's alt-allele frequency over the called alleles, NaN where
    none is called; one row of per-sample statistics a sample), in one pass
    over the samples."""
    n = len(table)
    n_called = np.zeros(n, dtype=np.int64)
    n_alt = np.zeros(n, dtype=np.int64)
    rows = []
    for s, name in enumerate(table.header.samples):
        gts = table.genotypes(s)
        called = gts >= 0
        n_called += called.sum(axis=1)
        n_alt += ((gts > 0) & called).sum(axis=1)
        any_called = called.any(axis=1)
        het = any_called & (gts[:, 0] != gts[:, 1])
        hom_var = any_called & (gts[:, 0] == gts[:, 1]) & (gts[:, 0] > 0)
        rows.append({"sample": name, "call_rate": round(float(any_called.mean()), 5), "n_het": int(het.sum()),
                     "n_hom_var": int(hom_var.sum()),
                     "het_hom_ratio": round(float(het.sum() / max(int(hom_var.sum()), 1)), 4)})
    with np.errstate(invalid="ignore"):
        af = np.where(n_called > 0, n_alt / np.maximum(n_called, 1), np.nan)
    return af, rows


def _indel_figure(plt, t: Frame):
    """The notebook's "Distribution of indel lengths": the counts by length."""
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.bar(np.arange(len(t)), t["Freq"])
    ax.set_xticks(np.arange(len(t)))
    ax.set_xticklabels([str(v) for v in t["Length"].tolist()], rotation=90, fontsize=7)
    ax.set_xlabel("indel length")
    ax.set_ylabel("# variants")
    return fig


def _af_figure(plt, af_df: Frame):
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.bar(af_df["af_bin_low"], af_df["n_variants"], width=0.018)
    ax.set_xlabel("cohort alt-allele frequency")
    ax.set_ylabel("# variants")
    ax.set_yscale("symlog")
    return fig


def _per_sample_figure(plt, per_sample: Frame):
    fig, ax = plt.subplots(1, 2, figsize=(12, 3))
    for a, col, label in ((ax[0], "call_rate", "call rate"), (ax[1], "het_hom_ratio", "het/hom ratio")):
        a.bar(per_sample["sample"].tolist(), per_sample[col])
        a.set_ylabel(label)
        a.tick_params(axis="x", rotation=90, labelsize=7)
    return fig


def run(argv) -> int:
    """Cohort variant statistics: counts, TiTv, indel spectrum, per-sample."""
    args = parse_args(argv)
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    with stage("ingest", device):
        table = read_vcf(args.input_vcf)
    with stage("dbsnp", device):
        known = dbsnp_membership(table, args.dbsnp) if args.dbsnp else None
    rep = HtmlReport("Joint Calling Report")
    rep.add_params({"input": args.input_vcf, "n_records": len(table), "n_samples": table.n_samples})
    frames: dict[str, Frame] = {}
    with stage("eval", device):
        tables = compute_eval_tables(table, known=known, device=device)
    for name in ("CountVariants", "TiTvVariantEvaluator", "IndelSummary", "IndelLengthHistogram"):
        rep.add_section(name)
        rep.add_table(tables[name])
        frames[name] = tables[name]
    add_figure_safe(rep, lambda plt: _indel_figure(plt, tables["IndelLengthHistogram"]), "indel length figure")

    per_sample_rows = []
    if table.n_samples:
        with stage("cohort", device):
            af, per_sample_rows = cohort_statistics(table)
            hist, edges = np.histogram(af[~np.isnan(af)], bins=np.linspace(0, 1, 51))
        af_df = Frame({"af_bin_low": edges[:-1].round(3), "n_variants": hist})
        rep.add_section("Allele frequency spectrum")
        shown = np.flatnonzero(af_df["n_variants"] > 0)[:60]
        rep.add_table(af_df.take(shown))
        add_figure_safe(rep, lambda plt: _af_figure(plt, af_df), "AF spectrum figure")
        frames["af_spectrum"] = af_df
    if per_sample_rows:
        per_sample = Frame({
            "sample": object_column([r["sample"] for r in per_sample_rows]),
            "call_rate": np.array([r["call_rate"] for r in per_sample_rows], dtype=np.float64),
            "n_het": np.array([r["n_het"] for r in per_sample_rows], dtype=np.int64),
            "n_hom_var": np.array([r["n_hom_var"] for r in per_sample_rows], dtype=np.int64),
            "het_hom_ratio": np.array([r["het_hom_ratio"] for r in per_sample_rows], dtype=np.float64)})
        rep.add_section("Per-sample statistics")
        rep.add_table(per_sample)
        add_figure_safe(rep, lambda plt: _per_sample_figure(plt, per_sample), "per-sample figure")
        frames["per_sample"] = per_sample
    with stage("writes", device):
        write_frames(args.h5_output, frames)
        if args.html_output:
            rep.write(args.html_output)
    log.info("joint calling report -> %s (%d figures skipped)", args.h5_output, rep.figures_skipped)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
