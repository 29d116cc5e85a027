"""create_var_report — germline accuracy report from a concordance h5.

Counterpart of ``variantcalling_tpu/pipelines/create_var_report.py``, without
pandas, with the same arguments: the concordance frame of
``run_comparison_pipeline`` read by ``reports/report_data_loader``, and the
report's sections in the reference's key names:

1. parameters (and ``mean_var_depth`` where ``well_mapped_coverage`` exists);
2. all data: per-category accuracy (and the SEC refilter), base
   stratification (A/T, G/C) -> ``all_data_per_base``, homozygous genotyping
   -> ``all_data_homozygous``;
3. UG high-confidence regions (``ug_hcr``) and their homozygous table;
4. exome, with the indel and SNP error examples -> ``exome_*_errors``;
5. well-covered, well-mapped regions (coverage >= 20 and ``mappability.0``);
6. callable regions;
7. the indel analysis histograms (wg, ug-hcr, exome).

The optional sections skip, with the reference's warning, when the frame
lacks a column they read. No device program runs: the tool takes no
``--backend``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from variantcalling_tpu_torch.reports.html import frame_to_html
from variantcalling_tpu_torch.reports.report_data_loader import ReportDataLoader
from variantcalling_tpu_torch.reports.report_utils import ReportUtils, as_bool, parse_config, two_level
from variantcalling_tpu_torch.utils.frame_ops import astype_str, nan_mean
from variantcalling_tpu_torch.utils.h5_utils import Frame, concat_frames, object_column

log = logging.getLogger(__name__)

#: the full stratification list (verbosity > 1)
FINE_CATEGORIES = [
    "SNP", "Indel", "non-hmer Indel", "non-hmer Indel w/o LCR",
    "hmer Indel <=4", "hmer Indel >4,<=8",
    "hmer Indel 4", "hmer Indel 5", "hmer Indel 6", "hmer Indel 7", "hmer Indel 8",
    "hmer Indel >8,<=10", "hmer Indel >10,<=12", "hmer Indel >12,<=14",
    "hmer Indel >15,<=19", "hmer Indel >=20",
]
BASE_STRAT_CATEGORIES = [
    "SNP", "Indel", "hmer Indel <=4", "hmer Indel >4,<=8", "hmer Indel >8,<=10",
    "hmer Indel >10,<=12", "hmer Indel >12,<=14", "hmer Indel >15,<=19", "hmer Indel >=20",
]
HOM_CATEGORIES = [
    "SNP", "Indel", "non-hmer Indel", "hmer Indel <=4", "hmer Indel >4,<=8",
    "hmer Indel >8,<=10", "hmer Indel >10,<=12", "hmer Indel >12,<=14",
    "hmer Indel >15,<=19", "hmer Indel >=20",
]
REGION_CATEGORIES = [
    "SNP", "Indel", "non-hmer Indel", "non-hmer Indel w/o LCR", "hmer Indel <=4",
    "hmer Indel >4,<=8", "hmer Indel 4", "hmer Indel 5", "hmer Indel 6",
    "hmer Indel 7", "hmer Indel 8", "hmer Indel >8,<=10",
]
EXOME_CATEGORIES = ["SNP", "Indel", "non-hmer Indel", "hmer Indel <=4",
                    "hmer Indel >4,<=8", "hmer Indel >8,<=10"]
ERROR_EXAMPLE_COLUMNS = ["alleles", "call", "base", "gt_ultima", "gt_ground_truth", "ad",
                         "max_vaf", "ug_hcr", "mappability.0", "hmer_length"]


def parse_args(argv: list[str]):
    ap = argparse.ArgumentParser(prog="create_var_report", description=__doc__)
    ap.add_argument("--config", help="VarReport INI config (reference var_report.config surface)")
    ap.add_argument("--h5_concordance_file", help="run_comparison output h5 (overrides config)")
    ap.add_argument("--h5_output", default=None, help="output h5 (default var_report.h5)")
    ap.add_argument("--html_output", default=None, help="optional HTML summary path")
    ap.add_argument("--reference_version", default="hg38")
    ap.add_argument("--exome_column_name", default="exome.twist")
    ap.add_argument("--run_id", default="NA")
    ap.add_argument("--pipeline_version", default="NA")
    ap.add_argument("--truth_sample_name", default="NA")
    ap.add_argument("--verbosity", type=int, default=5)
    ap.add_argument("--plot_dir", default=None, help="directory for PR-curve / indel PNGs")
    return ap.parse_args(argv)


def _section(sections: dict, title: str, tab: Frame | None) -> None:
    if tab is not None and len(tab):
        sections[title] = tab


def _reset_str(tab: Frame) -> Frame:
    """``tab.reset_index(drop=True).astype(str)``."""
    return Frame({c: astype_str(tab[c]) for c in tab.columns})


def _exome_errors(exome_data: Frame) -> dict[str, Frame]:
    """The exome's hmer-indel, non-hmer-indel and (first 20) SNP error examples."""
    present = [c for c in ERROR_EXAMPLE_COLUMNS if c in exome_data]
    indel = as_bool(exome_data["indel"])
    is_pass = np.asarray(exome_data["filter"], dtype=object) == "PASS"
    fp, fn, tp = (np.asarray(exome_data[c], dtype=bool) for c in ("fp", "fn", "tp"))
    indel_errors = indel & ((fp & is_pass) | fn)
    hmer_len = np.nan_to_num(np.asarray(exome_data["hmer_length"] if "hmer_length" in exome_data else 0, dtype=float))
    snp = np.flatnonzero(~tp & ~indel & is_pass)[:20]
    return {"exome_hmer_indel_errors": exome_data.take(indel_errors & (hmer_len > 0)).select(present),
            "exome_non_hmer_indel_errors": exome_data.take(indel_errors & (hmer_len == 0)).select(present),
            "exome_snp_errors": exome_data.take(snp).select(present)}


def run(argv: list[str]) -> int:
    args = parse_args(argv)
    h5_in = args.h5_concordance_file
    h5_out = args.h5_output
    verbosity = args.verbosity
    ref_version = args.reference_version
    if args.config:
        params, _ = parse_config(args.config)
        h5_in = h5_in or params["h5_concordance_file"]
        h5_out = h5_out or params.get("h5outfile")
        verbosity = int(params.get("verbosity", verbosity))
        ref_version = params.get("reference_version", ref_version)
    h5_out = h5_out or "var_report.h5"
    if os.path.exists(h5_out):
        if h5_in and os.path.exists(h5_in) and os.path.samefile(h5_out, h5_in):
            raise SystemExit("--h5_output must differ from --h5_concordance_file "
                             f"(both point at {h5_out})")
        os.remove(h5_out)

    data = ReportDataLoader(h5_in, ref_version, args.exome_column_name).load_concordance_df()
    log.info("loaded %d records from %s", len(data), h5_in)

    ru = ReportUtils(verbosity, h5_out, plot_dir=args.plot_dir)
    sections: dict[str, Frame] = {}

    # --- 1. parameters ------------------------------------------------------
    parameters = {
        "h5_concordance_file": str(h5_in),
        "run_id": args.run_id,
        "pipeline_version": str(args.pipeline_version),
        "verbosity": str(verbosity),
        "reference_version": ref_version,
        "truth_sample_name": args.truth_sample_name,
        "h5outfile": h5_out,
    }
    if "well_mapped_coverage" in data:
        parameters["mean_var_depth"] = f"{nan_mean(data['well_mapped_coverage']):.2f}"
    params_df = Frame({"value": object_column(parameters.values())}, object_column(parameters))
    ru._to_hdf(params_df, "parameters")
    _section(sections, "Input parameters", params_df)

    cats = FINE_CATEGORIES if verbosity > 1 else ["SNP", "Indel"]

    # --- 2. all data ----------------------------------------------------------
    opt, err = ru.basic_analysis(data, cats, "all_data", "sec_data")
    _section(sections, "2. All data — General accuracy", opt)
    _section(sections, "2. All data — error types", err)
    if verbosity > 1:
        # optional sections: a frame without their columns does not take the report down
        try:
            at_df = ru.base_stratification_analysis(data, BASE_STRAT_CATEGORIES, ("A", "T"))
            gc_df = ru.base_stratification_analysis(
                data, ["SNP", "Indel", "hmer Indel <=4", "hmer Indel >4,<=8", "hmer Indel >8,<=10"], ("G", "C"))
            base_strat = concat_frames([at_df, gc_df])
            ru._to_hdf(two_level(base_strat), "all_data_per_base")
            _section(sections, "2.1 Stratified by base", base_strat)
        except KeyError as e:
            log.warning("base stratification skipped (missing column %s)", e)
        try:
            hom = ru.homozygous_genotyping_analysis(data, HOM_CATEGORIES, "all_data_homozygous")
            _section(sections, "2.2 Homozygous genotyping accuracy", hom)
        except KeyError as e:
            log.warning("homozygous section skipped (missing column %s)", e)

    # --- 3. UG high confidence regions ----------------------------------------
    ug_hcr_data = data.take(as_bool(data["ug_hcr"])) if "ug_hcr" in data else Frame({})
    if len(ug_hcr_data):
        rcats = REGION_CATEGORIES if verbosity > 1 else ["SNP", "Indel"]
        opt, err = ru.basic_analysis(ug_hcr_data, rcats, "ug_hcr", "ug_hcr_sec_data")
        _section(sections, "3. UG-HCR — General accuracy", opt)
        _section(sections, "3. UG-HCR — error types", err)
        if verbosity > 1:
            try:
                hom = ru.homozygous_genotyping_analysis(ug_hcr_data, EXOME_CATEGORIES, "ug_hcr_homozygous")
                _section(sections, "3.1 UG-HCR homozygous accuracy", hom)
            except KeyError as e:
                log.warning("ug_hcr homozygous section skipped (missing column %s)", e)

    # --- 4. exome ---------------------------------------------------------------
    exome_col = args.exome_column_name
    exome_data = data.take(as_bool(data[exome_col])) if exome_col in data else Frame({})
    if len(exome_data):
        ecats = EXOME_CATEGORIES if verbosity > 1 else ["SNP", "Indel"]
        opt, err = ru.basic_analysis(exome_data, ecats, "exome", "exome_sec_data")
        _section(sections, "4. Exome — General accuracy", opt)
        _section(sections, "4. Exome — error types", err)
        if verbosity > 1:
            errors = _exome_errors(exome_data)
            for key, tab in errors.items():
                if len(tab):
                    ru._to_hdf(_reset_str(tab), key)
            _section(sections, "4.1 Exome hmer-indel error examples", errors["exome_hmer_indel_errors"])
            _section(sections, "4.2 Exome non-hmer-indel error examples", errors["exome_non_hmer_indel_errors"])
            _section(sections, "4.3 Exome SNP error examples", errors["exome_snp_errors"])

    # --- 5. well-covered, well-mapped regions -----------------------------------
    if verbosity > 1 and "well_mapped_coverage" in data and "mappability.0" in data:
        with np.errstate(invalid="ignore"):
            good_mask = (np.asarray(data["well_mapped_coverage"]) >= 20) & as_bool(data["mappability.0"])
        good = data.take(good_mask)
        if len(good):
            opt, _ = ru.basic_analysis(good, REGION_CATEGORIES, "good_cvg_data")
            _section(sections, "5. Coverage>=20 w/ mappability — accuracy", opt)
            try:
                hom = ru.homozygous_genotyping_analysis(
                    good, ["SNP", "Indel", "non-hmer Indel", "non-hmer Indel w/o LCR",
                           "hmer Indel <=4", "hmer Indel >4,<=8"], "good_cvg_data_homozygous")
                _section(sections, "5.1 Homozygous accuracy", hom)
            except KeyError as e:
                log.warning("good-coverage homozygous section skipped (missing column %s)", e)

    # --- 6. callable regions -------------------------------------------------------
    if verbosity > 1 and "callable" in data:
        callable_data = data.take(as_bool(data["callable"]))
        if len(callable_data):
            opt, _ = ru.basic_analysis(callable_data, FINE_CATEGORIES, "callable_data")
            _section(sections, "6. Callable regions — accuracy", opt)

    # --- 7. indel analysis ------------------------------------------------------------
    if verbosity > 2:
        ru.indel_analysis(data, "wg")
        if len(ug_hcr_data):
            ru.indel_analysis(ug_hcr_data, "ug-hcr")
        if len(exome_data):
            ru.indel_analysis(exome_data, "exome")

    if args.html_output:
        with open(args.html_output, "w", encoding="utf-8") as fh:
            fh.write("<html><head><title>Variant Report</title></head><body>\n")
            fh.write(f"<h1>Variant calling accuracy report {args.pipeline_version}</h1>\n")
            for title, tab in sections.items():
                fh.write(f"<h2>{title}</h2>\n")
                fh.write(frame_to_html(tab, "{:.4f}", border=1))
            fh.write("</body></html>\n")
        log.info("wrote %s", args.html_output)
    log.info("wrote %s (%d sections, figures skipped %d)", h5_out, len(sections), ru.figures_skipped)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
