"""vcfeval_flavors: comparison with alternative wrong-allele and genotype penalties.

Counterpart of ``variantcalling_tpu/pipelines/vcfeval_flavors.py``, a copy
over the port's matcher (``comparison.matcher.match_tables``), with the
same arguments plus ``--backend gpu|cpu`` (default ``gpu``; asking for the
card without one exits 2, as the other tools do, though this one runs no
device program). "Allele and genotype errors" are FPs/FNs whose site
(chrom, pos) also carries a variant on the other side.
Penalty ``-p``: 2 = count such errors twice (fp+fn, usual vcfeval);
1 = once; 0 = not at all; -1 = reward them as half-TPs. Prints and returns
``type tp fp fn precision recall f1`` rows.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.comparison.matcher import match_tables
from variantcalling_tpu_torch.io import bed as bedio
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.io.vcf import VariantTable, read_vcf
from variantcalling_tpu_torch.utils.stats_utils import get_f1, get_precision, get_recall

log = logging.getLogger(__name__)


def get_parser():
    ap = argparse.ArgumentParser(prog="vcfeval_flavors", description=run.__doc__)
    ap.add_argument("-b", "--baseline", required=True, help="VCF file containing baseline variants")
    ap.add_argument("-c", "--calls", required=True, help="VCF file containing called variants")
    ap.add_argument(
        "-e",
        "--evaluation_regions",
        action="append",
        type=str,
        default=[],
        help="evaluate within the intersection of the supplied bed files",
    )
    ap.add_argument(
        "--evaluation_intervals",
        action="append",
        type=str,
        default=[],
        help="intersect evaluation_regions with interval_list files",
    )
    ap.add_argument("-o", "--output", required=True, help="directory for output")
    ap.add_argument("-t", "--template", help="reference FASTA the variants are called against", required=True)
    ap.add_argument(
        "-p",
        "--allele_and_genotype_error_penalty",
        type=int,
        choices=[2, 1, 0, -1],
        default=1,
        help="2: usual vcfeval double penalty; 1: once; 0: none; -1: reward half-TP",
    )
    ap.add_argument("--var_type", type=str, choices=["snps", "indels", "both"], default="both")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap


def _type_mask(table: VariantTable, vt: str) -> np.ndarray:
    """bcftools --type semantics: record qualifies if ANY alt is of the type."""
    out = np.zeros(len(table), dtype=bool)
    for i in range(len(table)):
        ref = table.ref[i]
        for alt in table.alt[i].split(","):
            if alt in (".", "", "*") or alt.startswith("<"):
                continue
            is_snp = len(ref) == len(alt) == 1
            if (vt == "snps") == is_snp:
                out[i] = True
                break
    return out


def _site_keys(table: VariantTable, mask: np.ndarray) -> set[tuple[str, int]]:
    return {(str(c), int(p)) for c, p in zip(table.chrom[mask], table.pos[mask])}


def run(argv: list[str]):
    """Evaluate VCF against baseline, giving alternative penalty to wrong-alleles and genotype errors"""
    args = get_parser().parse_args(argv)
    try:
        knobs.validate_all()
        device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    os.makedirs(args.output, exist_ok=True)

    region_set = None
    for f in list(args.evaluation_regions) + list(args.evaluation_intervals):
        s = bedio.read_intervals(f)  # dispatches .bed vs .interval_list
        region_set = s if region_set is None else region_set.intersect(s)

    calls = read_vcf(args.calls)
    baseline = read_vcf(args.baseline)
    if region_set is not None:
        in_hcr = region_set.contains(np.asarray(calls.chrom), calls.pos - 1)
        calls = calls.subset(np.asarray(in_hcr))
        in_hcr_b = region_set.contains(np.asarray(baseline.chrom), baseline.pos - 1)
        baseline = baseline.subset(np.asarray(in_hcr_b))
    pass_mask = np.asarray([f in ("PASS", ".", "") for f in calls.filters])
    calls_pass = calls.subset(pass_mask)

    with FastaReader(args.template) as fasta:
        res = match_tables(calls_pass, baseline, fasta)

    penalty = args.allele_and_genotype_error_penalty
    variant_types = ["indels", "snps"] if args.var_type == "both" else [args.var_type]
    result = ["type tp fp fn precision recall f1"]
    for vt in variant_types:
        cm = _type_mask(calls_pass, vt)
        bm = _type_mask(baseline, vt)
        tp = int((res.call_tp_gt & cm).sum())
        fp_mask = ~res.call_tp_gt & cm
        fn_mask = ~res.truth_tp_gt & bm
        fp = int(fp_mask.sum())
        fn = int(fn_mask.sum())
        # allele/genotype errors: fp at a baseline site / fn at a called site
        gt_sites = _site_keys(baseline, bm)
        call_sites = _site_keys(calls_pass, cm)
        fp_err = sum(
            1 for c, p in zip(calls_pass.chrom[fp_mask], calls_pass.pos[fp_mask]) if (str(c), int(p)) in gt_sites
        )
        fn_err = sum(
            1 for c, p in zip(baseline.chrom[fn_mask], baseline.pos[fn_mask]) if (str(c), int(p)) in call_sites
        )
        tp_f, fp_f, fn_f = float(tp), float(fp), float(fn)
        if penalty == 1:
            fp_f -= fp_err / 2
            fn_f -= fn_err / 2
        elif penalty == 0:
            fp_f -= fp_err
            fn_f -= fn_err
        elif penalty == -1:
            fp_f -= fp_err
            fn_f -= fn_err
            tp_f += (fp_err + fn_err) / 2
        precision = get_precision(fp_f, tp_f) * 100
        recall = get_recall(fn_f, tp_f) * 100
        f1 = get_f1(precision / 100, recall / 100) * 100
        result.append(f"{vt} {tp_f:g} {fp_f:g} {fn_f:g} {precision:.2f} {recall:.2f} {f1:.2f}")

    out_path = os.path.join(args.output, "vcfeval_flavors_results.txt")
    with open(out_path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(result) + "\n")
    for line in result:
        print(line)
    return result


if __name__ == "__main__":
    run(sys.argv[1:])
