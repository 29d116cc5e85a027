"""Quick fingerprinting: match sample BAMs and CRAMs to known ground-truth callsets.

Counterpart of ``variantcalling_tpu/comparison/quick_fingerprinter.py``: for
every (sample, file), call AF-gated SNVs in a region (``pileup_caller``, the
gate on the run's device), compute the hit fraction against every ground
truth (its SNPs within its HCR and the region), and fail with the list of
files that miss their own truth (< ``min_hit_fraction_target``) or match
another sample's (> the target).
"""

from __future__ import annotations

import logging
import os

import torch

from variantcalling_tpu_torch.comparison.pileup_caller import VariantHitFractionCaller, snp_set_from_vcf
from variantcalling_tpu_torch.io.bed import read_bed

log = logging.getLogger(__name__)


def parse_region(region: str) -> tuple[str, int, int]:
    """'chr15:26000000-26200000' -> (chrom, start_0based, end_exclusive)."""
    chrom, span = region.split(":")
    lo, hi = span.replace(",", "").split("-")
    return chrom, int(lo) - 1, int(hi)


class QuickFingerprinter:
    def __init__(self, sample_crams: dict[str, list[str]], ground_truth_vcfs: dict[str, str], hcrs: dict[str, str],
                 ref: str, region: str, min_af_snps: float, min_hit_fraction_target: float, out_dir: str,
                 device: torch.device | str = "cpu"):
        self.crams = sample_crams
        self.region = parse_region(region)
        self.min_hit_fraction_target = min_hit_fraction_target
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.vc = VariantHitFractionCaller(ref, out_dir, min_af_snps, region, device)
        chrom, start, end = self.region
        vcf_region = (chrom, start + 1, end)
        self.ground_truths_to_check = {
            sid: snp_set_from_vcf(ground_truth_vcfs[sid], vcf_region, read_bed(hcrs[sid])) for sid in ground_truth_vcfs
        }

    def check(self) -> None:
        errors: list[str] = []
        chrom, start, end = self.region
        with open(f"{self.out_dir}/quick_fingerprinting_results.txt", "w", encoding="utf-8") as of:
            for sample_id, bams in self.crams.items():
                of.write(f"Check consistency for {sample_id}:\n")
                for bam in bams:
                    called = self.vc.call_variants(bam, chrom, start, end, self.vc.min_af_snps)
                    max_hit_fraction, best_match = 0.0, None
                    potential_error = f"{bam} - {sample_id} "
                    for gt_id, gt_set in self.ground_truths_to_check.items():
                        hit_fraction, hits, n_gt = self.vc.calc_hit_fraction(called, gt_set)
                        of.write(f"{bam} - {sample_id} vs. {gt_id} hit_fraction={hit_fraction}\n")
                        with open(f"{self.out_dir}/{os.path.basename(bam)}_{gt_id}.hit.txt", "w",
                                  encoding="utf-8") as fh:
                            fh.write(f"hit_count {hits}\nhit_fraction {hit_fraction}\n")
                        if hit_fraction > max_hit_fraction:
                            max_hit_fraction, best_match = hit_fraction, gt_id
                        if sample_id == gt_id and hit_fraction < self.min_hit_fraction_target:
                            potential_error += f"does not match it's ground truth: hit_fraction={hit_fraction} "
                        elif sample_id != gt_id and hit_fraction > self.min_hit_fraction_target:
                            potential_error += f"matched ground truth of {gt_id}: hit_fraction={hit_fraction} "
                    if best_match != sample_id:
                        log.warning("%s best_match=%s hit_fraction=%s", bam, best_match, max_hit_fraction)
                    if potential_error != f"{bam} - {sample_id} ":
                        errors.append(potential_error)
        if errors:
            raise RuntimeError("\n".join(errors))
