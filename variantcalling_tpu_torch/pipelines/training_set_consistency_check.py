"""training_set_consistency_check: validate training BAMs and CRAMs against their ground truth.

Counterpart of ``variantcalling_tpu/pipelines/training_set_consistency_check.py``,
with its arguments (a JSON conf keyed by ``<workflow>.{cram_files,
background_cram_files, ground_truth_vcf_files, training_hcr_files,
training_intervals, references}``) plus ``--backend gpu|cpu`` (default
``gpu``: the card; asking for it without one exits 2). For each subset the
targets must match their ground truth (hit fraction >= the target), the
normals must not, and a target that matches nothing is a suspected
normal-in-tumor sample that must match some normal's germline calls. The
same lines are printed and the same errors raised, in the same order.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.comparison.pileup_caller import VariantHitFractionCaller, snp_set_from_vcf
from variantcalling_tpu_torch.comparison.quick_fingerprinter import parse_region
from variantcalling_tpu_torch.io.bed import read_bed, read_intervals
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)


class TrainingSetConsistency:
    def __init__(self, target_bams: list[str], normal_bams: list[str] | None, ground_truth_vcf: str, hcr: str,
                 training_intervals_file: str, ref: str, max_vars: int, region: str, min_af_snps: float,
                 min_af_germline_snps: float, min_hit_fraction_target: float, out_dir: str,
                 device: torch.device | str = "cpu"):
        self.target_bams = target_bams
        self.normal_bams = normal_bams
        self.max_vars = max_vars
        self.region = parse_region(region)
        self.min_af_snps = min_af_snps
        self.min_af_germline_snps = min_af_germline_snps
        self.min_hit_fraction_target = min_hit_fraction_target
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.vc = VariantHitFractionCaller(ref, out_dir, min_af_snps, region, device)
        restrict = read_bed(hcr).intersect(read_intervals(training_intervals_file))
        chrom, start, end = self.region
        truth = snp_set_from_vcf(ground_truth_vcf, (chrom, start + 1, end), restrict)
        self.ground_truth = set(sorted(truth)[: self.max_vars])
        self.restrict = restrict

    def check(self) -> list[str]:
        errors: list[str] = []
        suspected_normal_in_tumor: list[str] = []
        chrom, start, end = self.region

        target_calls: dict[str, set] = {}
        for target in self.target_bams:
            called = self.vc.call_variants(target, chrom, start, end, self.min_af_snps)
            target_calls[target] = called
            hit_fraction, hit_count, _ = self.vc.calc_hit_fraction(called, self.ground_truth)
            if hit_fraction < self.min_hit_fraction_target:
                if self.normal_bams is None:
                    errors.append(f"{target} - target sample does not match ground truth, "
                                  f"hit_fraction={hit_fraction}, hit_count={hit_count}")
                elif hit_fraction > 1 - self.min_hit_fraction_target:
                    errors.append(f"{target} - target sample does not match ground truth, and is also not "
                                  f"complementary to it, hit_fraction={hit_fraction}, count={hit_count}")
                else:
                    print(f"{target} - target sample can be normal-in-tumor sample, hit_fraction={hit_fraction}")
                    suspected_normal_in_tumor.append(target)
            else:
                print(f"{target} - target sample match ground truth hit_fraction={hit_fraction}")

        normal_germline_sets: list[set] = []
        for normal in self.normal_bams or []:
            called = self.vc.call_variants(normal, chrom, start, end, self.min_af_snps)
            hit_fraction, _, _ = self.vc.calc_hit_fraction(called, self.ground_truth)
            if hit_fraction > 1 - self.min_hit_fraction_target:
                errors.append(f"{normal} - normal sample is not complementary to ground truth, "
                              f"hit_fraction={hit_fraction}")
            else:
                print(f"{normal} - normal sample is complementary to ground truth, hit_fraction={hit_fraction}")
            germline = self.vc.call_variants(normal, chrom, start, end, self.min_af_germline_snps)
            by_chrom = self.restrict.merged().by_chrom()  # germline calls within HCR and the training intervals
            if chrom in by_chrom:
                s, e = by_chrom[chrom]
                germline = {k for k in germline
                            if (j := np.searchsorted(s, k[1] - 1, side="right") - 1) >= 0 and k[1] - 1 < e[j]}
            normal_germline_sets.append(germline)

        if self.normal_bams:
            for suspect in suspected_normal_in_tumor:
                called = target_calls[suspect]
                max_hit_fraction, best_match = 0.0, ""
                for k, germline in enumerate(normal_germline_sets):
                    hit_fraction, _, _ = self.vc.calc_hit_fraction(called, germline)
                    if hit_fraction > max_hit_fraction:
                        max_hit_fraction = hit_fraction
                        best_match = (self.normal_bams or [])[k]
                if max_hit_fraction < self.min_hit_fraction_target:
                    errors.append(f"{suspect} - suspected normal-in-tumor sample does "
                                  f"not match any normal sample max_hit_fraction={max_hit_fraction}")
                else:
                    print(f"{suspect} - suspected normal-in-tumor sample matches {best_match} "
                          f"with hit_fraction={max_hit_fraction}")
        for error in errors:
            print(f"ERROR: {error}")
        return errors


def run(argv: list[str]):
    """Training set consistency check pipeline."""
    ap = argparse.ArgumentParser(prog="training_set_consistency_check", description=run.__doc__)
    ap.add_argument("--training_json_conf", required=True, help="json file with training configuration")
    ap.add_argument("--region_str", type=str, default="chr15:26000000-30000000")
    VariantHitFractionCaller.add_args_to_parser(ap)
    ap.add_argument("--out_dir", type=str, required=True)
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    args = ap.parse_args(argv)
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2

    with open(args.training_json_conf, encoding="utf-8") as fh:
        conf = json.load(fh)
    workflow_id = list(conf.keys())[0].split(".")[0]
    ref = conf[f"{workflow_id}.references"]["ref_fasta"]
    bam_files = conf[f"{workflow_id}.cram_files"]
    background_bam_files = conf[f"{workflow_id}.background_cram_files"]
    ground_truth_vcf_files = conf[f"{workflow_id}.ground_truth_vcf_files"]
    training_hcr_files = conf[f"{workflow_id}.training_hcr_files"]
    training_intervals_files = conf[f"{workflow_id}.training_intervals"]

    os.makedirs(args.out_dir, exist_ok=True)
    errors: list[str] = []
    with stage("check", device):
        for i, target_bams in enumerate(bam_files):
            if len(background_bam_files) == len(bam_files):
                normals = background_bam_files[i]
            elif len(background_bam_files) > 0:
                raise RuntimeError("Number of background bam files does not match number of bam files")
            else:
                normals = None
            print(f"subset {i}")
            errors.extend(TrainingSetConsistency(
                target_bams, normals, ground_truth_vcf_files[i], training_hcr_files[i], training_intervals_files[i],
                ref, args.max_vars, args.region_str, args.min_af_snps, args.min_af_germline_snps,
                args.min_hit_fraction_target, f"{args.out_dir}/subset_{i}", device).check())
    if errors:
        raise RuntimeError("\n".join(errors))
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
