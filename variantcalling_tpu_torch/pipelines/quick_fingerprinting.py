"""quick_fingerprinting: verify sample identity of BAMs and CRAMs against known ground truths.

Counterpart of ``variantcalling_tpu/pipelines/quick_fingerprinting.py``, with
its arguments (a JSON conf with ``cram_files``, sample -> [paths],
``ground_truth_vcf_files``, ``ground_truth_hcr_files``,
``references.ref_fasta``) plus ``--backend gpu|cpu`` (default ``gpu``: the
card; asking for it without one exits 2). A mismatch raises
``RuntimeError`` with one line a file, as the reference does.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.comparison.pileup_caller import VariantHitFractionCaller
from variantcalling_tpu_torch.comparison.quick_fingerprinter import QuickFingerprinter
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)


def run(argv: list[str]):
    """quick fingerprinting to identify known samples in bams/crams"""
    ap = argparse.ArgumentParser(prog="quick_fingerprinting", description=run.__doc__)
    ap.add_argument("--json_conf", required=True, help="json with sample-names, crams, and ground truth files")
    ap.add_argument("--region_str", type=str, default="chr15:26000000-26200000",
                    help="region subset string, compare variants only in this region")
    VariantHitFractionCaller.add_args_to_parser(ap)
    ap.add_argument("--out_dir", type=str, required=True, help="output directory")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    args = ap.parse_args(argv)
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2

    with open(args.json_conf, encoding="utf-8") as fh:
        conf = json.load(fh)
    with stage("fingerprint", device):
        QuickFingerprinter(conf["cram_files"], conf["ground_truth_vcf_files"], conf["ground_truth_hcr_files"],
                           conf["references"]["ref_fasta"], args.region_str, args.min_af_snps,
                           args.min_hit_fraction_target, args.out_dir, device).check()
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
