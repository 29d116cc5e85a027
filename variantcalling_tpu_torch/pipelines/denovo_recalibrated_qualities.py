"""denovo_recalibrated_qualities: add DENOVO_QUAL to a de novo VCF.

Counterpart of ``variantcalling_tpu/pipelines/denovo_recalibrated_qualities.py``,
with the same positional arguments ``denovo_vcf recalibrated_vcf
maternal_vcfs.json paternal_vcfs.json`` and output bytes
(:mod:`variantcalling_tpu_torch.joint.denovo_refinement`). Host-only: no
device program, so no ``--backend``.
"""

from __future__ import annotations

import argparse
import json
import sys

from variantcalling_tpu_torch.joint.denovo_refinement import write_recalibrated_vcf


def run(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="denovo_recalibrated_qualities",
                                 description="Add recalibrated quality (from child/parent calling) to the denovo VCF")
    ap.add_argument("denovo_vcf", help="Annotated de novo VCF file")
    ap.add_argument("recalibrated_vcf", help="Path to the recalibrated VCF file")
    ap.add_argument("maternal_vcfs", help="JSON dict: sample in denovo vcf -> maternal somatic VCF")
    ap.add_argument("paternal_vcfs", help="JSON dict: sample in denovo vcf -> paternal somatic VCF")
    args = ap.parse_args(argv)
    with open(args.maternal_vcfs, encoding="utf-8") as f:
        maternal = json.load(f)
    with open(args.paternal_vcfs, encoding="utf-8") as f:
        paternal = json.load(f)
    n = write_recalibrated_vcf(args.denovo_vcf, args.recalibrated_vcf, maternal, paternal)
    sys.stderr.write(f"denovo_recalibrated_qualities: annotated {n} records\n")
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
