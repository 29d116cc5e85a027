"""gvcf_hcr: a high-confidence-region BED from a gVCF by GQ threshold.

Counterpart of ``variantcalling_tpu/pipelines/gvcf_hcr.py``, with the same
arguments and output bytes: the gVCF's spans with GQ >= the threshold (or
below it, with ``--below``; :func:`variantcalling_tpu_torch.joint.gvcf.gvcf_to_bed`),
then adjacent and overlapping intervals merged (``IntervalSet.merged``, the
reference's ``bedtools merge``). Host-only: no device program, so no
``--backend``.
"""

from __future__ import annotations

import argparse
import os
import sys

from variantcalling_tpu_torch.io.bed import BedWriter, read_bed
from variantcalling_tpu_torch.joint.gvcf import gvcf_to_bed
from variantcalling_tpu_torch.utils.stages import stage


def parse_args(argv: list[str]):
    ap = argparse.ArgumentParser(prog="gvcf_hcr", description=__doc__)
    ap.add_argument("--gvcf", required=True, help="Input gVCF")
    ap.add_argument("--output_bed", required=True, help="Output merged BED")
    ap.add_argument("--gq_threshold", type=int, default=20)
    ap.add_argument("--below", action="store_true", help="Select GQ < threshold instead of >=")
    return ap.parse_args(argv)


def run(argv: list[str]) -> int:
    args = parse_args(argv)
    raw_bed = args.output_bed + ".raw.tmp"
    skipped = gvcf_to_bed(args.gvcf, raw_bed, gq_threshold=args.gq_threshold, gt=not args.below)
    with stage("merge"):
        merged = read_bed(raw_bed).merged()
        with BedWriter(args.output_bed) as bw:
            for chrom, start, end in zip(merged.chrom.tolist(), merged.start.tolist(), merged.end.tolist()):
                bw.write(str(chrom), int(start), int(end))
        os.remove(raw_bed)
    sys.stderr.write(f"gvcf_hcr: wrote {len(merged)} merged intervals ({skipped} records skipped)\n")
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
