"""annotate_contig — add interval-membership INFO flags to one contig's VCF.

Counterpart of ``variantcalling_tpu/pipelines/vcfbed/annotate_contig.py``,
with the same arguments (a host tool: no ``--backend``): each annotation
BED (merged) becomes a Flag named by its file name without ``.gz``,
``.bed`` or ``.interval_list``, declared in the header and set on the
records it covers. ``--contig`` reads that contig alone (through the
``.tbi`` of a bgzipped input).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from variantcalling_tpu_torch.io.bed import read_bed
from variantcalling_tpu_torch.io.vcf import read_vcf, write_vcf

log = logging.getLogger(__name__)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="annotate_contig", description=run.__doc__)
    ap.add_argument("--input_vcf", required=True)
    ap.add_argument("--output_vcf", required=True)
    ap.add_argument("--annotate_intervals", nargs="+", required=True, help="annotation BEDs")
    ap.add_argument("--contig", default=None, help="restrict to this contig")
    return ap.parse_args(argv)


def run(argv) -> int:
    """Annotate VCF records with interval-membership INFO flags."""
    args = parse_args(argv)
    region = (args.contig, 1, 1 << 60) if args.contig else None
    table = read_vcf(args.input_vcf, region=region)
    chrom = np.asarray(table.chrom)
    pos0 = np.asarray(table.pos, dtype=np.int64) - 1
    extra = {}
    for path in args.annotate_intervals:
        name = os.path.basename(path)
        for suffix in (".gz", ".bed", ".interval_list"):
            name = name.removesuffix(suffix)
        member = read_bed(path).merged().contains(chrom, pos0)
        table.header.ensure_info(name, "0", "Flag", f"Position overlaps {os.path.basename(path)}")
        extra[name] = np.where(member, True, None)  # Flag: present or absent
    write_vcf(args.output_vcf, table, extra_info=extra, qual_as_read=False)
    log.info("%d records, %d annotations -> %s", len(table), len(extra), args.output_vcf)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
