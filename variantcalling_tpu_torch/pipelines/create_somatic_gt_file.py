"""create_somatic_gt_file — tumor-minus-normal somatic ground truth.

Counterpart of ``variantcalling_tpu/pipelines/create_somatic_gt_file.py``,
with the same arguments and outputs (no device program runs: no
``--backend``):

- the somatic GT VCF: the tumor GT records that the normal GT lacks (an
  exact chrom/pos/ref/alt match removes a record);
- the "problematic positions": loci where tumor and normal share a position
  but not an exact allele, each covering its record's reference span; they
  are subtracted from ``cmp_intervals`` to give the comparison BED
  (intersected with ``regions_bed`` where one is given).

The reference's sets of ``(chrom, pos, ref, alt)`` tuples are arrays of
keys here, matched by sorted membership (``np.isin``).

Outputs:
  OUTPUT_gt_<tumor>_minus_<normal>.vcf.gz (and its .tbi)
  [OUTPUT_]<cmp_prefix>_no_problematic_positions[_in_regions_only].bed
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from variantcalling_tpu_torch.io.bed import IntervalSet, read_bed, write_bed
from variantcalling_tpu_torch.io.vcf import read_vcf, write_vcf
from variantcalling_tpu_torch.utils.h5_utils import object_column

log = logging.getLogger(__name__)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="create_somatic_gt_file", description=run.__doc__)
    ap.add_argument("--gt_tumor", required=True, help="tumor ground-truth VCF")
    ap.add_argument("--gt_normal", required=True, help="normal ground-truth VCF")
    ap.add_argument("--gt_tumor_name", required=True)
    ap.add_argument("--gt_normal_name", required=True)
    ap.add_argument("--regions_bed", default=None)
    ap.add_argument("--cmp_intervals", required=True)
    ap.add_argument("--output_folder", required=True)
    return ap.parse_args(argv)


def _keys(table, with_alleles: bool) -> np.ndarray:
    """One string a record: ``chrom\\tpos`` and, ``with_alleles``, ``\\tref\\talt``."""
    chrom, pos = np.asarray(table.chrom).tolist(), np.asarray(table.pos).tolist()
    if not with_alleles:
        keys = [f"{c}\t{p}" for c, p in zip(chrom, pos)]
    else:
        keys = [f"{c}\t{p}\t{r}\t{a}" for c, p, r, a in zip(chrom, pos, np.asarray(table.ref).tolist(),
                                                            np.asarray(table.alt).tolist())]
    return np.array(keys, dtype=str) if keys else np.zeros(0, dtype="U1")


def problematic_intervals(tumor, normal) -> IntervalSet:
    """0-based spans of the loci whose position the tumor and normal share but
    not their exact allele, each over its record's reference span, merged."""
    exact_n = _keys(normal, True)
    pos_t, pos_n = _keys(tumor, False), _keys(normal, False)
    parts = []
    for table in (tumor, normal):
        pos = _keys(table, False)
        bad = np.isin(pos, pos_t) & np.isin(pos, pos_n) & ~np.isin(_keys(table, True), exact_n)
        rows = np.flatnonzero(bad)
        start = np.asarray(table.pos, dtype=np.int64)[rows] - 1
        ref_len = np.array([max(len(r), 1) for r in np.asarray(table.ref)[rows].tolist()], dtype=np.int64)
        parts.append((np.asarray(table.chrom)[rows].tolist(), start, start + ref_len))
    return IntervalSet(object_column(parts[0][0] + parts[1][0]), np.concatenate([parts[0][1], parts[1][1]]),
                       np.concatenate([parts[0][2], parts[1][2]])).merged()


def run(argv) -> int:
    """Build the somatic (tumor-minus-normal) GT VCF + cleaned cmp intervals."""
    args = parse_args(argv)
    os.makedirs(args.output_folder, exist_ok=True)
    tumor = read_vcf(args.gt_tumor)
    normal = read_vcf(args.gt_normal)

    keep = ~np.isin(_keys(tumor, True), _keys(normal, True))
    somatic = tumor.subset(keep)
    gt_out = os.path.join(args.output_folder, f"OUTPUT_gt_{args.gt_tumor_name}_minus_{args.gt_normal_name}.vcf.gz")
    write_vcf(gt_out, somatic)

    bad = problematic_intervals(tumor, normal)
    cleaned = read_bed(args.cmp_intervals).merged().subtract(bad)
    prefix = os.path.splitext(os.path.basename(args.cmp_intervals))[0].split(".")[0]
    if args.regions_bed is None:
        bed_out = os.path.join(args.output_folder, f"OUTPUT_{prefix}_no_problematic_positions.bed")
        write_bed(bed_out, cleaned)
    else:
        write_bed(os.path.join(args.output_folder, f"{prefix}_no_problematic_positions.bed"), cleaned)
        final = cleaned.intersect(read_bed(args.regions_bed).merged())
        bed_out = os.path.join(args.output_folder, f"OUTPUT_{prefix}_no_problematic_positions_in_regions_only.bed")
        write_bed(bed_out, final)
    log.info("somatic GT: %d/%d tumor records private; %d problematic spans removed -> %s, %s",
             int(keep.sum()), len(tumor), len(bad), gt_out, bed_out)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
