"""remove_vcf_duplicates — drop duplicate VCF records.

Counterpart of ``variantcalling_tpu/pipelines/misc/remove_vcf_duplicates.py``,
with the same arguments (a host tool: no ``--backend``). Duplicates are
records of the same (CHROM, POS, REF, ALT); the first occurrence wins. The
keys are found by array operations (one code a record for its key tuple,
the first row of each code kept), not a Python set.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch.io.vcf import read_vcf, write_vcf
from variantcalling_tpu_torch.utils.frame_ops import first_seen_codes

log = logging.getLogger(__name__)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="remove_vcf_duplicates", description=run.__doc__)
    ap.add_argument("input", help="input VCF (.vcf/.vcf.gz)")
    ap.add_argument("output", help="output VCF (.vcf/.vcf.gz)")
    return ap.parse_args(argv)


def first_occurrences(chrom, pos, ref, alt) -> np.ndarray:
    """A mask of the rows whose (chrom, pos, ref, alt) no earlier row has."""
    n = len(pos)
    keep = np.zeros(n, dtype=bool)
    if n == 0:
        return keep
    codes, n_groups = first_seen_codes(np.asarray(chrom, dtype=object), np.asarray(pos, dtype=np.int64),
                                       np.asarray(ref, dtype=object), np.asarray(alt, dtype=object))
    first = np.full(n_groups, n, dtype=np.int64)
    np.minimum.at(first, codes, np.arange(n))
    keep[first] = True
    return keep


def run(argv) -> int:
    """Remove duplicate records (same CHROM/POS/REF/ALT)."""
    args = parse_args(argv)
    table = read_vcf(args.input)
    keep = first_occurrences(table.chrom, table.pos, table.ref, table.alt)
    write_vcf(args.output, table.subset(keep), qual_as_read=False)
    log.info("%d records, %d duplicates removed -> %s", len(table), int((~keep).sum()), args.output)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
