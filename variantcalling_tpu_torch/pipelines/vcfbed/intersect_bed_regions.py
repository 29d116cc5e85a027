"""intersect_bed_regions — intersect N BED files into one merged BED.

Counterpart of ``variantcalling_tpu/pipelines/vcfbed/intersect_bed_regions.py``,
with the same arguments (a host tool: no ``--backend``): the merged
intersection of the ``--include-regions`` BEDs, less each
``--exclude-regions`` BED, by the sorted-interval sweeps of
``io/bed.IntervalSet``.
"""

from __future__ import annotations

import argparse
import logging
import sys

from variantcalling_tpu_torch.io.bed import read_bed, write_bed

log = logging.getLogger(__name__)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="intersect_bed_regions", description=run.__doc__)
    ap.add_argument("--include-regions", nargs="+", required=True, help="BEDs to intersect")
    ap.add_argument("--exclude-regions", nargs="*", default=None, help="BEDs to subtract")
    ap.add_argument("--output-bed", required=True)
    return ap.parse_args(argv)


def run(argv) -> int:
    """Intersect (and optionally subtract) BED files."""
    args = parse_args(argv)
    acc = read_bed(args.include_regions[0]).merged()
    for path in args.include_regions[1:]:
        acc = acc.intersect(read_bed(path).merged())
    for path in args.exclude_regions or []:
        acc = acc.subtract(read_bed(path).merged())
    write_bed(args.output_bed, acc)
    log.info("%d intervals (%d bp) -> %s", len(acc), acc.total_length(), args.output_bed)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
