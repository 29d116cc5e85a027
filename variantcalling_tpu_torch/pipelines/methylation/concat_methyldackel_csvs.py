"""concat_methyldackel_csvs: merge per-shard MethylDackel extract outputs.

Counterpart of
``variantcalling_tpu/pipelines/methylation/concat_methyldackel_csvs.py``
with its arguments (host code only, so no ``--backend``): the shards are
read as the reference reads them (:func:`methyl.read_extract_bedgraph`),
concatenated, duplicate sites summed, sorted by (chrom, start), and written
as pandas' ``to_csv(sep="\\t", index=False, header=False)`` writes them.
"""

from __future__ import annotations

import argparse
import logging
import sys

from variantcalling_tpu_torch.methyl import concat_extracts, read_extract_bedgraph

log = logging.getLogger(__name__)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="concat_methyldackel_csvs", description=run.__doc__)
    ap.add_argument("--inputs", nargs="+", required=True, help="per-shard extract bedGraph/CSV files")
    ap.add_argument("--output", required=True, help="merged CSV")
    ap.add_argument("--verbosity", default="INFO")
    return ap.parse_args(argv)


def run(argv) -> int:
    """Concatenate and sort MethylDackel extract shards."""
    args = parse_args(argv)
    df = concat_extracts([read_extract_bedgraph(p) for p in args.inputs])
    df.to_csv(args.output, sep="\t", header=False)
    log.info("%d sites from %d shards -> %s", len(df), len(args.inputs), args.output)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
