"""sorter_stats_to_mean_coverage — the mean coverage from the sorter's JSON.

Counterpart of ``variantcalling_tpu/pipelines/misc/sorter_stats_to_mean_coverage.py``,
with the same arguments (a host tool: no ``--backend``): the JSON's mean
coverage, or its aligned bases over the genome length, written rounded as a
bare integer (a downsampling input).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

log = logging.getLogger(__name__)

HUMAN_GENOME_BP = 3_100_000_000


def mean_coverage(stats: dict, genome_length: int = HUMAN_GENOME_BP) -> float:
    for key in ("mean_coverage", "mean_cvg", "coverage"):
        if key in stats:
            return float(stats[key])
    aligned = None
    for key in ("aligned_bases", "pf_aligned_bases", "base_count", "total_bases"):
        if key in stats:
            aligned = float(stats[key])
            break
    if aligned is None:
        raise KeyError("no coverage/aligned-bases field in sorter stats")
    return aligned / genome_length


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="sorter_stats_to_mean_coverage", description=run.__doc__)
    ap.add_argument("--input_sorter_stats_json", required=True)
    ap.add_argument("--output_file", required=True, help="text file holding the rounded mean coverage")
    ap.add_argument("--genome_length", type=int, default=HUMAN_GENOME_BP)
    return ap.parse_args(argv)


def run(argv) -> int:
    """Mean coverage from sorter stats json."""
    args = parse_args(argv)
    with open(args.input_sorter_stats_json) as fh:
        stats = json.load(fh)
    cov = mean_coverage(stats, args.genome_length)
    with open(args.output_file, "w") as fh:
        fh.write(f"{round(cov)}\n")
    log.info("mean coverage %.2f -> %s", cov, args.output_file)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
