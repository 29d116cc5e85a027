"""process_merge_context: CpG-context methylation metrics (strand-merged).

Counterpart of
``variantcalling_tpu/pipelines/methylation/process_merge_context.py`` with
its arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card; asking
for it without one exits 2). Merges +/- strand CpG rows (``--mergeContext``
semantics), then reduces genome-wide metrics on the run's device: the
methylation-fraction histogram, coverage x methylation stats, the global
summary. Output: h5 keys ``summary``, ``histogram``, ``coverage_stats``,
and optionally the merged bedGraph.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.methyl import (
    coverage_methylation_stats,
    global_methylation_summary,
    merge_cpg_strands,
    methylation_histogram,
    read_extract_bedgraph,
)
from variantcalling_tpu_torch.utils.h5_utils import Frame, write_frames
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)


def parse_args(argv, prog="process_merge_context"):
    ap = argparse.ArgumentParser(prog=prog, description=run.__doc__)
    ap.add_argument("--input", required=True, help="MethylDackel extract bedGraph (CpG context)")
    ap.add_argument("--output", required=True, help="metrics h5")
    ap.add_argument("--merged_bedgraph", help="also write the strand-merged bedGraph here")
    ap.add_argument("--verbosity", default="INFO")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def process(df: Frame, output: str, merged_bedgraph: str | None, merge_strands: bool, device) -> None:
    if merge_strands:
        with stage("merge"):
            df = merge_cpg_strands(df)
    if merged_bedgraph:
        with stage("bedgraph"):
            df.to_csv(merged_bedgraph, sep="\t", header=False)
    nm, nu = np.asarray(df["n_meth"]), np.asarray(df["n_unmeth"])
    with stage("reduce", device):
        hist = methylation_histogram(nm, nu, device=device)
        cov_stats = coverage_methylation_stats(nm, nu, device=device)
    write_frames(output, {"summary": global_methylation_summary(df),
                          "histogram": Frame({"bin": np.arange(len(hist)), "n_sites": hist}),
                          "coverage_stats": cov_stats})


def resolve(args):
    """The run's device, or None (the error logged: exit 2)."""
    try:
        knobs.validate_all()
        return device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return None


def run(argv) -> int:
    """CpG-context methylation metrics with strand merging."""
    args = parse_args(argv)
    device = resolve(args)
    if device is None:
        return 2
    with stage("ingest"):
        df = read_extract_bedgraph(args.input)
    process(df, args.output, args.merged_bedgraph, merge_strands=True, device=device)
    log.info("merge-context metrics -> %s", args.output)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
