"""process_merge_context_no_cp_g: non-CpG (CHG/CHH) methylation metrics.

Counterpart of
``variantcalling_tpu/pipelines/methylation/process_merge_context_no_cp_g.py``
with its arguments plus ``--backend gpu|cpu``: the reductions of
``process_merge_context`` without strand merging (non-CpG contexts are not
palindromic).
"""

from __future__ import annotations

import logging
import sys

from variantcalling_tpu_torch.methyl import read_extract_bedgraph
from variantcalling_tpu_torch.pipelines.methylation.process_merge_context import parse_args, process, resolve
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)


def run(argv) -> int:
    """Non-CpG-context methylation metrics (no strand merge)."""
    args = parse_args(argv, prog="process_merge_context_no_cp_g")
    device = resolve(args)
    if device is None:
        return 2
    with stage("ingest"):
        df = read_extract_bedgraph(args.input)
    process(df, args.output, args.merged_bedgraph, merge_strands=False, device=device)
    log.info("non-CpG metrics -> %s", args.output)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
