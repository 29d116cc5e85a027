"""cleanup_gvcf_before_calling: drop ./. records that overlap called deletions.

Counterpart of ``variantcalling_tpu/pipelines/cleanup_gvcf_before_calling.py``
(the GLNexus joint-calling pre-pass), with the same positional arguments
``input_gvcf output_gvcf`` and output bytes
(:func:`variantcalling_tpu_torch.joint.gvcf.cleanup_gvcf`). Host-only: no
device program, so no ``--backend``.
"""

from __future__ import annotations

import argparse
import sys

from variantcalling_tpu_torch.joint.gvcf import cleanup_gvcf


def run(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="cleanup_gvcf_before_calling", description=__doc__)
    ap.add_argument("input_gvcf")
    ap.add_argument("output_gvcf")
    args = ap.parse_args(argv)
    n_written, n_removed = cleanup_gvcf(args.input_gvcf, args.output_gvcf)
    sys.stderr.write(f"Written {n_written} records, removed {n_removed} records\n")
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
