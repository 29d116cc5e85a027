"""compress_gvcf: shrink a gVCF by merging similar sequential records.

Counterpart of ``variantcalling_tpu/pipelines/compress_gvcf.py``, with the
same arguments (``--input_path --output_path --refcall_gq_threshold
--merge_gq_threshold``) and output bytes; the algorithm is
:func:`variantcalling_tpu_torch.joint.gvcf.compress_gvcf_table`. Host-only:
no device program, so no ``--backend``.
"""

from __future__ import annotations

import argparse
import sys

from variantcalling_tpu_torch.joint.gvcf import compress_gvcf


def parse_args(argv: list[str]):
    ap = argparse.ArgumentParser(prog="compress_gvcf", description="Compress GVCF file by merging similar rows")
    ap.add_argument("--input_path", required=True, help="Input gvcf file path")
    ap.add_argument("--output_path", required=True, help="Output gvcf file path")
    ap.add_argument("--refcall_gq_threshold", type=int, default=22,
                    help="Keep RefCall records with GQ<refcall_threshold and not merge them")
    ap.add_argument("--merge_gq_threshold", type=int, default=10,
                    help="Merge records whose GQ stays within this band of the group")
    return ap.parse_args(argv)


def run(argv: list[str]) -> int:
    args = parse_args(argv)
    n_in, n_out = compress_gvcf(args.input_path, args.output_path, args.refcall_gq_threshold, args.merge_gq_threshold)
    sys.stderr.write(f"Compressed {n_in} into {n_out} records\n")
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
