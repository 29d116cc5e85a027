"""process_per_read: per-read methylation distribution metrics.

Counterpart of ``variantcalling_tpu/pipelines/methylation/process_per_read.py``
with its arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card;
asking for it without one exits 2). MethylDackel's perRead rows (read,
chrom, pos, meth_fraction, n_sites) read as the reference reads them
(``#`` comments), reads below ``--min_sites`` dropped, the per-read
methylation histogram reduced on the run's device and the summary computed
with the reference's numpy calls.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch.methyl import methylation_histogram
from variantcalling_tpu_torch.pipelines.methylation.process_merge_context import resolve
from variantcalling_tpu_torch.utils.frame_ops import read_tsv, take_rows, to_numeric
from variantcalling_tpu_torch.utils.h5_utils import Frame, write_frames
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)

PER_READ_COLS = ["read", "chrom", "pos", "meth_fraction", "n_sites"]


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="process_per_read", description=run.__doc__)
    ap.add_argument("--input", required=True, help="MethylDackel perRead output")
    ap.add_argument("--output", required=True, help="metrics h5")
    ap.add_argument("--min_sites", type=int, default=1, help="ignore reads with fewer CpG sites")
    ap.add_argument("--verbosity", default="INFO")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def run(argv) -> int:
    """Per-read methylation metrics."""
    args = parse_args(argv)
    device = resolve(args)
    if device is None:
        return 2
    with stage("ingest"):
        df = Frame(read_tsv(args.input, PER_READ_COLS, comment=b"#"))
        df = take_rows(df, ~np.isnan(to_numeric(df["meth_fraction"], coerce=True).astype(np.float64)))
        df["meth_fraction"] = to_numeric(df["meth_fraction"])
        df["n_sites"] = to_numeric(df["n_sites"])
        df = take_rows(df, df["n_sites"] >= args.min_sites)
    frac = np.asarray(df["meth_fraction"])
    with stage("reduce", device):
        # the fraction histogram: frac == nm/(nm+nu) with unit mass
        hist = methylation_histogram(frac, 1.0 - frac, device=device)
    n = len(df)
    summary = {"n_reads": n, "mean_read_methylation": round(float(frac.mean()) if n else 0.0, 5),
               "median_read_methylation": round(float(np.median(frac)) if n else 0.0, 5),
               "mean_sites_per_read": round(float(np.mean(df["n_sites"])) if n else 0.0, 3)}
    write_frames(args.output, {"histogram": Frame({"bin": np.arange(len(hist)), "n_reads": hist}),
                               "summary": Frame({k: np.array([v]) for k, v in summary.items()})})
    log.info("per-read metrics (%d reads) -> %s", n, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
