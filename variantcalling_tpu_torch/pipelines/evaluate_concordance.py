"""evaluate_concordance: precision and recall of a compared callset.

Counterpart of ``variantcalling_tpu/pipelines/evaluate_concordance.py``,
with the same arguments plus ``--backend gpu|cpu`` (default ``gpu``: the
card; asking for it without one exits 2). It reads a concordance frame
(an h5 of ``run_comparison``) and writes:

- ``<prefix>.h5``: ``optimal_recall_precision`` (per category tp, fp, fn,
  precision, recall and f1 at the filter's operating point) and
  ``recall_precision_curve`` (per category the score sweep and its max-F1
  ``threshold``);
- ``<prefix>.stats.csv`` (``;``-separated) and ``<prefix>.thresholds.csv``
  (``group``, ``threshold``), the bytes pandas' ``to_csv`` writes;
- with ``--output_bed``, ``<prefix>_{fp,fn,tp}.bed``.

The per-category tally runs on the run's device
(:func:`concordance_utils.calc_accuracy_metrics`); the curves are host
numpy, as in the reference. Each stage's host seconds are logged as the
filter's are (``utils.stages.STAGE_LOG``).
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.concordance.concordance_utils import calc_accuracy_metrics, calc_recall_precision_curve
from variantcalling_tpu_torch.io import hdf5
from variantcalling_tpu_torch.io.bed import BedWriter
from variantcalling_tpu_torch.utils.stages import stage
from variantcalling_tpu_torch.utils.h5_utils import CONCORDANCE_SKIP_KEYS, Frame, read_hdf, write_hdf

log = logging.getLogger(__name__)


def parse_args(argv: list[str]):
    ap = argparse.ArgumentParser(prog="evaluate_concordance", description=run.__doc__)
    ap.add_argument("--input_file", required=True, help="Input concordance h5 file")
    ap.add_argument("--output_prefix", required=True, help="Prefix to output files")
    ap.add_argument("--dataset_key", default="all", help="h5 dataset name, such as chromosome name")
    ap.add_argument("--score_key", default="tree_score", help="column for calculating the score")
    ap.add_argument("--ignore_genotype", action="store_true", help="ignore genotype when comparing to ground-truth")
    ap.add_argument("--ignore_filters", default="HPOL_RUN", help="comma separated list of filters to ignore")
    ap.add_argument("--output_bed", action="store_true", help="output bed files of fp/fn/tp per variant type")
    ap.add_argument("--use_for_group_testing", type=str, default=None, help="Column to use for grouping")
    ap.add_argument("--verbosity", default="INFO")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def bed_files_output(df: Frame, prefix: str, classify_column: str) -> None:
    """``<prefix>_{fp,fn,tp}.bed``: one 1-base interval a variant of that class
    (the lines :class:`BedWriter` writes, joined and written at once)."""
    classes = np.asarray(df[classify_column]).astype(str)
    chrom, pos = np.asarray(df["chrom"]), np.asarray(df["pos"], dtype=np.int64)
    for cls in ("fp", "fn", "tp"):
        sel = classes == cls
        with open(f"{prefix}_{cls}.bed", "w") as fh:
            fh.write("".join(f"{c}\t{p - 1}\t{p}\n" for c, p in zip(chrom[sel].tolist(), pos[sel].tolist())))


def run(argv: list[str]) -> int:
    """Calculate precision and recall for compared HDF5."""
    args = parse_args(argv)
    logging.getLogger("variantcalling_tpu_torch").setLevel(getattr(logging, args.verbosity))
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    try:
        return _run(args, device)
    except hdf5.H5Unsupported as e:
        log.error("%s", e)
        return 2


def _run(args, device) -> int:
    with stage("ingest"):
        skip = CONCORDANCE_SKIP_KEYS if args.dataset_key == "all" else []
        df = read_hdf(args.input_file, key=args.dataset_key, skip_keys=skip)
    score_column = args.score_key.lower()
    if score_column not in df or bool(np.all(np.isnan(np.asarray(df[score_column], dtype=float)))):
        df[score_column] = 1
        log.warning("No %s field in comparison hdf input, expect invalid recall/precision curves", score_column)
    df["tree_score"] = df[score_column]
    classify_column = "classify" if args.ignore_genotype else "classify_gt"
    if classify_column not in df:  # single-classification frames
        classify_column = "classify"
    ignored = args.ignore_filters.split(",")

    with stage("tally"):
        accuracy = calc_accuracy_metrics(df, classify_column, ignored, args.use_for_group_testing, device=device)
    with stage("curve"):
        curve = calc_recall_precision_curve(df, classify_column, ignored, args.use_for_group_testing)
    with stage("writes"):
        write_hdf(accuracy, f"{args.output_prefix}.h5", key="optimal_recall_precision", mode="w")
        accuracy.to_csv(f"{args.output_prefix}.stats.csv", sep=";")
        write_hdf(curve, f"{args.output_prefix}.h5", key="recall_precision_curve", mode="a")
        curve.select(["group", "threshold"]).to_csv(f"{args.output_prefix}.thresholds.csv")
        if args.output_bed:
            bed_files_output(df, args.output_prefix, classify_column)
    log.info("evaluated %d variants in %d categories on %s", len(df), len(accuracy), device)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
