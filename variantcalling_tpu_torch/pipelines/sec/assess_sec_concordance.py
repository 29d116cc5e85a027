"""assess_sec_concordance: the accuracy effect of SEC correction.

Counterpart of ``variantcalling_tpu/pipelines/sec/assess_sec_concordance.py``,
with the same arguments plus ``--backend gpu|cpu`` (default ``gpu``: the
card; asking for it without one exits 2). Given a concordance frame (a
``run_comparison_pipeline`` h5) and the SEC-corrected callset, the
accuracy metrics are computed with and without the SEC re-filter (SEC
turns a corrected tp into an fn and drops a corrected fp), each tally on
the run's device (``concordance_utils.calc_accuracy_metrics``), and their
difference a category. Three keys are written: ``without_sec``,
``with_sec`` and ``delta``.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.concordance.concordance_utils import calc_accuracy_metrics
from variantcalling_tpu_torch.io import hdf5
from variantcalling_tpu_torch.io.vcf import read_vcf
from variantcalling_tpu_torch.utils.stages import stage
from variantcalling_tpu_torch.utils.h5_utils import Frame, read_hdf, write_frames

log = logging.getLogger(__name__)

SEC = "SEC"


def parse_args(argv: list[str]):
    ap = argparse.ArgumentParser(prog="assess_sec_concordance", description=run.__doc__)
    ap.add_argument("--concordance_h5", required=True, help="run_comparison_pipeline output h5")
    ap.add_argument("--hdf_key", default="all")
    ap.add_argument("--corrected_vcf", required=True, help="SEC-corrected callset (correct_systematic_errors)")
    ap.add_argument("--output_file", required=True, help="assessment h5 (keys: with_sec, without_sec, delta)")
    ap.add_argument("--classify_column", default="classify")
    ap.add_argument("--ignore_filters", nargs="*", default=["HPOL_RUN"])
    ap.add_argument("--verbosity", default="INFO")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def mark_sec_from_vcf(df: Frame, corrected_vcf: str) -> np.ndarray:
    """Bool per concordance row: its locus carries SEC in the corrected callset."""
    table = read_vcf(corrected_vcf)
    sec_loci = {
        (c, int(p))
        for c, p, f in zip(table.chrom, table.pos, table.filters)
        if f and SEC in str(f).split(";")
    }
    chrom = [str(c) for c in df["chrom"]]
    return np.fromiter(((c, int(p)) in sec_loci for c, p in zip(chrom, df["pos"])), dtype=bool, count=len(df))


def apply_sec_refilter(df: Frame, is_sec: np.ndarray, classify_column: str) -> Frame:
    """The report-side SEC semantics: corrected tps become fns (the call is
    suppressed but the truth remains); corrected fps leave the callset."""
    out = Frame(dict(df.data), df.index)
    cls = np.asarray([str(v) for v in df[classify_column]], dtype=object)
    drop = is_sec & (cls == "fp")
    cls[is_sec & (cls == "tp")] = "fn"
    out[classify_column] = cls
    return out.take(~drop)


def assess(df: Frame, is_sec: np.ndarray, classify_column: str, ignore_filters: list[str],
           device) -> dict[str, Frame]:
    before = calc_accuracy_metrics(df, classify_column, ignore_filters, device=device)
    after = calc_accuracy_metrics(apply_sec_refilter(df, is_sec, classify_column), classify_column, ignore_filters,
                                  device=device)
    # the reference's inner merge on ``group``, in the order of ``before``
    row = {g: i for i, g in enumerate(after["group"])}
    keep = np.asarray([g in row for g in before["group"]], dtype=bool)
    b = before.take(keep)
    a = after.take(np.asarray([row[g] for g in b["group"]], dtype=np.int64))
    delta = Frame({
        "group": b["group"],
        "fp_removed": b["fp"] - a["fp"],
        "tp_lost": b["tp"] - a["tp"],
        "precision_delta": a["precision"] - b["precision"],
        "recall_delta": a["recall"] - b["recall"],
        "f1_delta": a["f1"] - b["f1"],
    })
    return {"without_sec": before, "with_sec": after, "delta": delta}


def run(argv: list[str]) -> int:
    """Assess SEC correction against ground-truth concordance."""
    args = parse_args(argv)
    logging.getLogger("variantcalling_tpu_torch").setLevel(getattr(logging, args.verbosity))
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
        df = read_hdf(args.concordance_h5, key=args.hdf_key)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable, hdf5.H5Unsupported) as e:
        log.error("%s", e)
        return 2
    with stage("assess", device):
        is_sec = mark_sec_from_vcf(df, args.corrected_vcf)
        results = assess(df, is_sec, args.classify_column, args.ignore_filters, device)
    write_frames(args.output_file, results)
    d = results["delta"]
    log.info("SEC effect: removed %d FPs, lost %d TPs -> %s on %s", int(d["fp_removed"].sum()),
             int(d["tp_lost"].sum()), args.output_file, device)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
