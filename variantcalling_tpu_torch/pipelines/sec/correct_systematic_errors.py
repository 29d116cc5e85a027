"""correct_systematic_errors: filter callset loci that match the cohort noise.

Counterpart of ``variantcalling_tpu/pipelines/sec/correct_systematic_errors.py``,
with the same arguments plus ``--backend gpu|cpu`` (default ``gpu``: the
card; asking for it without one exits 2). For every call at a DB locus
the batched multinomial likelihood ratio (``sec.caller``, on the run's
device) decides whether its allele counts look like the cohort noise; if
so FILTER gains ``SEC`` and INFO gains the ratio (``SEC_RATIO``, ``%g`` of
its float64 value). The records are written as the reference writes them:
FORMAT and the samples verbatim, QUAL as ``%g`` of its value
(``write_vcf(qual_as_read=False)``); a ``.vcf.gz`` gets its ``.tbi``.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.io import hdf5
from variantcalling_tpu_torch.io.vcf import read_vcf, write_vcf
from variantcalling_tpu_torch.utils.stages import stage
from variantcalling_tpu_torch.sec.caller import DEFAULT_NOISE_RATIO, correct_calls
from variantcalling_tpu_torch.sec.db import SecDb

log = logging.getLogger(__name__)

SEC = "SEC"


def parse_args(argv: list[str]):
    ap = argparse.ArgumentParser(prog="correct_systematic_errors", description=run.__doc__)
    ap.add_argument("--relevant_coords", help="(accepted; DB already carries its loci)")
    ap.add_argument("--model", required=True, help="SEC DB h5 (from sec_training)")
    ap.add_argument("--gvcf", required=True, help="input callset/gVCF")
    ap.add_argument("--output_file", required=True, help="corrected VCF (.vcf/.vcf.gz)")
    ap.add_argument("--noise_ratio_threshold", type=float, default=DEFAULT_NOISE_RATIO)
    ap.add_argument("--verbosity", default="INFO")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def sec_filters(filters, is_sec: np.ndarray) -> np.ndarray:
    """FILTER with ``SEC``: alone where the record passed, appended after ``;`` otherwise."""
    out = np.array(list(filters), dtype=object)
    for i in np.flatnonzero(is_sec).tolist():
        f = out[i]
        out[i] = SEC if f in ("PASS", ".", "", None) else f"{f};{SEC}"
    return out


def run(argv: list[str]) -> int:
    """Correct systematic errors using a cohort noise database."""
    args = parse_args(argv)
    logging.getLogger("variantcalling_tpu_torch").setLevel(getattr(logging, args.verbosity))
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    try:
        db = SecDb.load(args.model)
    except hdf5.H5Unsupported as e:
        log.error("%s", e)
        return 2
    with stage("ingest", device):
        table = read_vcf(args.gvcf)
    with stage("score", device):
        is_sec, ratios = correct_calls(table, db, args.noise_ratio_threshold, device)

    table.header.ensure_filter(SEC, "Matches cohort systematic-error (noise) distribution")
    table.header.ensure_info("SEC_RATIO", "1", "Float", "Noise-vs-best-fit multinomial likelihood ratio")
    extra = {"SEC_RATIO": np.where(is_sec, ratios.astype(np.float64), np.nan)}
    with stage("writeback", device):
        write_vcf(args.output_file, table, new_filters=sec_filters(table.filters, is_sec), extra_info=extra,
                  qual_as_read=False)
    log.info("%d/%d records marked %s -> %s on %s", int(is_sec.sum()), len(table), SEC, args.output_file, device)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
