"""srsnv_inference: annotate a featuremap with per-read SNV qualities.

Counterpart of ``variantcalling_tpu/pipelines/srsnv/srsnv_inference.py``
with its arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card;
asking for it without one exits 2). Every read is scored by the trained
forest (:func:`models.forest.predict_score`: margins by the ``cuda-wide``
kernel on the card, the gather walk on the CPU, the sigmoid on the host
as the reference's jitted program computes it), and the featuremap is
written back with ``ML_QUAL``, the phred of the model's error probability
(capped at 60, rounded to 2 places, in the reference's numpy dtype), in
INFO: the quantity MRD analyses threshold on.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.io.featuremap import feature_matrix, frame_from_table
from variantcalling_tpu_torch.io.vcf import read_vcf, write_vcf
from variantcalling_tpu_torch.models import registry
from variantcalling_tpu_torch.models.forest import predict_score, validate_strategy_env, with_feature_order
from variantcalling_tpu_torch.pipelines.srsnv.srsnv_training import MODEL_NAME
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)

MAX_PHRED = 60.0


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="srsnv_inference", description=run.__doc__)
    ap.add_argument("--featuremap", required=True)
    ap.add_argument("--model", required=True, help="srsnv_training output pkl")
    ap.add_argument("--model_name", default=MODEL_NAME)
    ap.add_argument("--output_featuremap", required=True)
    ap.add_argument("--reference", default=None)
    ap.add_argument("--verbosity", default="INFO")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def ml_qual(scores: np.ndarray) -> np.ndarray:
    """Phred of ``1 - score``, clipped to [1e-6, 1] and capped at 60: the
    reference's numpy operations on its float32 scores."""
    p_err = np.clip(1.0 - scores, 10 ** (-MAX_PHRED / 10), 1.0)
    return np.minimum(-10.0 * np.log10(p_err), MAX_PHRED)


def run(argv) -> int:
    """Score a featuremap's reads with the single-read SNV model."""
    args = parse_args(argv)
    try:
        knobs.validate_all()
        validate_strategy_env()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    model = registry.load_model(args.model, args.model_name)
    feats = model.feature_names
    with stage("ingest"):
        table = read_vcf(args.featuremap, numeric_info=True)
        df = frame_from_table(table, ref_fasta=args.reference)
    missing = [f for f in feats if f not in df.columns]
    if missing:
        raise SystemExit(f"featuremap lacks model features {missing}")
    x = np.nan_to_num(feature_matrix(df, feats))
    model = with_feature_order(model, feats)
    with stage("score", device):
        qual = ml_qual(predict_score(model, x, device, jit=True))
    with stage("writeback"):
        table.header.ensure_info("ML_QUAL", "1", "Float", "Single-read SNV model quality (phred)")
        write_vcf(args.output_featuremap, table, extra_info={"ML_QUAL": np.round(qual, 2)}, verbatim_core=True,
                  qual_as_read=False)
    log.info("scored %d reads (median ML_QUAL %.1f) -> %s", len(table),
             float(np.median(qual)) if len(table) else 0.0, args.output_featuremap)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
