"""srsnv_training: train the single-read SNV quality model.

Counterpart of ``variantcalling_tpu/pipelines/srsnv/srsnv_training.py``
with its arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card;
asking for it without one exits 2). True-variant reads (the TP featuremap)
against error reads (the FP featuremap): the per-read features
(:mod:`io.featuremap`) are split by a seeded permutation, the boosted
forest is fitted by :func:`models.boosting.fit` (on the card: the torch
program, its histograms by the hand-written ``gbt_hist`` kernel, one launch
a level; on the CPU the native trainer, as the reference fits there), the
held-out AUC is logged from :func:`models.forest.predict_score` (on the
card the ``cuda-wide`` kernel), and the model is pickled under
``srsnv_model`` in the file the reference's ``load_model`` reads.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.io.featuremap import feature_matrix, featuremap_to_dataframe, numeric_feature_columns
from variantcalling_tpu_torch.models import registry
from variantcalling_tpu_torch.models.boosting import BoostConfig, fit
from variantcalling_tpu_torch.models.forest import predict_score
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)

# featuremap_to_dataframe lowercases INFO keys into column names
DEFAULT_FEATURES = ["x_score", "x_edist", "x_length", "x_mapq", "x_index", "rq"]
MODEL_NAME = "srsnv_model"
#: the log record of the held-out AUC (its value, then the held-out reads)
AUC_LOG = "held-out AUC = %.4f (%d reads)"


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="srsnv_training", description=run.__doc__)
    ap.add_argument("--tp_featuremap", required=True, help="featuremap of true-variant supporting reads")
    ap.add_argument("--fp_featuremap", required=True, help="featuremap of error reads")
    ap.add_argument("--reference", default=None, help="FASTA for motif columns")
    ap.add_argument("--output_model", required=True, help="output model pkl")
    ap.add_argument("--features", nargs="*", default=None, help="feature columns (default: measured set)")
    ap.add_argument("--n_trees", type=int, default=100)
    ap.add_argument("--max_depth", type=int, default=6)
    ap.add_argument("--learning_rate", type=float, default=0.15)
    ap.add_argument("--train_fraction", type=float, default=0.8)
    ap.add_argument("--random_seed", type=int, default=0)
    ap.add_argument("--verbosity", default="INFO")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def build_training_frame(tp_fm: str, fp_fm: str, reference: str | None, features: list[str] | None):
    tp = featuremap_to_dataframe(tp_fm, ref_fasta=reference)
    fp = featuremap_to_dataframe(fp_fm, ref_fasta=reference)
    feats = features or [f for f in DEFAULT_FEATURES if f in tp.columns and f in fp.columns]
    if not feats:
        feats = sorted(set(numeric_feature_columns(tp)) & set(numeric_feature_columns(fp)))
    x = np.concatenate([feature_matrix(tp, feats), feature_matrix(fp, feats)])
    y = np.concatenate([np.ones(len(tp)), np.zeros(len(fp))]).astype(np.float32)
    return np.nan_to_num(x), y, feats


def run(argv) -> int:
    """Train the single-read SNV quality GBT on device."""
    args = parse_args(argv)
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    with stage("ingest"):
        x, y, feats = build_training_frame(args.tp_featuremap, args.fp_featuremap, args.reference, args.features)
    rng = np.random.default_rng(args.random_seed)
    order = rng.permutation(len(y))
    n_train = int(len(y) * args.train_fraction)
    tr, te = order[:n_train], order[n_train:]
    cfg = BoostConfig(n_trees=args.n_trees, depth=args.max_depth, learning_rate=args.learning_rate)
    with stage("fit", device):
        model = fit(x[tr], y[tr], cfg=cfg, feature_names=feats, device=device)
    if len(te):
        with stage("score"):
            s = predict_score(model, x[te], device)
        log.info(AUC_LOG, _auc(y[te], s), len(te))
    with stage("save"):
        registry.save_models(args.output_model, {MODEL_NAME: model})
    log.info("srsnv model (%d trees on %s) -> %s", args.n_trees, feats, args.output_model)
    return 0


def _auc(y: np.ndarray, s: np.ndarray) -> float:
    order = np.argsort(s)
    ranks = np.empty(len(s))
    ranks[order] = np.arange(1, len(s) + 1)
    n_pos = int(y.sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
