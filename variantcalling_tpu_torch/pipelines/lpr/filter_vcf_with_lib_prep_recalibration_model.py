"""filter_vcf_with_lib_prep_recalibration_model: re-score a VCF with an LPR model.

Counterpart of
``variantcalling_tpu/pipelines/lpr/filter_vcf_with_lib_prep_recalibration_model.py``
with its arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card;
asking for it without one exits 2). Every featuremap read is scored by the
trained forest (:func:`models.forest.predict_score`: margins by the
``cuda-wide`` kernel on the card, the gather walk on the CPU, the sigmoid
on the host as the reference's eager program computes it); the top-N read
scores of each allele are averaged (pandas' unstable descending quicksort,
``groupby(sort=False).head``, then its compensated float32 mean, replayed
by :mod:`utils.frame_ops`) into ``scored_alleles<suffix>.parquet``; the
calls VCF is written with ``LPR_SCORE`` to ``recalibrated<suffix>.vcf.gz``
and its ``.tbi``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.io.featuremap import feature_matrix, featuremap_to_dataframe, numeric_feature_columns
from variantcalling_tpu_torch.io.parquet import write_parquet
from variantcalling_tpu_torch.io.vcf import read_vcf, write_vcf
from variantcalling_tpu_torch.models.forest import predict_score, validate_strategy_env
from variantcalling_tpu_torch.models.registry import load_models
from variantcalling_tpu_torch.pipelines.lpr.train_lib_prep_recalibration_model import ALLELE_KEYS
from variantcalling_tpu_torch.utils.frame_ops import first_seen_codes, group_mean_f32, nargsort
from variantcalling_tpu_torch.utils.h5_utils import Frame
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)


def init_parser():
    ap = argparse.ArgumentParser(prog="filter_vcf_with_lib_prep_recalibration_model", description=run.__doc__)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--output_suffix", default="")
    ap.add_argument("--ref_fasta", required=True)
    ap.add_argument("--lib_prep_model_file", required=True)
    ap.add_argument("--calls_vcf", required=True, help="VCF to re-score")
    ap.add_argument("--featuremap_vcf", required=True, help="featuremap intersected on calls")
    ap.add_argument("--top_n_reads", type=int, default=5, help="top read scores aggregated per allele")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap


def aggregate_top_reads(keys: dict[str, np.ndarray], scores: np.ndarray, top_n: int) -> Frame:
    """``df.sort_values("read_score", ascending=False).groupby(keys, sort=False).head(top_n)
    .groupby(keys, sort=False)["read_score"].agg(["mean", "count"])``, renamed and reset: one
    row an allele, in order of its first appearance among the sorted reads (``count``: its
    kept reads with a score)."""
    scores = np.asarray(scores, dtype=np.float32)
    order = nargsort(scores, ascending=False)
    codes, n_groups = first_seen_codes(*(np.asarray(keys[k])[order] for k in ALLELE_KEYS))
    by_group = np.argsort(codes, kind="stable")
    rank_in_group = np.empty(len(codes), dtype=np.int64)
    rank_in_group[by_group] = np.arange(len(codes)) - np.searchsorted(codes[by_group], codes[by_group])
    head = rank_in_group < top_n
    kept, kept_codes = order[head], codes[head]
    groups, first = np.unique(kept_codes, return_index=True)  # the groups left, each one's first kept row
    n_left = len(groups)
    cols = {k: np.asarray(keys[k])[kept[first]] for k in ALLELE_KEYS}
    cols["lpr_score"] = group_mean_f32(scores[kept], kept_codes, n_left)
    cols["n_scored_reads"] = np.bincount(kept_codes[~np.isnan(scores[kept])], minlength=n_left).astype(np.int64)
    return Frame(cols)


def score_alleles(featuremap_df: Frame, forest, top_n: int, device) -> Frame:
    """Per-(chrom,pos,ref,alt) mean of the top-N per-read model scores."""
    features = forest.feature_names or numeric_feature_columns(featuremap_df)
    missing = [f for f in features if f not in featuremap_df.columns]
    if missing:
        # a silently narrowed matrix would misalign the forest's feature indices
        raise ValueError(f"featuremap lacks trained feature columns: {missing}")
    x = np.nan_to_num(feature_matrix(featuremap_df, features), nan=0.0)
    scores = predict_score(forest, x, device)
    return aggregate_top_reads({k: featuremap_df[k] for k in ALLELE_KEYS}, scores, top_n)


def run(argv: list[str]):
    """Filter vcf file using lib-prep recalibration model"""
    args = init_parser().parse_args(argv)
    try:
        knobs.validate_all()
        validate_strategy_env()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    os.makedirs(args.out_dir, exist_ok=True)

    forest = load_models(args.lib_prep_model_file)["lib_prep"]
    with stage("ingest"):
        fm = featuremap_to_dataframe(args.featuremap_vcf, args.ref_fasta)
    with stage("score", device):
        scored = score_alleles(fm, forest, args.top_n_reads, device)
    scored_path = os.path.join(args.out_dir, f"scored_alleles{args.output_suffix}.parquet")
    with stage("writes"):
        write_parquet(scored_path, scored.data)
    log.info("scored %d alleles -> %s", len(scored), scored_path)

    with stage("annotate"):
        calls = read_vcf(args.calls_vcf)
        key_to_score = {(str(c), int(p), r, a): s for c, p, r, a, s in zip(
            *(scored[k].tolist() for k in ALLELE_KEYS), scored["lpr_score"].tolist())}
        chrom, pos, ref, alt = (np.asarray(calls.chrom).tolist(), calls.pos.tolist(), calls.ref.tolist(),
                                calls.alt.tolist())
        lpr = np.full(len(calls), np.nan)
        for i in range(len(calls)):
            s = key_to_score.get((str(chrom[i]), int(pos[i]), ref[i], alt[i].split(",")[0]))
            if s is not None:
                lpr[i] = float(s)
        calls.header.ensure_info("LPR_SCORE", "1", "Float",
                                 "Library-prep recalibration score (mean of top read scores)")
    out_vcf = os.path.join(args.out_dir, f"recalibrated{args.output_suffix}.vcf.gz")
    with stage("writeback"):
        write_vcf(out_vcf, calls, extra_info={"LPR_SCORE": lpr}, verbatim_core=True, qual_as_read=False)
    log.info("wrote %s", out_vcf)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
