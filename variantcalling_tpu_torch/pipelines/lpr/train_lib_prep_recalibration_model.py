"""train_lib_prep_recalibration_model: train a per-read SNV recalibration model.

Counterpart of
``variantcalling_tpu/pipelines/lpr/train_lib_prep_recalibration_model.py``
with its arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card;
asking for it without one exits 2). A labeled featuremap training set:
TP reads at loci with AF >= ``--tp_min_af``, FP reads at loci with AF <=
``--fp_max_af``, where AF = supporting reads / ``X_READ_COUNT`` (on the
calls VCF's PASS biallelic SNVs where one is given); optionally balanced
by label and by reference motif; written to
``labeled_featuremap_training_set.parquet`` (:mod:`io.parquet`); then the
boosted forest is fitted (:func:`models.boosting.fit`: on the card the
torch program with the ``gbt_hist`` kernel) and pickled as
``lib_prep_model<suffix>.npz``, the name the reference pickles under.

The reference's pandas steps are replayed without pandas, in its row
order: ``groupby(sort=False).size()`` merged back onto the rows (the left
order kept), ``replace(0, nan)``, the TP rows then the FP rows, and
``balance``'s ``groupby(...)`` groups in sorted key order, each sampled as
``DataFrame.sample(n, random_state=int)`` samples (:mod:`utils.frame_ops`).
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
from variantcalling_tpu_torch.models import boosting
from variantcalling_tpu_torch.models.registry import save_models
from variantcalling_tpu_torch.utils.frame_ops import concat_rows, first_seen_codes, sample_positions, sorted_codes, \
    take_rows
from variantcalling_tpu_torch.utils.h5_utils import Frame
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)

ALLELE_KEYS = ("chrom", "pos", "ref", "alt")


def init_parser():
    ap = argparse.ArgumentParser(prog="train_lib_prep_recalibration_model", description=run.__doc__)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--ref_fasta", required=True)
    ap.add_argument("--featuremap_vcf", help="full featuremap vcf file")
    ap.add_argument("--calls_vcf", help="variant calling vcf file (calibrate on pass-filter events)")
    ap.add_argument("--tp_min_af", type=float, default=0.9, help="min allele-frequency to consider a variant tp")
    ap.add_argument("--fp_max_af", type=float, default=0.04, help="max allele-frequency to consider a variant fp")
    ap.add_argument("--output_suffix", default="")
    ap.add_argument("--balance_motifs", default=False, action="store_true")
    ap.add_argument("--balance_tp_fp", default=False, action="store_true")
    ap.add_argument("--n_trees", type=int, default=100)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap


def label_by_allele_frequency(df: Frame, tp_min_af: float, fp_max_af: float) -> Frame:
    """Label featuremap reads by locus AF = reads-at-locus / X_READ_COUNT."""
    if "x_read_count" not in df.columns:
        raise ValueError("featuremap lacks X_READ_COUNT; cannot estimate AF")
    codes, n_groups = first_seen_codes(*(df[k] for k in ALLELE_KEYS))
    out = Frame(dict(df.data))
    out["n_supporting"] = np.bincount(codes, minlength=n_groups).astype(np.int64)[codes]
    read_count = np.asarray(df["x_read_count"], dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        out["af"] = out["n_supporting"] / np.where(read_count == 0, np.nan, read_count)
    tp = take_rows(out, out["af"] >= tp_min_af)
    fp = take_rows(out, out["af"] <= fp_max_af)
    tp["label"] = np.ones(len(tp), dtype=bool)
    fp["label"] = np.zeros(len(fp), dtype=bool)
    return concat_rows([tp, fp])


def _sampled_groups(df: Frame, codes: np.ndarray, n_groups: int, size_of, rng: np.random.Generator) -> Frame:
    """``pd.concat([g.sample(n=size_of(len(g)), random_state=int(rng.integers(1 << 31))) for g in groups],
    ignore_index=True)`` over the groups numbered by ``codes``, in that order."""
    take = []
    for g in range(n_groups):
        rows = np.flatnonzero(codes == g)
        if len(rows):
            take.append(rows[sample_positions(len(rows), size_of(len(rows)), int(rng.integers(1 << 31)))])
    return take_rows(df, np.concatenate(take) if take else np.zeros(0, dtype=np.intp))


def balance(df: Frame, by_motif: bool, tp_fp: bool, seed: int = 0) -> Frame:
    rng = np.random.default_rng(seed)
    if tp_fp:
        labels, codes = sorted_codes(df["label"])
        n = int(np.bincount(codes).min()) if len(codes) else 0
        df = _sampled_groups(df, codes, len(labels), lambda _: n, rng)
    if by_motif and "ref_motif" in df.columns:
        motifs, codes = sorted_codes(df["ref_motif"])
        sizes = np.bincount(codes, minlength=len(motifs))
        n = max(1, int(np.median(sizes))) if len(sizes) else 1
        df = _sampled_groups(df, codes, len(motifs), lambda size: min(n, size), rng)
    return df


def _pass_snvtake_rows(df: Frame, calls_vcf: str) -> np.ndarray:
    """The featuremap rows at a (chrom, pos) of a PASS biallelic SNV of the calls VCF."""
    from variantcalling_tpu_torch.io.vcf import read_vcf

    calls = read_vcf(calls_vcf, drop_format=True)
    filt, ref, alt = calls.filters.tolist(), calls.ref.tolist(), calls.alt.tolist()
    keep = [i for i in range(len(calls)) if filt[i] in ("PASS", ".", "") and len(ref[i]) == 1
            and "," not in alt[i] and len(alt[i]) == 1]
    chroms = np.asarray(calls.chrom)[keep]
    ids = {c: i for i, c in enumerate(dict.fromkeys(chroms.tolist()))}
    call_keys = np.unique(np.array([ids[c] for c in chroms.tolist()], dtype=np.int64) << 32
                          | calls.pos[keep].astype(np.int64))
    fm_ids = np.array([ids.get(c, -1) for c in np.asarray(df["chrom"]).tolist()], dtype=np.int64)
    return (fm_ids >= 0) & np.isin((fm_ids << 32) | np.asarray(df["pos"], dtype=np.int64), call_keys)


def run(argv: list[str]):
    """Lib-prep recalibration model training pipeline"""
    args = init_parser().parse_args(argv)
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    os.makedirs(args.out_dir, exist_ok=True)

    with stage("ingest"):
        df = featuremap_to_dataframe(args.featuremap_vcf, args.ref_fasta)
    with stage("label"):
        if args.calls_vcf:
            df = take_rows(df, _pass_snvtake_rows(df, args.calls_vcf))
        labeled = label_by_allele_frequency(df, args.tp_min_af, args.fp_max_af)
        labeled = balance(labeled, args.balance_motifs, args.balance_tp_fp)
    training_set = os.path.join(args.out_dir, "labeled_featuremap_training_set.parquet")
    with stage("writes"):
        write_parquet(training_set, labeled.data)
    n_tp = int(labeled["label"].sum())
    log.info("labeled training set: %d reads (%d tp, %d fp) -> %s", len(labeled), n_tp, len(labeled) - n_tp,
             training_set)

    features = numeric_feature_columns(labeled)
    if not features:
        raise ValueError("no numeric evidence columns found in featuremap")
    x = np.nan_to_num(feature_matrix(labeled, features), nan=0.0)
    y = np.asarray(labeled["label"], dtype=np.float32)
    cfg = boosting.BoostConfig(n_trees=args.n_trees, depth=args.depth)
    with stage("fit", device):
        forest = boosting.fit(x, y, cfg=cfg, feature_names=features, device=device)

    model_path = os.path.join(args.out_dir, f"lib_prep_model{args.output_suffix}.npz")
    save_models(model_path, {"lib_prep": forest})
    log.info("trained %d-tree depth-%d model on %d features -> %s", args.n_trees, args.depth, len(features),
             model_path)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
