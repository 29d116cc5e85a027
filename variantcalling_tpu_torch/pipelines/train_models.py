"""train_models_pipeline: fit the filtering model family on the card.

Counterpart of ``variantcalling_tpu/pipelines/train_models.py``, with the
same arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card;
asking for it without one exits 2). It trains the standard named-model
grid {rf, threshold} x {ignore_gt, use_gt} x {incl, excl hpol runs} and
writes ``<prefix>.pkl`` (the registry's format, classes named as the
reference names them, so the JAX package loads it too) and ``<prefix>.h5``
(``training_results``; with ``--evaluate_concordance`` also
``optimal_recall_precision``, the held-out contig's accuracy).

The ``rf`` family is the histogram gradient-boosted forest of
:mod:`models.boosting` (on the card, its histograms through the
hand-written ``gbt_hist`` kernel; on the CPU the native trainer, as in the
reference), the ``threshold`` family the grid fit of
:func:`models.threshold.fit_threshold_model`. Models are scored for the
training metrics through the filter's own predictors (``cuda-wide`` for a
forest on the card), the sigmoid on the host. Each fitted model lands in
``<prefix>.partial.pkl`` at once, beside a fingerprint of the run's input
and settings, and ``--resume`` skips the cells it holds.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.featurize import featurize
from variantcalling_tpu_torch.io import bed as bedio
from variantcalling_tpu_torch.io import hdf5
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.io.vcf import read_vcf
from variantcalling_tpu_torch.models import boosting
from variantcalling_tpu_torch.models import forest as forest_mod
from variantcalling_tpu_torch.models import threshold as threshold_mod
from variantcalling_tpu_torch.models.registry import MODEL_NAME_PATTERN, load_models, save_models
from variantcalling_tpu_torch.ops import intervals as iops
from variantcalling_tpu_torch.utils.stages import stage
from variantcalling_tpu_torch.pipelines.training_prep import (
    blacklist_membership,
    labels_from_approximate_gt,
    read_blacklist_loci,
)
from variantcalling_tpu_torch.utils.h5_utils import CONCORDANCE_SKIP_KEYS, Frame, read_hdf, write_hdf

log = logging.getLogger(__name__)

# numeric feature columns recognized in a concordance frame (h5 mode)
H5_FEATURES = [
    "qual", "dp", "sor", "af", "gq", "is_het", "is_snp", "is_indel", "is_ins",
    "indel_length", "hmer_indel_length", "hmer_indel_nuc", "gc_content",
    "cycleskip_status", "left_motif", "right_motif", "ref_code", "alt_code",
    "n_alts", "tlod",
]


def parse_args(argv: list[str]):
    ap = argparse.ArgumentParser(prog="train_models_pipeline", description=run.__doc__)
    ap.add_argument("--input_file", required=True, help="h5 (comparison output) or VCF input")
    ap.add_argument("--blacklist", help="blacklist file by which we decide variants as FP")
    ap.add_argument("--output_file_prefix", required=True, help=".pkl with models, .h5 with results")
    ap.add_argument("--mutect", action="store_true")
    ap.add_argument("--evaluate_concordance", action="store_true",
                    help="apply a model to the held-out contig and record metrics")
    ap.add_argument("--apply_model", default="rf_model_ignore_gt_incl_hpol_runs")
    ap.add_argument("--evaluate_concordance_contig", default="chr20")
    ap.add_argument("--input_interval", help="bed of intersected intervals from run_comparison")
    ap.add_argument("--list_of_contigs_to_read", nargs="*", default=None)
    ap.add_argument("--reference", required=False, help="reference FASTA (VCF input mode)")
    ap.add_argument("--runs_intervals", help="hpol runs intervals (bed/interval_list)")
    ap.add_argument("--annotate_intervals", action="append", default=[])
    ap.add_argument("--exome_weight", type=float, default=1.0)
    ap.add_argument("--flow_order", default="TGCA")
    ap.add_argument("--exome_weight_annotation", default=None)
    ap.add_argument("--vcf_type", default="single_sample", choices=["single_sample", "joint"])
    ap.add_argument("--ignore_filter_status", action="store_true")
    ap.add_argument("--n_trees", type=int, default=100)
    ap.add_argument("--tree_depth", type=int, default=6)
    ap.add_argument("--resume", action="store_true",
                    help="skip grid cells already fitted in <prefix>.partial.pkl")
    ap.add_argument("--verbosity", default="INFO")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def _ingest(args, device: torch.device):
    """-> (x, feature_names, label, label_gt, weight, in_hpol, contig)."""
    if args.input_file.endswith((".h5", ".hdf", ".hdf5")):
        df = read_hdf(args.input_file, key="all",
                      skip_keys=CONCORDANCE_SKIP_KEYS)
        if args.list_of_contigs_to_read:
            df = df.take(np.isin(np.asarray(df["chrom"], dtype=object), args.list_of_contigs_to_read))
        cls = df["classify"]  # strings, None where missing (equal to no label)
        keep = (cls == "tp") | (cls == "fp")
        df = df.take(keep)
        label = (cls[keep] == "tp").astype(np.float32)
        label_gt = ((df["classify_gt"] if "classify_gt" in df else cls[keep]) == "tp").astype(np.float32)
        names = [f for f in H5_FEATURES if f in df]
        names += [c for c in df.columns if c.startswith(("LCR", "mappability", "exome", "ug_hcr"))]
        x = np.stack([np.nan_to_num(np.asarray(df[f], dtype=np.float32)) for f in names], axis=1)
        in_hpol = np.asarray(df["hpol_run"], dtype=bool) if "hpol_run" in df else np.zeros(len(df), dtype=bool)
        contig = df["chrom"]
        return x, names, label, label_gt, _exome_weight(args, names, x), in_hpol, contig

    # VCF mode: featurize against the reference; approximate-GT labels
    if not args.reference:
        raise SystemExit("--reference is required for VCF input")
    table = read_vcf(args.input_file)
    if args.list_of_contigs_to_read:
        table = table.subset(np.isin(table.chrom, args.list_of_contigs_to_read))
    annotate = {_interval_name(path): bedio.read_intervals(path) for path in args.annotate_intervals}
    with FastaReader(args.reference) as fasta:
        fs = featurize(table, fasta, annotate_intervals=annotate, flow_order=args.flow_order,
                       extra_info_fields=["TLOD"] if args.mutect else [], device=device)
        if args.mutect and "TLOD" in fs.columns:
            fs.columns["tlod"] = fs.columns.pop("TLOD")
            fs.feature_names[fs.feature_names.index("TLOD")] = "tlod"
        in_hpol = np.zeros(len(table), dtype=bool)
        if args.runs_intervals:
            runs = bedio.read_intervals(args.runs_intervals)
            contig_lengths = table.header.contig_lengths or {
                c: fasta.get_reference_length(c) for c in fasta.references}
            coords = iops.GenomeCoords(contig_lengths)
            gpos = coords.globalize(np.asarray(table.chrom), table.pos - 1)
            gs, ge = coords.globalize_intervals(runs)
            in_hpol = np.asarray(iops.membership(gpos, gs, ge), dtype=bool)
    chrom = np.asarray(table.chrom, dtype=object)
    in_dbsnp = (np.asarray(table.vid) != ".") | table.info_flag("DB")
    if args.blacklist:
        bl_chrom, bl_pos = read_blacklist_loci(args.blacklist)
        in_bl = blacklist_membership(chrom, table.pos, bl_chrom, bl_pos)
    else:
        in_bl = np.zeros(len(table), dtype=bool)
    keep, label = labels_from_approximate_gt(chrom, table.pos, in_dbsnp, in_bl)
    x = fs.matrix()[keep]
    label = label[keep].astype(np.float32)
    weight = _exome_weight(args, fs.feature_names, x)
    return x, fs.feature_names, label, label.copy(), weight, in_hpol[keep], chrom[keep]


def _exome_weight(args, names: list[str], x: np.ndarray) -> np.ndarray:
    w = np.ones(len(x), dtype=np.float32)
    if args.exome_weight != 1.0 and args.exome_weight_annotation:
        matches = [i for i, n in enumerate(names) if args.exome_weight_annotation in n]
        if matches:
            w = np.where(x[:, matches[0]] > 0, args.exome_weight, 1.0).astype(np.float32)
    return w


def _interval_name(path: str) -> str:
    base = os.path.basename(path)
    for suf in (".bed", ".interval_list", ".gz"):
        base = base[: -len(suf)] if base.endswith(suf) else base
    return base


def _fingerprint(args) -> dict:
    """What a checkpoint was fitted under, as the reference records it."""
    return {
        "input_file": os.path.abspath(args.input_file),
        "input_mtime": os.path.getmtime(args.input_file),
        "input_size": os.path.getsize(args.input_file),
        "n_trees": args.n_trees, "tree_depth": args.tree_depth,
        "mutect": args.mutect, "contigs": args.list_of_contigs_to_read,
        "exome_weight": args.exome_weight,
    }


def _resumed(args, partial_pkl: str, meta_path: str, fingerprint: dict) -> dict:
    """The models of a checkpoint fitted under this run's fingerprint, else none."""
    if not (args.resume and os.path.exists(partial_pkl)):
        return {}
    try:
        with open(meta_path) as fh:
            old = json.load(fh)
    except (OSError, ValueError):
        old = None
    if old != fingerprint:
        log.warning("--resume: checkpoint was fitted under different settings/input (%s); refitting from scratch",
                    meta_path)
        return {}
    try:
        models = load_models(partial_pkl)
    except Exception as e:  # noqa: BLE001 — a bad checkpoint must not kill the rerun
        log.warning("--resume: could not read %s (%s); refitting from scratch", partial_pkl, e)
        return {}
    log.info("resuming: %d models already fitted in %s", len(models), partial_pkl)
    return models


def run(argv: list[str]) -> int:
    """Train filtering models on the concordance file."""
    args = parse_args(argv)
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    try:
        return _run(args, device)
    except (hdf5.H5Unsupported, NotImplementedError, engine_mod.EngineError) as e:
        log.error("%s", e)
        return 2


def _run(args, device: torch.device) -> int:
    """The run; each stage's host seconds logged as the filter pipeline's are
    (``utils.stages.STAGE_LOG``): stages that touch the card end in a copy
    back, so their time holds the card's work."""
    with stage("ingest"):
        x, names, label, label_gt, weight, in_hpol, contig = _ingest(args, device)
    log.info("training set: %d variants, %d features (%s) on %s", len(x), len(names), ",".join(names[:8]), device)

    holdout = np.zeros(len(x), dtype=bool)
    if args.evaluate_concordance:
        holdout = contig == args.evaluate_concordance_contig
    train_m = ~holdout

    cfg = boosting.BoostConfig(n_trees=args.n_trees, depth=args.tree_depth)
    partial_pkl = f"{args.output_file_prefix}.partial.pkl"
    meta_path = f"{args.output_file_prefix}.partial.meta.json"
    fingerprint = _fingerprint(args)
    models: dict[str, object] = _resumed(args, partial_pkl, meta_path, fingerprint)
    results = []

    def metrics(key: str, model, m: np.ndarray, lab: np.ndarray) -> None:
        with stage("train_metrics"):
            results.append(_train_metrics(key, model, x[m], lab[m], list(names), device))

    def checkpoint(key: str, model, m: np.ndarray, lab: np.ndarray) -> None:
        models[key] = model
        metrics(key, model, m, lab)
        with stage("writes"):
            save_models(partial_pkl, models)
            with open(meta_path, "w") as fh:
                json.dump(fingerprint, fh)

    for gt_name, lab in (("ignore_gt", label), ("use_gt", label_gt)):
        for hpol_name, hmask in (("incl_hpol_runs", np.ones(len(x), bool)), ("excl_hpol_runs", ~in_hpol)):
            m = train_m & hmask
            if m.sum() < 10 or len(set(lab[m].tolist())) < 2:
                log.warning("skipping %s/%s: degenerate training subset (%d rows)", gt_name, hpol_name, m.sum())
                continue
            fkey = MODEL_NAME_PATTERN.format(family="rf", gt=gt_name, hpol=hpol_name)
            if fkey in models:
                metrics(fkey, models[fkey], m, lab)
            else:
                with stage(f"fit_{fkey}"):
                    forest = boosting.fit(x[m], lab[m], sample_weight=weight[m], cfg=cfg, feature_names=list(names),
                                          device=device)
                checkpoint(fkey, forest, m, lab)
            tkey = MODEL_NAME_PATTERN.format(family="threshold", gt=gt_name, hpol=hpol_name)
            if tkey in models:
                metrics(tkey, models[tkey], m, lab)
            else:
                cand = ["tlod", "sor"] if args.mutect else ["qual", "sor"]
                with stage("threshold_fits"):
                    tmodel = threshold_mod.fit_threshold_model(x[m], lab[m], list(names), candidate_features=cand,
                                                               sample_weight=weight[m], device=device)
                checkpoint(tkey, tmodel, m, lab)

    pkl = f"{args.output_file_prefix}.pkl"
    out_h5 = f"{args.output_file_prefix}.h5"
    with stage("writes"):
        save_models(pkl, models)
        for stale in (partial_pkl, meta_path):
            if os.path.exists(stale):
                os.remove(stale)  # the finished pickle supersedes the checkpoint
        write_hdf(_results_frame(results), out_h5, key="training_results", mode="w")
    log.info("saved %d models to %s", len(models), pkl)

    if args.evaluate_concordance and holdout.any() and args.apply_model in models:
        from variantcalling_tpu_torch.concordance.concordance_utils import calc_accuracy_metrics

        mdl = models[args.apply_model]
        xh = x[holdout]
        with stage("evaluate"):
            score = _apply(mdl, xh, list(names), device)
            eval_df = Frame({
                "indel": xh[:, names.index("is_indel")] > 0 if "is_indel" in names else np.zeros(len(xh), bool),
                "hmer_indel_length": xh[:, names.index("hmer_indel_length")] if "hmer_indel_length" in names
                else np.zeros(len(xh), np.int64),
                "classify_gt": np.where(label_gt[holdout] > 0, "tp", "fp").astype(object),
                "filter": np.where(score >= getattr(mdl, "pass_threshold", 0.5), "PASS", "LOW_SCORE").astype(object),
            })
            acc = calc_accuracy_metrics(eval_df, "classify_gt", ["HPOL_RUN"], device=device)
        with stage("writes"):
            write_hdf(acc, out_h5, key="optimal_recall_precision", mode="a")
        log.info("held-out (%s) accuracy: %s", args.evaluate_concordance_contig,
                 {g: (int(tp), int(fp), int(fn)) for g, tp, fp, fn in zip(acc["group"], acc["tp"], acc["fp"],
                                                                          acc["fn"])})
    return 0


def _results_frame(results: list[dict]) -> Frame:
    """The rows of ``_train_metrics`` as the reference's ``pd.DataFrame(results)``
    types them: the model name as strings, the counts int64, the rates
    float64."""
    if not results:
        return Frame({})
    model = np.empty(len(results), dtype=object)
    model[:] = [r["model"] for r in results]
    cols = {"model": model}
    for key in ("n", "tp", "fp", "fn"):
        cols[key] = np.asarray([r[key] for r in results], dtype=np.int64)
    for key in ("precision", "recall", "f1"):
        cols[key] = np.asarray([r[key] for r in results], dtype=np.float64)
    return Frame(cols)


def _apply(model, x: np.ndarray, names: list[str], device: torch.device) -> np.ndarray:
    """TREE_SCORE of ``x`` on ``device``: a threshold model through its torch
    program, a forest through the filter's predictor for the device
    (``cuda-wide`` on the card under ``auto``), its margin finalized on the
    host."""
    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
    if isinstance(model, threshold_mod.ThresholdModel):
        return threshold_mod.predict_score(model, xt, names).cpu().numpy()
    fm = forest_mod.with_feature_order(model, names) if model.feature_names else model
    strategy = forest_mod.resolve_strategy(fm, device)
    margin = forest_mod.make_margin_predictor(fm, x.shape[1], strategy, device)(xt)
    return forest_mod.finalize_margin(margin.cpu().numpy(), fm)


def _train_metrics(name: str, model, x: np.ndarray, y: np.ndarray, names: list[str], device: torch.device) -> dict:
    score = _apply(model, x, names, device)
    pred = score >= getattr(model, "pass_threshold", 0.5)
    yb = y > 0.5
    tp = int((pred & yb).sum())
    fp = int((pred & ~yb).sum())
    fn = int((~pred & yb).sum())
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return {
        "model": name,
        "n": len(y),
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "precision": round(prec, 5),
        "recall": round(rec, 5),
        "f1": round(2 * prec * rec / max(prec + rec, 1e-9), 5),
    }


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
