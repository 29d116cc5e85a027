"""correct_genotypes_by_imputation: imputation-weighted PL/GQ/GT rewrite.

Counterpart of ``variantcalling_tpu/pipelines/correct_genotypes_by_imputation.py``,
with the same arguments plus ``--backend gpu|cpu`` (default ``gpu``: the
card; asking for it without one exits 2). Two modes:
- ``--beagle_annotated_vcf``: a VCF that already carries beagle's FORMAT/DS;
- ``--input_vcf`` with per-chromosome cohort VCFs and plink maps (two JSON
  maps, or the three ``--single_*`` arguments): the stage chain of
  :mod:`~variantcalling_tpu_torch.pipelines.imputation_stages` a chromosome,
  its parts joined at the end, one stats CSV over all of them.

PASS records with a called alt, a fully called diploid GT, FORMAT/DS and 1
to 3 alts get new PL, GQ and GT from ``ops/imputation`` (one batch an alt
count, on the run's device); the old values are kept as GT0, GQ0 and PL0,
replaced (not repeated) on a rerun. The stats CSV counts, by variant type,
PASS calls, rewritten calls, calls whose imputed zygosity differs and
changed genotypes. The records are written as the reference writes them:
QUAL as ``%g`` of its value, FORMAT and sample 0 rebuilt where rewritten.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
from collections import defaultdict

import numpy as np
import torch

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.io.vcf import join_tails, number_lists, read_vcf, sample_fields, write_vcf
from variantcalling_tpu_torch.ops.genotypes import genotype_ordering, n_genotypes
from variantcalling_tpu_torch.ops.imputation import gt_to_index, modify_stats_with_imp_batch
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)

MAX_ALTS = 3
COUNTER_KEYS = ("pass", "has_non_ref_imp", "imp_has_different_gt", "changed_gt")
RETAINED = ("GT0", "GQ0", "PL0")


def _new_counter() -> dict:
    return dict.fromkeys(COUNTER_KEYS, 0)


def parse_args(argv: list[str]):
    ap = argparse.ArgumentParser(prog="correct_genotypes_by_imputation", description=run.__doc__)
    ap.add_argument("--beagle_annotated_vcf", help="VCF annotated with beagle FORMAT/DS (skip the stage chain)")
    ap.add_argument("--input_vcf", help="VCF to be corrected (runs the full stage chain)")
    ap.add_argument("--chrom_to_cohort_vcfs_json", help="json mapping chromosome names to reference-cohort VCFs")
    ap.add_argument("--chrom_to_plink_json", help="json mapping chromosome names to plink genomic maps")
    ap.add_argument("--single_chrom", help="single chromosome to work on (cromwell mode)")
    ap.add_argument("--single_cohort_vcf", help="reference cohort VCF for --single_chrom")
    ap.add_argument("--single_genomic_map_plink", help="plink genomic map for --single_chrom")
    ap.add_argument("--temp_dir", default=None, help="directory for stage files")
    ap.add_argument("--threads_for_contig", type=int, default=1, help="(accepted; in-process stages)")
    ap.add_argument("--threads_beagle", type=int, default=1)
    ap.add_argument("--beagle_cmd", default="beagle", help="beagle executable (testing seam)")
    ap.add_argument("--output_vcf", required=True)
    ap.add_argument("--epsilon", type=float, default=0.01, help="imputation weight in the new PL (0..1)")
    ap.add_argument("--stats_file", default=None)
    ap.add_argument("--add_imp_effect", action="store_true")
    ap.add_argument("--verbosity", default="INFO")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def run(argv: list[str]) -> int:
    """Correct a vcf based on imputation."""
    args = parse_args(argv)
    logging.getLogger("variantcalling_tpu_torch").setLevel(getattr(logging, args.verbosity))
    if args.input_vcf and args.beagle_annotated_vcf:
        raise SystemExit("--input_vcf (full stage chain) and --beagle_annotated_vcf "
                         "(pre-annotated input) are mutually exclusive")
    if not args.input_vcf and not args.beagle_annotated_vcf:
        raise SystemExit("provide --beagle_annotated_vcf, or --input_vcf with cohort/map args")
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    if args.input_vcf:
        return _run_stage_chain(args, device)
    counters = correct_annotated(args.beagle_annotated_vcf, args.output_vcf, args.epsilon, device)
    write_stats(args, counters)
    return 0


def _chrom_maps(args) -> tuple[dict, dict]:
    if args.chrom_to_cohort_vcfs_json and args.chrom_to_plink_json:
        with open(args.chrom_to_cohort_vcfs_json, encoding="utf-8") as fh:
            chrom_to_cohort = json.load(fh)
        with open(args.chrom_to_plink_json, encoding="utf-8") as fh:
            chrom_to_plink = json.load(fh)
    elif args.single_chrom and args.single_cohort_vcf and args.single_genomic_map_plink:
        chrom_to_cohort = {args.single_chrom: args.single_cohort_vcf}
        chrom_to_plink = {args.single_chrom: args.single_genomic_map_plink}
    else:
        raise SystemExit("define chrom_to_cohort_vcfs_json + chrom_to_plink_json, or the three single_* args")
    missing_maps = set(chrom_to_cohort) - set(chrom_to_plink)
    if missing_maps:
        raise SystemExit(f"chrom_to_plink_json lacks genomic maps for {sorted(missing_maps)} "
                         "(every cohort chromosome needs a plink map)")
    return chrom_to_cohort, chrom_to_plink


def _run_stage_chain(args, device: torch.device) -> int:
    """subset -> high-GQ filter -> beagle (external) -> collapse -> annotate
    -> the PL update, a chromosome at a time; then one concat and one stats CSV."""
    from variantcalling_tpu_torch.pipelines import imputation_stages as st

    chrom_to_cohort, chrom_to_plink = _chrom_maps(args)
    tmp = args.temp_dir or tempfile.mkdtemp(prefix="imputation_")
    os.makedirs(tmp, exist_ok=True)
    part_files = []
    all_counters: dict = defaultdict(_new_counter)
    with stage("ingest", device):
        input_table = read_vcf(args.input_vcf)  # parsed once for all chromosomes
    for chrom in chrom_to_cohort:
        paths = {stage: os.path.join(tmp, f"{stage}.{chrom}.vcf.gz") for stage in (
            "subset", "high_gq", "beagle", "beagle_collapsed", "beagle_anno", "add_imp")}
        with stage("stages", device):
            sub = st.subset_vcf(input_table, chrom, paths["subset"])
            st.filter_high_gq(sub, paths["high_gq"])
        with stage("beagle", device):
            st.run_beagle(paths["high_gq"], chrom_to_cohort[chrom], chrom_to_plink[chrom], paths["beagle"],
                          nthreads=args.threads_beagle, beagle_cmd=args.beagle_cmd)
        with stage("stages", device):
            collapsed = st.collapse_beagle(paths["beagle"], paths["beagle_collapsed"])
            st.annotate_with_beagle(sub, collapsed, paths["beagle_anno"])
        counters = correct_annotated(paths["beagle_anno"], paths["add_imp"], args.epsilon, device)
        for vt, c in counters.items():
            for k, v in c.items():
                all_counters[vt][k] += v
        part_files.append(paths["add_imp"])
    with stage("concat", device):
        st.concat_vcfs(part_files, args.output_vcf)
    write_stats(args, all_counters)
    return 0


def write_stats(args, counters: dict) -> None:
    """The counters CSV: ``--stats_file``, else ``<output stem>_counts.csv``."""
    stats_file = args.stats_file or args.output_vcf.replace(".vcf.gz", "").replace(".vcf", "") + "_counts.csv"
    with open(stats_file, "w") as fh:
        fh.write("variant_type," + ",".join(COUNTER_KEYS) + "\n")
        for vt, c in sorted(counters.items()):
            fh.write(vt + "," + ",".join(str(c[k]) for k in COUNTER_KEYS) + "\n")


def _variant_types(table, n_alts: np.ndarray) -> np.ndarray:
    same_len = np.array([len(r) == len(a.split(",")[0]) if a not in (".", "") else True
                         for r, a in zip(table.ref, table.alt)], dtype=bool)
    return np.where(n_alts > 1, "multi", np.where(same_len, "snp", "indel"))


def correct_annotated(annotated_vcf: str, out_path: str, epsilon: float, device: torch.device) -> dict:
    """Rewrite a beagle-annotated VCF into ``out_path``; the counters by variant type."""
    with stage("ingest", device):
        table = read_vcf(annotated_vcf)
        fmt, samples = table.format_columns()
        raw = sample_fields(fmt.tolist(), samples[:, 0].tolist(), ("DS", "PL"))
    n = len(table)
    gts = table.genotypes()
    n_alts = table.n_alts()
    ds_raw = number_lists(raw["DS"], None, np.nan)
    has_ds = np.array([r is not None for r in raw["DS"]], dtype=bool)
    is_pass = np.array([f in ("PASS", ".", "") for f in table.filters], dtype=bool)
    has_alt = (gts > 0).any(axis=1)
    # fully called diploid GTs only: haploid and half-missing ones have no row in the genotype table
    diploid_called = (gts >= 0).all(axis=1)
    eligible = is_pass & has_alt & diploid_called & has_ds & (n_alts >= 1) & (n_alts <= MAX_ALTS)

    new_gt_str = np.full(n, None, dtype=object)
    new_gq = np.full(n, -1, dtype=np.int64)
    new_pl_str = np.full(n, None, dtype=object)
    vtypes = _variant_types(table, n_alts)
    kinds = {vt: vtypes == vt for vt in np.unique(vtypes).tolist()}
    counters: dict[str, dict] = defaultdict(_new_counter)
    for vt, m in kinds.items():
        if (m & is_pass & has_alt).any():
            counters[vt]["pass"] += int((m & is_pass & has_alt).sum())
    rewritten = np.zeros(n, dtype=bool)
    imp_differs = np.zeros(n, dtype=bool)
    changed_gt = np.zeros(n, dtype=bool)

    pl_all = number_lists(raw["PL"], n_genotypes(MAX_ALTS), np.nan)
    for num_alt in range(1, MAX_ALTS + 1):
        m = eligible & (n_alts == num_alt)
        if not m.any():
            continue
        g = n_genotypes(num_alt)
        pl = pl_all[m][:, :g]
        ok = ~np.isnan(pl).any(axis=1)
        idx = np.nonzero(m)[0][ok]
        if len(idx) == 0:
            continue
        pl = pl[ok]
        ds = ds_raw[m][ok][:, :num_alt] if ds_raw.shape[1] >= num_alt else np.full((len(idx), num_alt), np.nan)
        cur_idx = gt_to_index(gts[idx], num_alt)
        valid_gt = cur_idx >= 0
        idx, pl, ds, cur_idx = idx[valid_gt], pl[valid_gt], ds[valid_gt], cur_idx[valid_gt]
        if len(idx) == 0:
            continue
        with stage("update", device):
            npl, ngq, nidx = (x.cpu().numpy() for x in modify_stats_with_imp_batch(
                torch.from_numpy(pl).to(device), torch.from_numpy(ds).to(device),
                torch.from_numpy(cur_idx).to(device), num_alt, epsilon))
        pair = genotype_ordering(num_alt)[nidx]
        rewritten[idx] = True
        imp_hom = np.where(np.isnan(ds), -np.inf, ds).max(axis=1) >= 1.5
        imp_differs[idx] = imp_hom != (gts[idx, 0] == gts[idx, 1])
        changed_gt[idx] = (np.sort(pair, axis=1) != np.sort(gts[idx].astype(np.int32), axis=1)).any(axis=1)
        new_pl_str[idx] = [",".join(map(str, row)) for row in npl.tolist()]
        new_gq[idx] = ngq
        new_gt_str[idx] = [f"{a}/{b}" for a, b in pair.tolist()]
    for vt, m in kinds.items():
        if (m & rewritten).any():
            c = counters[vt]
            c["has_non_ref_imp"] += int((m & rewritten).sum())
            c["imp_has_different_gt"] += int((m & imp_differs).sum())
            c["changed_gt"] += int((m & changed_gt).sum())

    with stage("writeback", device):
        table.header.ensure_format("GT0", "1", "String", "Genotype (pre-imputation)")
        table.header.ensure_format("GQ0", "1", "Integer", "GQ (pre-imputation)")
        table.header.ensure_format("PL0", "G", "Integer", "PL (pre-imputation)")
        for i in np.flatnonzero(rewritten).tolist():
            keys = fmt[i].split(":")
            kv = dict(zip(keys, samples[i, 0].split(":")))
            old_gt, old_gq, old_pl = kv.get("GT", "./."), kv.get("GQ", "."), kv.get("PL", ".")
            kv.update(GT=new_gt_str[i], GQ=str(new_gq[i]), PL=new_pl_str[i], GT0=old_gt.replace("/", "|"),
                      GQ0=old_gq, PL0=old_pl)
            order = [k for k in keys if k not in RETAINED]
            # the rewrite always has GQ and PL: they are written where the input lacked them (GQ after GT)
            if "GQ" not in order:
                order.insert(1 if order and order[0] == "GT" else 0, "GQ")
            if "PL" not in order:
                order.append("PL")
            order += list(RETAINED)
            fmt[i] = ":".join(order)
            samples[i, 0] = ":".join(kv.get(k, ".") for k in order)
        write_vcf(out_path, table, qual_as_read=False, tails=join_tails(fmt, samples))
    log.info("rewrote %d genotypes -> %s on %s", int(changed_gt.sum()), out_path, device)
    return dict(counters)


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
