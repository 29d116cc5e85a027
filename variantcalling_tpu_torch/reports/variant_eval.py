"""VariantEval-equivalent summary tables as masked counts on the run's device.

Counterpart of ``variantcalling_tpu/reports/variant_eval.py``: the nine
tables (CompOverlap, CountVariants, TiTvVariantEvaluator,
IndelLengthHistogram, IndelSummary, MetricsCollection, ValidationReport,
VariantSummary, MultiallelicSummary) of one columnar variant table,
stratified by dbSNP novelty (all / known / novel). The reference counts
each (stratum, class) pair as a float32 ``(S, N) @ (N, C)`` product; here
the same counts are masked int64 sums on the run's device (CUDA has no
int64 matrix product), exact at any size. Each table is a
:class:`~variantcalling_tpu_torch.utils.h5_utils.Frame` with the reference's
columns, dtypes and index.
"""

from __future__ import annotations

import numpy as np
import torch

from variantcalling_tpu_torch.featurize import classify_alleles
from variantcalling_tpu_torch.io.vcf import VariantTable, read_vcf
from variantcalling_tpu_torch.utils.h5_utils import Frame, object_column

EVAL_TABLES = [
    "CompOverlap",
    "CountVariants",
    "TiTvVariantEvaluator",
    "IndelLengthHistogram",
    "IndelSummary",
    "MetricsCollection",
    "ValidationReport",
    "VariantSummary",
    "MultiallelicSummary",
]

_STRATA = ("all", "known", "novel")


def dbsnp_membership(table: VariantTable, dbsnp_vcf: str) -> np.ndarray:
    """Bool per variant: (chrom, pos, ref, first-alt) present in dbSNP (any of its alts).

    Only the dbSNP records at a (chrom, pos) of ``table`` can match, so the
    others are dropped before their alleles are decoded (the same answer)."""
    db = read_vcf(dbsnp_vcf, drop_format=True)
    t_chrom, d_chrom = (np.asarray(x.chrom, dtype=object) for x in (table, db))
    near = np.zeros(len(db), dtype=bool)
    for c in set(t_chrom.tolist()):
        on = d_chrom == c
        near[on] = np.isin(db.pos[on], table.pos[t_chrom == c])
    db = db.subset(np.flatnonzero(near))
    keys = set()
    for c, p, r, alts in zip(db.chrom.tolist(), db.pos.tolist(), db.ref.tolist(), db.alt.tolist()):
        for alt in alts.split(","):
            keys.add((str(c), int(p), r, alt))
    return np.fromiter(
        ((str(c), int(p), r, a.split(",")[0]) in keys
         for c, p, r, a in zip(table.chrom.tolist(), table.pos.tolist(), table.ref.tolist(), table.alt.tolist())),
        dtype=bool, count=len(table))


def class_counts(masks: dict[str, np.ndarray], strata: np.ndarray, device: torch.device) -> np.ndarray:
    """(S, C) int64 counts of each class mask (N,) within each stratum row of ``strata`` (S, N)."""
    m = torch.from_numpy(np.stack([masks[k] for k in masks], axis=1)).to(device)  # (N, C)
    s = torch.from_numpy(np.ascontiguousarray(strata)).to(device)  # (S, N)
    return (s[:, :, None] & m[None, :, :]).sum(dim=1, dtype=torch.int64).cpu().numpy()


def _count_frame(masks: dict[str, np.ndarray], strata: np.ndarray, device: torch.device) -> Frame:
    """The reference's ``_class_counts(...).reset_index(names="Novelty")``."""
    counts = class_counts(masks, strata, device)
    cols = {"Novelty": object_column(_STRATA)}
    cols.update({name: counts[:, j] for j, name in enumerate(masks)})
    return Frame(cols)


def _ratio(num: np.ndarray, den: np.ndarray, where: np.ndarray, other: float) -> np.ndarray:
    return np.where(where, num / np.maximum(den, 1), other)


def compute_eval_tables(table: VariantTable, known: np.ndarray | None = None, sample: int = 0,
                        device: torch.device | str = "cpu") -> dict[str, Frame]:
    """All nine VariantEval-style tables from one columnar table."""
    device = torch.device(device)
    n = len(table)
    cols = classify_alleles(table)
    gts = table.genotypes(sample) if table.n_samples else np.full((n, 2), -1, dtype=np.int8)
    known = np.zeros(n, dtype=bool) if known is None else known

    is_snp = cols.is_snp
    is_indel = cols.is_indel
    is_ins = cols.is_indel & cols.is_ins
    is_del = cols.is_indel & ~cols.is_ins
    is_multi = cols.n_alts > 1
    called = (gts >= 0).any(axis=1)
    het = called & (gts[:, 0] != gts[:, 1])
    hom_var = called & (gts[:, 0] == gts[:, 1]) & (gts[:, 0] > 0)
    has_alt = np.fromiter((a not in (".", "") for a in table.alt.tolist()), dtype=bool, count=n)
    is_other = has_alt & ~is_snp & ~is_indel
    ti = is_snp & (np.abs(cols.ref_code.astype(np.int64) - cols.alt_code) == 2)
    tv = is_snp & ~ti
    strata = np.stack([np.ones(n, dtype=bool), known, ~known])

    cv = _count_frame({
        "nVariantLoci": has_alt, "nSNPs": is_snp, "nInsertions": is_ins, "nDeletions": is_del,
        "nMNPs": np.zeros(n, dtype=bool), "nMixed": is_other, "nHets": het & has_alt, "nHomVar": hom_var & has_alt,
        "nMultiAllelic": is_multi}, strata, device)
    cv["variantRate"] = np.full(3, np.nan)
    cv["hetHomRatio"] = _ratio(cv["nHets"], cv["nHomVar"], cv["nHomVar"] > 0, np.nan)

    titv = _count_frame({"nTi": ti, "nTv": tv}, strata, device)
    titv["tiTvRatio"] = _ratio(titv["nTi"], titv["nTv"], titv["nTv"] > 0, 0.0)

    comp = _count_frame({"nEvalVariants": has_alt, "novelSites": ~known & has_alt, "nVariantsAtComp": known},
                        strata, device)
    comp["compRate"] = 100.0 * comp["nVariantsAtComp"] / np.maximum(comp["nEvalVariants"], 1)
    comp["concordantRate"] = comp["compRate"]

    # indel length histogram: -10..10 (deletions negative), VariantEval layout; the int32
    # counts of the reference's device sum, int64 zeros where no indel is that short
    lengths = np.where(is_ins, cols.indel_length, -cols.indel_length).astype(np.int64)
    lengths = lengths[is_indel & (np.abs(np.where(is_indel, lengths, 0)) <= 10)]
    bins = np.arange(-10, 11)
    if len(lengths):
        freq = torch.bincount(torch.from_numpy(lengths + 10).to(device), minlength=21).to(torch.int32).cpu().numpy()
    else:
        freq = np.zeros(21, dtype=np.int64)
    keep = bins != 0
    ilh = Frame({"Length": bins[keep], "Freq": freq[keep]}, index=np.flatnonzero(keep).astype(np.int64))

    n_snp_all = int(is_snp.sum())
    n_ins = int(is_ins.sum())
    n_del = int(is_del.sum())
    isum = _count_frame({"n_SNPs": is_snp, "n_indels": is_indel, "n_insertions": is_ins, "n_deletions": is_del},
                        strata, device)
    isum["SNP_to_indel_ratio"] = isum["n_SNPs"] / np.maximum(isum["n_indels"], 1)
    isum["insertion_to_deletion_ratio"] = isum["n_insertions"] / np.maximum(isum["n_deletions"], 1)

    msum = _count_frame({"nSNPs": is_snp, "nMultiSNPs": is_snp & is_multi, "nIndels": is_indel,
                         "nMultiIndels": is_indel & is_multi}, strata, device)

    titv_all = float(titv["tiTvRatio"][0])
    vsum = Frame({"nSamples": np.array([table.n_samples], np.int64), "nSNPs": np.array([n_snp_all], np.int64),
                  "nIndels": np.array([n_ins + n_del], np.int64), "nSVs": np.array([0], np.int64),
                  "TiTvRatio": np.array([titv_all])})
    metrics = Frame({"metric": object_column(["nSNPs", "nIndels", "insertionDeletionRatio", "tiTvRatio"]),
                     "value": np.array([n_snp_all, n_ins + n_del, n_ins / max(n_del, 1), titv_all], np.float64)})
    n_known = int(known.sum())
    validation = Frame({"nComp": np.array([n_known], np.int64), "TP": np.array([n_known], np.int64),
                        "FP": np.array([0], np.int64), "FN": np.array([0], np.int64),
                        "sensitivity": np.array([100.0])})
    return {
        "CompOverlap": comp,
        "CountVariants": cv,
        "TiTvVariantEvaluator": titv,
        "IndelLengthHistogram": ilh,
        "IndelSummary": isum,
        "MetricsCollection": metrics,
        "ValidationReport": validation,
        "VariantSummary": vsum,
        "MultiallelicSummary": msum,
    }
