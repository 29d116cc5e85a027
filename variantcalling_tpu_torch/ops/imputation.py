"""Imputation-weighted PL/GQ/GT rewrite, one batch of records on the caller's device.

Counterpart of ``variantcalling_tpu/ops/imputation.py``: the reference's
per-record ``modify_stats_with_imp`` (a ``vmap`` there) as one batched
program over a (records, G) PL tensor per alt count, in the reference's
float32 order of operations (``ops/math``, ``ops/genotypes.row_sum``).
"""

from __future__ import annotations

import numpy as np
import torch

from variantcalling_tpu_torch.ops.genotypes import genotype_ordering, row_sum
from variantcalling_tpu_torch.ops.math import PHRED_SCALE, fma_f32, log_f32, unphred

# PL span clamp keeping 10**(-PL/10) inside float32's normal range (PLs are
# shift-invariant here), and the floor of the scaled likelihoods
_PL_CLAMP = 350.0
_PROB_FLOOR = float(np.float32(1e-37))


def genotype_priors(ds: torch.Tensor, num_alt: int, epsilon: float) -> torch.Tensor:
    """(N, G) imputation prior per genotype from (N, A) allele dosages.

    f_het = clip(2 - ds, eps, 1 - eps) and f_hom = clip(max(ds, 1) - 1, eps,
    1 - eps); a genotype carrying an allele takes that allele's f_hom if it
    is homozygous, else its f_het, the largest over its alleles (a missing
    DS counts eps); hom-ref keeps prior 1."""
    lo, hi = float(np.float32(epsilon)), float(np.float32(1.0 - epsilon))
    ds = ds.float()
    f_het = torch.clamp(2.0 - ds, lo, hi)
    f_hom = torch.clamp(torch.clamp(ds, min=1.0) - 1.0, lo, hi)
    f_het = torch.where(torch.isnan(f_het), torch.full_like(f_het, lo), f_het)
    f_hom = torch.where(torch.isnan(f_hom), torch.full_like(f_hom, lo), f_hom)
    table = genotype_ordering(num_alt)
    cols = [torch.ones_like(ds[:, 0])]
    for j, k in table[1:].tolist():
        carried = sorted({a for a in (j, k) if a > 0})
        vals = [(f_hom if j == k else f_het)[:, a - 1] for a in carried]
        # an allele the genotype does not carry counts eps in the reference's max
        if len(carried) < num_alt:
            vals.append(torch.full_like(ds[:, 0], lo))
        best = vals[0]
        for v in vals[1:]:
            best = torch.maximum(best, v)
        cols.append(best)
    return torch.stack(cols, dim=1)


def _weighted_alt_sum(likelihood: torch.Tensor, f_gt: torch.Tensor, num_alt: int) -> torch.Tensor:
    """Sum of ``likelihood * f_gt`` over the alt genotypes, left to right, as
    XLA's CPU loop computes it: for 1 and 3 alts each product fused into its
    add (one rounding a step), for 2 alts each product rounded first. (XLA's
    scalar remainder rows, a few at the edges of its row partitions, fuse
    for 2 alts too: there the reference may differ in the last bit.)"""
    acc = torch.zeros_like(likelihood[:, 0])
    for g in range(1, likelihood.shape[1]):
        if num_alt == 2:
            acc = acc + likelihood[:, g] * f_gt[:, g]
        else:
            acc = fma_f32(likelihood[:, g], f_gt[:, g], acc)
    return acc


def modify_stats_with_imp_batch(pl: torch.Tensor, ds: torch.Tensor, gt_idx: torch.Tensor, num_alt: int,
                                epsilon: float = 0.01) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(new PL (N, G) int32, new GQ (N,) int32, new genotype index (N,) int32).

    ``pl`` (N, G) phred likelihoods, ``ds`` (N, A) allele dosages (NaN:
    missing), ``gt_idx`` (N,) the current genotype's row in
    :func:`~variantcalling_tpu_torch.ops.genotypes.genotype_ordering`. The
    alt likelihoods are reweighted by the priors with their total kept; the
    current GT stays where its new PL ties the minimum, else the first
    minimum wins; new PLs are rounded half to even."""
    f_gt = genotype_priors(ds, num_alt, epsilon)
    pl = pl.float()
    pl = torch.clamp(pl - pl.min(dim=1, keepdim=True).values, max=_PL_CLAMP)
    likelihood = unphred(pl)
    pl_f = likelihood * f_gt
    alt_sum_u = row_sum(likelihood[:, 1:])
    alt_sum_f = torch.clamp(_weighted_alt_sum(likelihood, f_gt, num_alt), min=_PROB_FLOOR)
    scaled = torch.cat([likelihood[:, :1], (alt_sum_u / alt_sum_f)[:, None] * pl_f[:, 1:]], dim=1)
    log_scaled = log_f32(torch.clamp(scaled, min=_PROB_FLOOR))
    phredded = log_scaled * PHRED_SCALE
    min_pl = phredded.min(dim=1).values
    gt_idx = gt_idx.long()
    keep = phredded.gather(1, gt_idx[:, None])[:, 0] == min_pl
    new_idx = torch.where(keep, gt_idx, torch.argmin(phredded, dim=1)).to(torch.int32)
    # XLA fuses the phred product into the shift: one rounding of log * scale - min
    new_pl = torch.round(fma_f32(log_scaled, PHRED_SCALE, -min_pl[:, None])).to(torch.int32)
    smallest2 = torch.topk(new_pl, 2, dim=1, largest=False).values
    return new_pl, (smallest2[:, 1] - smallest2[:, 0]).to(torch.int32), new_idx


def gt_to_index(gt: np.ndarray, num_alt: int) -> np.ndarray:
    """(N, 2) genotype pairs -> row index in ``genotype_ordering(num_alt)``;
    -1 for a pair outside the diploid table (haploid, half-missing ``./1``)."""
    table = genotype_ordering(num_alt)
    lut = {tuple(row): i for i, row in enumerate(table.tolist())}
    return np.asarray([lut.get((int(min(a, b)), int(max(a, b))), -1) for a, b in gt], dtype=np.int32)
