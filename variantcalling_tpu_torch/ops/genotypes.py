"""Genotype-layout math: VCF PL ordering tables and PL/GQ/GT programs.

Counterpart of ``variantcalling_tpu/ops/genotypes.py``. The VCF spec orders
diploid genotype likelihoods as (j, k) for k in 0..A, j in 0..k (index
``k * (k + 1) / 2 + j``); :func:`genotype_ordering` is that table, a numpy
constant per alt count, so ragged per-record PLs are padded into (records,
G) tensors and each alt count runs as one batch on the caller's device.
The float32 arithmetic follows the reference's XLA program operation for
operation (``ops/math``; sums over genotypes added left to right), so the
integer PLs, GQs and GTs are the reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from variantcalling_tpu_torch.ops.math import phred, unphred

#: PL span clamp keeping ``10 ** (-PL / 10)`` inside float32's normal range
PL_SPAN_CLAMP = 350.0


@functools.lru_cache(maxsize=32)
def genotype_ordering(num_alt: int) -> np.ndarray:
    """(G, 2) int32 diploid genotypes in VCF PL order; G = (A + 1)(A + 2) / 2.

    Row g = (j, k) with j <= k (num_alt = 1: [[0, 0], [0, 1], [1, 1]])."""
    rows = [(j, k) for k in range(num_alt + 1) for j in range(k + 1)]
    return np.asarray(rows, dtype=np.int32)


def n_genotypes(num_alt: int) -> int:
    return (num_alt + 1) * (num_alt + 2) // 2


def genotype_index(j: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """PL index of the unordered genotype {j, k} (elementwise)."""
    lo, hi = torch.minimum(j, k), torch.maximum(j, k)
    return hi * (hi + 1) // 2 + lo


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis, columns added left to right from 0 (the
    order of XLA's reduction over a handful of genotypes)."""
    acc = torch.zeros_like(x[..., 0])
    for g in range(x.shape[-1]):
        acc = acc + x[..., g]
    return acc


def pl_to_gq_gt(pl: torch.Tensor, valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(GQ, index of the smallest PL, the first where tied) of PL tensors
    (..., G): GQ is the second-smallest PL less the smallest; slots outside
    ``valid`` count as +inf."""
    pl = pl.float()
    if valid is not None:
        pl = torch.where(valid, pl, torch.full_like(pl, float("inf")))
    smallest2 = torch.topk(pl, 2, dim=-1, largest=False).values
    return smallest2[..., 1] - smallest2[..., 0], torch.argmin(pl, dim=-1)


def normalize_pl(pl: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """PLs shifted so that their minimum is 0, rounded (half to even) to int32."""
    pl = pl.float()
    masked = torch.where(valid, pl, torch.full_like(pl, float("inf"))) if valid is not None else pl
    return torch.round(pl - masked.min(dim=-1, keepdim=True).values).to(torch.int32)


def diploid_pl_to_haploid(pl: torch.Tensor, num_alt: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Diploid to haploid PLs for records of ``num_alt`` alts, one batch.

    Keeps the homozygous likelihoods, renormalises them, re-phreds with
    truncation and shifts to a minimum of 0, as the reference's non-PAR X/Y
    rewrite does. Returns (haploid PL (N, A + 1) int32, GQ int32, GT int32):
    GT is the last allele whose PL is 0 and GQ the smallest nonzero PL (10000
    where there is none). The PL span is clamped to :data:`PL_SPAN_CLAMP`
    (PLs are shift-invariant here) so that no likelihood underflows."""
    hom_idx = [i * (i + 3) // 2 for i in range(num_alt + 1)]
    hom_pl = pl.float()[:, hom_idx]
    hom_pl = torch.clamp(hom_pl - hom_pl.min(dim=1, keepdim=True).values, max=PL_SPAN_CLAMP)
    hom = unphred(hom_pl)
    hpl = torch.trunc(phred(hom / row_sum(hom)[:, None])).to(torch.int32)
    hpl = hpl - hpl.min(dim=1, keepdim=True).values
    is_zero = hpl == 0
    allele = torch.arange(num_alt + 1, dtype=torch.int32, device=pl.device)
    gt = torch.where(is_zero, allele, torch.full_like(hpl, -1)).max(dim=1).values
    gq = torch.where(is_zero, torch.full_like(hpl, 10000), hpl).min(dim=1).values
    return hpl, gq, gt
