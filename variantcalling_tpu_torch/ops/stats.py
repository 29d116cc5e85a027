"""Batched statistics on the caller's device.

Counterpart of ``variantcalling_tpu/ops/stats.py``, function for function,
in torch: every function takes tensors on one device and computes there,
in float32 where the reference's arrays are float32, in its order of
operations. The multinomial log-pmf goes through ``torch.lgamma``, which
is not XLA's ``gammaln``: the two differ in the last bits of a float32,
so a likelihood ratio is held to the reference's to a stated relative
tolerance (``ROADMAP.md``, "What held against means"), not bit for bit.
"""

from __future__ import annotations

import torch

from variantcalling_tpu_torch.ops.math import safe_divide


def correct_multinomial_frequencies(counts: torch.Tensor) -> torch.Tensor:
    """Add-one-corrected category frequencies along the last axis."""
    corrected = counts + 1.0
    return corrected / torch.sum(corrected, dim=-1, keepdim=True)


def multinomial_log_pmf(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """log PMF of counts ``x`` (…, K) under category probabilities ``p`` (…, K)."""
    x = torch.as_tensor(x).to(torch.float32)
    n = torch.sum(x, dim=-1)
    coeff = torch.lgamma(n + 1.0) - torch.sum(torch.lgamma(x + 1.0), dim=-1)
    logp = torch.sum(torch.where(x > 0, x * torch.log(p), torch.zeros_like(x)), dim=-1)
    return coeff + logp


def multinomial_likelihood(actual: torch.Tensor, expected: torch.Tensor) -> torch.Tensor:
    """Batched likelihood of ``actual`` under the add-one-corrected fit to ``expected``."""
    return torch.exp(multinomial_log_pmf(actual, correct_multinomial_frequencies(expected)))


def multinomial_likelihood_ratio(actual: torch.Tensor, expected: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched (likelihood, likelihood ratio against the self-fit), in log space."""
    log_l = multinomial_log_pmf(actual, correct_multinomial_frequencies(expected))
    log_max = multinomial_log_pmf(actual, correct_multinomial_frequencies(actual))
    return torch.exp(log_l), torch.exp(log_l - log_max)


def scale_contingency_table(table: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Batched table rescale to a total of about ``n`` (int32)."""
    table = torch.as_tensor(table)
    n = torch.as_tensor(n, device=table.device)
    s = torch.sum(table, dim=-1, keepdim=True)
    scaled = torch.where(s > 0, torch.round(table * (n[..., None] / torch.clamp(s, min=1))), table)
    return scaled.to(torch.int32)


def precision_from_counts(fp: torch.Tensor, tp: torch.Tensor, fill: float = 1.0) -> torch.Tensor:
    """Batched precision, ``fill`` where nothing was called."""
    return 1.0 - safe_divide(fp, fp + tp, fill=1.0 - fill)


def recall_from_counts(fn: torch.Tensor, tp: torch.Tensor, fill: float = 1.0) -> torch.Tensor:
    """Batched recall, ``fill`` where there is no truth."""
    return 1.0 - safe_divide(fn, fn + tp, fill=1.0 - fill)


def f1_from_pr(precision: torch.Tensor, recall: torch.Tensor) -> torch.Tensor:
    """Batched F1 (harmonic mean); 0 where precision + recall is 0."""
    return safe_divide(2 * precision * recall, precision + recall, fill=0.0)


def confusion_counts(is_positive_call: torch.Tensor, is_true: torch.Tensor, fn_extra: torch.Tensor | int = 0):
    """(tp, fp, fn) from boolean call and truth vectors plus an out-of-band FN count."""
    is_positive_call = torch.as_tensor(is_positive_call).to(torch.bool)
    is_true = torch.as_tensor(is_true).to(torch.bool)
    tp = torch.sum(is_positive_call & is_true)
    fp = torch.sum(is_positive_call & ~is_true)
    fn = torch.sum(~is_positive_call & is_true) + fn_extra
    return tp, fp, fn


def precision_recall_curve_dense(
    labels: torch.Tensor,
    scores: torch.Tensor,
    fn_count: torch.Tensor | int = 0,
    valid: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Dense (per-rank) FN-aware precision/recall curve: ``scores`` sorted
    descending (stable), cumulative precision and recall at every rank;
    ``valid`` masks padding rows out."""
    labels = torch.as_tensor(labels).to(torch.bool)
    scores = torch.as_tensor(scores, device=labels.device).to(torch.float32)
    if valid is not None:
        valid = torch.as_tensor(valid, device=labels.device).to(torch.bool)
        labels = labels & valid
        scores = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
        n_valid = torch.sum(valid)
    else:
        n_valid = labels.shape[0]
    order = torch.argsort(-scores, stable=True)
    sorted_labels = labels[order].to(torch.int32)
    ranks = torch.arange(1, labels.shape[0] + 1, device=labels.device, dtype=torch.int32)
    tps = torch.cumsum(sorted_labels, dim=0, dtype=torch.int32)
    in_range = ranks <= n_valid
    zero = torch.zeros((), dtype=torch.float32, device=labels.device)
    fps = torch.where(in_range, ranks - tps, torch.zeros_like(tps))
    precision = torch.where(in_range, tps / ranks, zero)
    total_true = tps[-1] + fn_count
    recall = torch.where(in_range, tps / torch.clamp(torch.as_tensor(total_true), min=1), zero)
    f1 = f1_from_pr(precision, recall)
    return {
        "threshold": scores[order],
        "precision": precision,
        "recall": recall,
        "f1": torch.where(in_range, f1, zero),
        "tp": tps,
        "fp": fps,
        "valid": in_range,
    }
