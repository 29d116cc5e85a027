"""Concordance tallies: per-category tp/fp/fn counts and their accuracy.

Counterpart of ``variantcalling_tpu/ops/concordance.py``. Each variant
contributes a one-hot effective class (after the filter), each (possibly
overlapping) category a mask. The reference tallies them as one float32
matmul on its device; here each category's counts are a sum of masked
booleans into int64 on the tensors' device (exact at any row count, and no
integer matrix product, which CUDA does not have), and the accuracy is
formed in float32 from them as the reference forms it.
"""

from __future__ import annotations

import numpy as np
import torch


def effective_classes(is_tp: torch.Tensor, is_fp: torch.Tensor, is_fn: torch.Tensor,
                      passes_filter: torch.Tensor) -> torch.Tensor:
    """(N, 3) one-hot effective class per variant: a filtered tp becomes a
    fn, a filtered fp is removed, fns are unaffected by filters."""
    tp_eff = is_tp & passes_filter
    fp_eff = is_fp & passes_filter
    fn_eff = is_fn | (is_tp & ~passes_filter)
    return torch.stack([tp_eff, fp_eff, fn_eff], dim=-1)


def grouped_confusion(group_masks: torch.Tensor, is_tp: torch.Tensor, is_fp: torch.Tensor,
                      is_fn: torch.Tensor, passes_filter: torch.Tensor) -> torch.Tensor:
    """(G, 3) int64 [tp, fp, fn] counts per (overlapping) group, on the
    inputs' device: one masked sum a group."""
    cls = effective_classes(is_tp, is_fp, is_fn, passes_filter)
    if len(group_masks) == 0:
        return torch.zeros((0, 3), dtype=torch.int64, device=cls.device)
    return torch.stack([(cls & m.unsqueeze(-1)).sum(dim=0) for m in group_masks.to(torch.bool)])


def accuracy_from_counts(counts: np.ndarray) -> np.ndarray:
    """(G, 3) counts -> (G, 3) float32 [precision, recall, f1]; an empty
    denominator gives 1 (precision, recall) or 0 (f1)."""
    c = np.asarray(counts, dtype=np.float32)
    tp, fp, fn = c[:, 0], c[:, 1], c[:, 2]
    one = np.float32(1.0)
    precision = np.where(tp + fp > 0, tp / np.maximum(tp + fp, one), one).astype(np.float32)
    recall = np.where(tp + fn > 0, tp / np.maximum(tp + fn, one), one).astype(np.float32)
    f1 = np.where(precision + recall > 0,
                  np.float32(2) * precision * recall / np.maximum(precision + recall, np.float32(1e-30)),
                  np.float32(0)).astype(np.float32)
    return np.stack([precision, recall, f1], axis=-1)
