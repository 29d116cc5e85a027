"""Cohort count aggregation: the (S, L, A) per-sample tensor summed over samples.

Counterpart of ``variantcalling_tpu/sec/aggregate.py``. On one device the
reference's mesh all-reduce is one reduction over the sample axis
(:func:`aggregate_on_device`). The sums are exact: the counts are
non-negative integers, and every partial sum of a column whose total stays
below 2^24 is an integer a float32 holds, in any order of summation. The
bound is checked, and a cohort past it raises rather than rounding.

``aggregate_on_mesh`` (samples sharded over several GPUs, one NCCL
all-reduce) and the multi-host cohort of ``sec_training`` wait for
multi-GPU support (``ROADMAP.md`` A7).
"""

from __future__ import annotations

import numpy as np
import torch

#: the largest count a float32 sum holds exactly (2^24)
EXACT_LIMIT = float(1 << 24)


def pad_samples_to_devices(sample_counts: np.ndarray, n_dev: int) -> np.ndarray:
    """Zero-pad the sample axis to a multiple of ``n_dev``: the padding rows
    are all zero, the additive identity of the cohort sum."""
    s = sample_counts.shape[0]
    pad = (-s) % n_dev
    if not pad:
        return sample_counts
    return np.concatenate(
        [sample_counts, np.zeros((pad, *sample_counts.shape[1:]), sample_counts.dtype)], axis=0)


def aggregate_on_device(dense: np.ndarray | torch.Tensor, device: torch.device) -> np.ndarray:
    """(S, L, A) float32 per-sample counts -> (L, A) float32 cohort sum,
    computed on ``device``; raises ``ValueError`` where a sum reaches 2^24."""
    x = torch.as_tensor(dense, dtype=torch.float32).to(device)
    total = x.sum(dim=0)
    peak = float(total.max()) if total.numel() else 0.0
    if peak >= EXACT_LIMIT:
        raise ValueError(f"a cohort count sums to {peak:.0f}, past 2^24: a float32 sum would round it")
    return total.cpu().numpy()
