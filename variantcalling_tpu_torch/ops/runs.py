"""Homopolymer runs of a whole contig in one program on the caller's device.

Counterpart of ``variantcalling_tpu/ops/runs.py`` on its single-device
path. A run starts wherever a base differs from its predecessor
(``codes[1:] != codes[:-1]``); the start indices come from one
``torch.nonzero`` and each run's exact length is the difference of
consecutive starts (the last one ends at the contig's end). The selection
is the reference's ``select_runs`` rule: runs of real bases (code < 4) of
at least ``min_length``; only the selected starts and lengths return to the
host.

The reference's per-position run lengths (a suffix recurrence as one
``lax.associative_scan``) and its host stitching of halo-capped lengths
serve only its position-sharded scan over several devices, which comes
with multi-GPU work (``ROADMAP.md`` A7): one device holds a whole contig
here, so every length is exact without them.
"""

from __future__ import annotations

import numpy as np
import torch


def run_starts_lengths(codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(start index, length) of every run of equal codes, int64, on ``codes``' device."""
    n = codes.shape[0]
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=codes.device)
        return empty, empty
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=codes.device),
                        torch.nonzero(codes[1:] != codes[:-1])[:, 0] + 1])
    ends = torch.cat([starts[1:], torch.full((1,), n, dtype=torch.int64, device=codes.device)])
    return starts, ends - starts


def select_runs(codes: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
                min_length: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The runs of real bases (code < 4) of at least ``min_length``."""
    keep = (lengths >= min_length) & (codes[starts] < 4)
    return starts[keep], lengths[keep]


def find_runs(codes: np.ndarray, min_length: int, device: torch.device | str = "cpu") -> tuple[np.ndarray, np.ndarray]:
    """(0-based starts, lengths) of the homopolymer runs of at least
    ``min_length`` real bases of a uint8-coded contig (A..T = 0..3, N = 4),
    the contig uploaded once and scanned on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
    starts, lengths = select_runs(t, *run_starts_lengths(t), min_length)
    return starts.cpu().numpy(), lengths.cpu().numpy()
