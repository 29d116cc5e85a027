"""CNV calling from binned coverage: GC normalization and HMM segmentation.

Counterpart of ``variantcalling_tpu/cnv/caller.py``. The normalization
(median and GC-stratum scaling to log2 ratios) and the run-length merge of
states into segments stay numpy on the host, as in the reference
(``np.median`` averages the two middle values, where ``torch.median``
returns the lower one). The copy-number HMM's Viterbi runs on the run's
device (:mod:`cnv.viterbi_cuda`): on the card, one launch of the
hand-written kernel for all contigs; on the CPU, its plain version.

States: copy number 0..4 (del0, del1, neutral, dup3, dup4); emissions are
Gaussian in log2-ratio space centred at log2(cn/2) (cn=0 floored at -3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch.cnv import viterbi_cuda
from variantcalling_tpu_torch.cnv.viterbi_cuda import LOG2_FLOOR, state_means  # noqa: F401  (the reference's names)

COPY_STATES = np.arange(viterbi_cuda.K)


def normalize_coverage(depth: np.ndarray, gc: np.ndarray | None = None, n_gc_bins: int = 20) -> np.ndarray:
    """Binned depth -> float32 log2 ratio against the median of the covered
    bins, each GC stratum (of at least 10 bins) first scaled to that median."""
    depth = np.asarray(depth, dtype=np.float64)
    med = np.median(depth[depth > 0]) if (depth > 0).any() else 1.0
    corrected = depth.astype(np.float64)
    if gc is not None:
        gc_bin = np.clip((np.asarray(gc) * n_gc_bins).astype(int), 0, n_gc_bins - 1)
        for b in range(n_gc_bins):
            m = gc_bin == b
            if m.sum() >= 10:
                stratum_med = np.median(corrected[m][corrected[m] > 0]) if (corrected[m] > 0).any() else med
                if stratum_med > 0:
                    corrected[m] *= med / stratum_med
    ratio = corrected / max(med, 1e-9)
    return np.log2(np.maximum(ratio, 2.0**LOG2_FLOOR)).astype(np.float32)


def segment_states(log2_ratios: list[np.ndarray], sigma: float = 0.35, p_stay: float = 0.999,
                   device: torch.device | str = "gpu") -> list[np.ndarray]:
    """The most likely copy-number state of every bin of each sequence, all
    sequences in one call on ``device``."""
    dev = device_mod.as_device(device)
    lens = [len(lr) for lr in log2_ratios]
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]).astype(np.int64))
    obs = torch.from_numpy(np.concatenate([np.asarray(lr, dtype=np.float32) for lr in log2_ratios])
                           if log2_ratios else np.zeros(0, np.float32)).to(dev)
    states = viterbi_cuda.viterbi_states(obs, offsets, viterbi_cuda.hmm_params(sigma, p_stay)).cpu().numpy()
    return [states[lo:hi] for lo, hi in zip(offsets[:-1].tolist(), offsets[1:].tolist())]


def viterbi_segment(log2_ratio: np.ndarray, sigma: float = 0.35, p_stay: float = 0.999,
                    device: torch.device | str = "gpu") -> np.ndarray:
    """Most likely copy-number state per bin (int32)."""
    return segment_states([log2_ratio], sigma, p_stay, device)[0]


@dataclass
class Segment:
    chrom: str
    start: int  # 0-based bin-aligned
    end: int
    copy_number: int
    n_bins: int
    mean_log2: float


def states_to_segments(states: np.ndarray, log2_ratio: np.ndarray, chrom: str, bin_size: int,
                       min_bins: int = 3) -> list[Segment]:
    """Run-length merge of per-bin states into CNV segments (neutral dropped)."""
    segs: list[Segment] = []
    n = len(states)
    i = 0
    while i < n:
        j = i
        while j < n and states[j] == states[i]:
            j += 1
        cn = int(COPY_STATES[states[i]])
        if cn != 2 and (j - i) >= min_bins:
            segs.append(Segment(chrom=chrom, start=i * bin_size, end=j * bin_size, copy_number=cn, n_bins=j - i,
                                mean_log2=float(np.mean(log2_ratio[i:j]))))
        i = j
    return segs


def call_cnvs(depth_per_contig: dict[str, np.ndarray], bin_size: int,
              gc_per_contig: dict[str, np.ndarray] | None = None, sigma: float = 0.35, p_stay: float = 0.999,
              min_bins: int = 3, device: torch.device | str = "gpu") -> list[Segment]:
    """End to end: normalize jointly, then segment every contig (one Viterbi
    call for all of them)."""
    names = list(depth_per_contig)
    if not names:
        return []
    all_depth = np.concatenate([depth_per_contig[c] for c in names])
    all_gc = np.concatenate([gc_per_contig[c] for c in names]) if gc_per_contig else None
    log2 = normalize_coverage(all_depth, all_gc)
    bounds = np.concatenate([[0], np.cumsum([len(depth_per_contig[c]) for c in names])])
    ratios = [log2[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
    segs: list[Segment] = []
    for c, lr, states in zip(names, ratios, segment_states(ratios, sigma, p_stay, device)):
        segs.extend(states_to_segments(states, lr, c, bin_size, min_bins))
    return segs
