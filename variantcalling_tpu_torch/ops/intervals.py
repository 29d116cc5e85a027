"""Interval membership and distance via sorted-interval joins on global coordinates.

Counterpart of ``variantcalling_tpu/ops/intervals.py`` (host numpy in the
reference too: a genome needs int64 coordinates; large membership joins in
the native engine). Contig i occupies
[offset[i], offset[i] + len_i), so (chrom, pos) pairs become one int64 axis.
"""

from __future__ import annotations

import numpy as np

from variantcalling_tpu_torch import native
from variantcalling_tpu_torch.io.bed import IntervalSet

_FAR = np.iinfo(np.int64).max // 4
#: joins of at least this many positions run in the native engine's binary search
NATIVE_MIN_POSITIONS = 1 << 16


class GenomeCoords:
    """Contig name -> global-offset mapping (static per run)."""

    def __init__(self, contig_lengths: dict[str, int]):
        self.names = list(contig_lengths)
        self.lengths = np.asarray([contig_lengths[c] for c in self.names], dtype=np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)[:-1]]).astype(np.int64)
        self._index = {c: i for i, c in enumerate(self.names)}

    def contig_index(self, chrom: np.ndarray) -> np.ndarray:
        return np.fromiter((self._index.get(c, -1) for c in chrom), dtype=np.int64, count=len(chrom))

    def globalize(self, chrom: np.ndarray, pos0: np.ndarray) -> np.ndarray:
        """(chrom str array, 0-based pos) -> global int64 position; -1 for unknown contigs."""
        idx = self.contig_index(chrom)
        g = self.offsets[np.maximum(idx, 0)] + np.asarray(pos0, dtype=np.int64)
        return np.where(idx >= 0, g, -1)

    def globalize_intervals(self, iv: IntervalSet) -> tuple[np.ndarray, np.ndarray]:
        """Merged interval set -> sorted (gstarts, gends); unknown contigs dropped."""
        merged = iv.merged()
        idx = self.contig_index(merged.chrom)
        keep = idx >= 0
        gs = self.offsets[idx[keep]] + merged.start[keep]
        ge = self.offsets[idx[keep]] + merged.end[keep]
        order = np.argsort(gs)
        return gs[order], ge[order]


def membership(gpos: np.ndarray, gstarts: np.ndarray, gends: np.ndarray) -> np.ndarray:
    """Bool membership of global positions in sorted disjoint intervals."""
    gpos = np.asarray(gpos, dtype=np.int64)
    if len(gstarts) == 0:
        return np.zeros(gpos.shape, dtype=bool)
    if gpos.size >= NATIVE_MIN_POSITIONS:
        out = native.interval_membership(gstarts, gends, np.maximum(gpos, 0))
        if out is not None:
            return out.astype(bool) & (gpos >= 0)
    idx = np.searchsorted(gstarts, gpos, side="right") - 1
    safe = np.clip(idx, 0, len(gstarts) - 1)
    return (idx >= 0) & (gpos < gends[safe]) & (gpos >= 0)


def distance_to_nearest(gpos: np.ndarray, gstarts: np.ndarray, gends: np.ndarray) -> np.ndarray:
    """Distance (bp) from each position to the nearest interval; 0 inside one.

    Contig boundaries are ignored on the global axis, as in the reference.
    """
    gpos = np.asarray(gpos, dtype=np.int64)
    if len(gstarts) == 0:
        return np.full(gpos.shape, _FAR, dtype=np.int64)
    unknown = gpos < 0
    idx = np.searchsorted(gstarts, gpos, side="right") - 1
    prev_idx = np.clip(idx, 0, len(gstarts) - 1)
    next_idx = np.clip(idx + 1, 0, len(gstarts) - 1)
    inside = (idx >= 0) & (gpos < gends[prev_idx])
    d_prev = np.where(idx >= 0, np.maximum(gpos - gends[prev_idx] + 1, 0), _FAR)
    d_next = np.where(idx + 1 < len(gstarts), np.maximum(gstarts[next_idx] - gpos, 0), _FAR)
    return np.where(unknown, _FAR, np.where(inside, 0, np.minimum(d_prev, d_next)))
