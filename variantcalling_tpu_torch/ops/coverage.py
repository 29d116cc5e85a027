"""Coverage reductions on the run's device: window means, depth histograms, percentiles, stats.

Counterpart of ``variantcalling_tpu/ops/coverage.py`` (plain XLA there, no
Pallas kernel): a contig's depth is one int32 tensor on the run's device
and every product is a torch reduction over it, with the reference's
formulas and float32 where it computes in float32:

- :func:`binned_mean`: each window's sum exactly in int64, cast to float32
  once, over the float32 count. While a window's sum is below 2^24 this is
  the reference's float32 sum bit for bit (every partial sum is exact
  there; the rule ``host_coverage_stats`` states); past it, it is the
  exact sum rounded once;
- :func:`depth_histogram`: ``torch.bincount`` of the clipped depth, masked
  positions sent to a sacrificial bin that is dropped, cast to float32 at
  the end as the reference casts;
- :func:`percentiles_from_histogram`, :func:`stats_from_histogram`: float32
  over the 1,001 bins. XLA and torch add those bins in other orders, so
  the stats agree to float32 rounding, not bit for bit;
- :func:`interval_histograms`, and :func:`mask_from_intervals`, built on
  the device from the interval bounds (a difference array and a cumsum).

:func:`host_coverage_stats` is the serving daemon's host reduce (its
``/v1/coverage``): the native engine's one-pass ``coverage_stats``, or its
plain numpy twin in cache-sized tiles, with the reference's means, histogram
and percentiles.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_DEPTH_BIN = 1000  # depths clip into [0, MAX_DEPTH_BIN] for histograms


def depth_from_diff(diff: torch.Tensor) -> torch.Tensor:
    """The int32 depth of a contig from its (length + 1,) int32 difference
    array: a cumsum in int32 on the array's device (``io.bam.depth_vectors``)."""
    return torch.cumsum(diff[:-1], 0, dtype=torch.int32)


def binned_mean(depth: torch.Tensor, window: int) -> torch.Tensor:
    """Mean depth per non-overlapping window; the tail window averages its remainder."""
    n = depth.shape[0]
    n_full = n // window
    sums = depth[: n_full * window].view(n_full, window).sum(1, dtype=torch.int64)
    counts = torch.full((n_full,), float(window), dtype=torch.float32, device=depth.device)
    if n_full * window < n:
        sums = torch.cat([sums, depth[n_full * window:].sum(dtype=torch.int64).view(1)])
        counts = torch.cat([counts, counts.new_full((1,), float(n - n_full * window))])
    return sums.to(torch.float32) / counts


def depth_histogram(depth: torch.Tensor, mask: torch.Tensor | None = None,
                    max_depth: int = MAX_DEPTH_BIN) -> torch.Tensor:
    """(max_depth + 1,) float32 histogram of the depth clipped to
    [0, max_depth]; with ``mask``, of the positions it marks only."""
    clipped = depth.clamp(0, max_depth)
    n_bins = max_depth + 1
    if mask is not None:
        # masked-out positions go to a sacrificial bin, then dropped
        clipped = torch.where(mask, clipped, max_depth + 1)
        n_bins = max_depth + 2
    hist = torch.bincount(clipped, minlength=n_bins)
    return hist[: max_depth + 1].to(torch.float32)


#: positions a tile of the plain host reduce: about 4 M keeps a tile in cache
_HOST_TILE_POSITIONS = 4 << 20


def host_coverage_stats(depth: np.ndarray, window: int, max_depth: int = MAX_DEPTH_BIN,
                        qs: np.ndarray | None = None, from_diffs: bool = False) -> dict[str, np.ndarray]:
    """One pass over a host depth vector: per-window float32 means (each
    window's exact int64 sum rounded once), the float32 histogram of the depth
    clipped to [0, max_depth] and, with ``qs``, the int32 depth at each
    quantile (:func:`percentiles_from_histogram`'s rule in numpy). With
    ``from_diffs`` the input is a difference array integrated on the fly.
    The native engine's ``coverage_stats`` serves it; without the engine the
    plain numpy reduce below, tile by tile, gives the same arrays."""
    from variantcalling_tpu_torch import native

    depth = np.ascontiguousarray(depth, dtype=np.int32)
    got = native.coverage_stats(depth, window, max_bin=max_depth, from_diffs=from_diffs)
    if got is not None:
        means, hist = got
    else:
        means, hist = coverage_stats_plain(depth, window, max_depth, from_diffs)
    out = {"means": means, "hist": hist.astype(np.float32)}
    if qs is not None:
        q = np.maximum(np.asarray(qs, dtype=np.float32) * (1.0 - 1e-6), 1e-9)
        total = out["hist"].sum(dtype=np.float32)
        cdf = np.cumsum(out["hist"], dtype=np.float32) / max(total, 1.0)
        out["percentiles"] = np.argmax(cdf[None, :] >= q[:, None], axis=1).astype(np.int32)
    return out


def coverage_stats_plain(depth: np.ndarray, window: int, max_depth: int,
                         from_diffs: bool) -> tuple[np.ndarray, np.ndarray]:
    """The native ``coverage_stats``' plain twin: (float32 means, int64 histogram)."""
    n = len(depth)
    n_win = -(-n // window) if n else 0
    means = np.empty(n_win, dtype=np.float32)
    hist = np.zeros(max_depth + 1, dtype=np.int64)
    tile_w = max(1, _HOST_TILE_POSITIONS // window)
    run = np.int64(0)
    for wlo in range(0, n_win, tile_w):
        whi = min(wlo + tile_w, n_win)
        lo, hi = wlo * window, min(n, whi * window)
        seg = depth[lo:hi]
        if from_diffs:
            seg = np.cumsum(seg, dtype=np.int64) + run
            run = seg[-1] if len(seg) else run
        pad = (whi - wlo) * window - (hi - lo)
        sums = np.pad(seg, (0, pad)).reshape(whi - wlo, window).sum(axis=1, dtype=np.int64)
        counts = np.full(whi - wlo, window, dtype=np.float32)
        if pad:
            counts[-1] = window - pad
        means[wlo:whi] = sums.astype(np.float32) / counts
        hist += np.bincount(np.clip(seg, 0, max_depth), minlength=max_depth + 1)
    return means, hist


def percentiles_from_histogram(hist: torch.Tensor, qs) -> torch.Tensor:
    """int32 depth at each quantile q in [0, 1]: the first depth whose float32
    cdf reaches q (q backed off by 1e-6 of itself, floored at 1e-9)."""
    qs = torch.as_tensor(np.asarray(qs), dtype=torch.float32, device=hist.device)
    qs = torch.clamp_min(qs * (1.0 - 1e-6), 1e-9)
    total = torch.sum(hist)
    cdf = torch.cumsum(hist, 0) / torch.clamp_min(total, 1.0)
    return torch.argmax((cdf[None, :] >= qs[:, None]).to(torch.uint8), dim=1).to(torch.int32)


def stats_from_histogram(hist: torch.Tensor) -> dict[str, torch.Tensor]:
    """mean, std, median and the shares at or above 1, 5, 10, 20, 50 and 100x
    and between 25 % and 175 % of the median, from one float32 histogram."""
    depths = torch.arange(hist.shape[0], dtype=torch.float32, device=hist.device)
    total = torch.clamp_min(torch.sum(hist), 1.0)
    p = hist / total
    mean = torch.sum(p * depths)
    var = torch.sum(p * (depths - mean) ** 2)
    cdf = torch.cumsum(p, 0)
    median = torch.argmax((cdf >= 0.5).to(torch.uint8)).to(torch.float32)
    out = {"mean": mean, "std": torch.sqrt(var), "median": median}
    zero = p.new_zeros(())
    for thr in (1, 5, 10, 20, 50, 100):
        out[f"percent_larger_than_{thr:02d}x"] = 100.0 * torch.sum(torch.where(depths >= thr, p, zero))
    lo, hi = 0.25 * median, 1.75 * median
    out["percent_between_25_and_175_of_median"] = 100.0 * torch.sum(
        torch.where((depths >= lo) & (depths <= hi), p, zero))
    return out


def interval_histograms(depth: torch.Tensor, interval_masks: torch.Tensor) -> torch.Tensor:
    """(K, MAX_DEPTH_BIN + 1) float32 histograms of one depth vector under K
    bool masks (K, N): one bincount over the K masks' bins side by side."""
    k = interval_masks.shape[0]
    width = MAX_DEPTH_BIN + 2
    clipped = depth.clamp(0, MAX_DEPTH_BIN).to(torch.int64)
    offs = torch.arange(k, dtype=torch.int64, device=depth.device)[:, None] * width
    ids = offs + torch.where(interval_masks, clipped[None, :], MAX_DEPTH_BIN + 1)
    hist = torch.bincount(ids.reshape(-1), minlength=k * width).view(k, width)
    return hist[:, : MAX_DEPTH_BIN + 1].to(torch.float32)


def mask_from_intervals(length: int, starts, ends, device: torch.device | str) -> torch.Tensor:
    """(length,) bool mask of the [start, end) intervals over a contig, built
    on ``device``: +1 at each clipped start, -1 at each clipped end, an int32
    cumsum, > 0."""
    dev = torch.device(device)
    s = torch.as_tensor(np.clip(np.asarray(starts, dtype=np.int64), 0, length), device=dev)
    e = torch.as_tensor(np.clip(np.asarray(ends, dtype=np.int64), 0, length), device=dev)
    diff = torch.zeros(length + 1, dtype=torch.int32, device=dev)
    diff.index_add_(0, s, torch.ones(len(s), dtype=torch.int32, device=dev))
    diff.index_add_(0, e, torch.full((len(e),), -1, dtype=torch.int32, device=dev))
    return torch.cumsum(diff[:-1], 0, dtype=torch.int32) > 0
