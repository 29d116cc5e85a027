"""Histogram gradient-boosted trees: the fit of the ``rf`` models, in torch.

Counterpart of ``variantcalling_tpu/models/boosting.py``: features are
quantile-binned once on the host into at most 256 bins (uint8), and each
of T complete depth-D trees grows level by level from (node, feature,
bin) gradient and hessian histograms: a cumulative sum over the bins, the
split gain, the first best (feature, bin) of each node, and the rows routed
to the children. The fitted model exports to a ``logit_sum``
:class:`FlatForest` (:func:`_to_flat_forest`), which the filter pipeline
scores.

Where the fit runs:

- on the CPU with host inputs and ``VCTPU_NATIVE_GBT`` on (the default),
  the native trainer ``gbt_fit`` (``native/src/vctpu_gbt.cc``, a copy of the
  JAX package's: partitioned rows, sibling-subtraction float32 histograms),
  as the reference does;
- otherwise the torch program of :func:`_train`, on the card (the
  histograms through the hand-written kernel of :mod:`models.gbt_hist`) or
  on the CPU (its plain version). ``binned``, the labels, the weights, the
  margin and the node ids stay on the device for the whole fit; the tree
  loop makes no host round trip, and the tree arrays come back once.

Numbers: the histograms are exact int64 sums of fixed-point gradients
(:func:`gbt_hist.to_fixed`), cumulated over the bins in int64; the split
gains are computed from them in float64, the leaf values ``-lr*G/(H+λ)``
in float64 and rounded to float32 once. The sigmoid is evaluated in float64
and rounded to float32, so that the CPU and the card, whose float32 ``exp``
differ in the last place, give the same gradients in all but rare rows.
The split rule is the reference's: the first maximum of the flattened (F*B)
gain, the last bin never a split, a node dead where its best gain is not
finite or not above 0, ``min_child_weight`` on both sides. The reference's
``mesh=`` and ``diag=`` (a fit sharded over devices) are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.models import gbt_hist
from variantcalling_tpu_torch.models.forest import LEAF, FlatForest


@dataclass(frozen=True)
class BoostConfig:
    n_trees: int = 100
    depth: int = 6
    n_bins: int = 64
    learning_rate: float = 0.15
    reg_lambda: float = 1.0
    min_child_weight: float = 1.0
    base_score: float = 0.0  # initial margin (log-odds)


def quantile_bin_edges(x: np.ndarray, n_bins: int, max_sample: int = 200_000, seed: int = 0) -> np.ndarray:
    """(F, n_bins-1) per-feature bin edges from (sub-sampled) quantiles."""
    n = x.shape[0]
    if n > max_sample:
        idx = np.random.default_rng(seed).choice(n, max_sample, replace=False)
        x = x[idx]
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    edges = np.quantile(x, qs, axis=0).T.astype(np.float32)  # (F, B-1)
    # non-decreasing edges keep searchsorted well-defined; duplicate edges
    # just leave empty bins, which cost no gain
    return np.maximum.accumulate(edges, axis=1)


def bin_features(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """(N, F) uint8 bin ids: ``searchsorted(edges[j], x[:, j], side="left")``
    at float32, NaN in the last bin; the native engine's when it serves."""
    from variantcalling_tpu_torch import native

    if edges.shape[1] > 255:
        raise ValueError(f"{edges.shape[1] + 1} bins do not fit uint8 bin ids (at most 256)")
    out = native.bin_features(x, np.asarray(edges, dtype=np.float32))
    if out is None:
        x32 = np.asarray(x, dtype=np.float32)
        e32 = np.asarray(edges, dtype=np.float32)
        out = np.empty(x32.shape, dtype=np.uint8)
        for j in range(x32.shape[1]):
            out[:, j] = np.searchsorted(e32[j], x32[:, j])
    return out


def _sigmoid(margin: torch.Tensor) -> torch.Tensor:
    """float32 sigmoid evaluated in float64 (see the module docstring)."""
    m = margin.double()
    return (1.0 / (1.0 + torch.exp(-m))).float()


def _grow_tree(binned: torch.Tensor, g: torch.Tensor, h: torch.Tensor, cfg: BoostConfig, hist=gbt_hist.gbt_hist):
    """One complete depth-D tree on ``binned``'s device.

    Returns (feats (D, 2^D) int32, bins (D, 2^D) int32, leaf (2^D,) float32,
    node_id (N,) int32 leaf of each row). ``feats[l, k]``/``bins[l, k]`` are
    the split of node k at level l (-1: dead, every row goes left), padded
    with -1/0 past the level's 2^l nodes. ``hist(binned, node_id, ghq,
    n_nodes, n_bins)`` builds a level's int64 histograms. The leaf sums are
    the last level's left and right cumulated sums at its splits (a dead
    node's rows all go left), so no further pass over the rows is made."""
    n, f = binned.shape
    b, dev = cfg.n_bins, binned.device
    leaves = 1 << cfg.depth
    lam = cfg.reg_lambda
    ghq, kg, kh = gbt_hist.to_fixed(g, h)
    node_id = torch.zeros(n, dtype=torch.int32, device=dev)
    feats = torch.full((cfg.depth, leaves), -1, dtype=torch.int32, device=dev)
    bins = torch.zeros((cfg.depth, leaves), dtype=torch.int32, device=dev)
    flat = binned.view(-1)
    row_base = torch.arange(n, device=dev, dtype=torch.int64) * f
    for level in range(cfg.depth):
        n_nodes = 1 << level
        cum = hist(binned, node_id, ghq, n_nodes, b).cumsum(dim=2)  # int64: left sums for a split at bin <= j
        tot = cum[:, :, -1:, :]
        gl, hl = gbt_hist.from_fixed(cum[..., 0], kg), gbt_hist.from_fixed(cum[..., 1], kh)
        gr, hr = gbt_hist.from_fixed((tot - cum)[..., 0], kg), gbt_hist.from_fixed((tot - cum)[..., 1], kh)
        gt, ht = gl[:, :, -1:], hl[:, :, -1:]
        gain = gl * gl / (hl + lam) + gr * gr / (hr + lam) - gt * gt / (ht + lam)  # (node, F, B) float64
        ok = (hl >= cfg.min_child_weight) & (hr >= cfg.min_child_weight)
        gain = torch.where(ok, gain, -torch.inf)
        gain[:, :, -1] = -torch.inf  # the last bin is no split
        flat_gain = gain.reshape(n_nodes, f * b)
        best = torch.argmax(flat_gain, dim=1)
        best_gain = flat_gain.gather(1, best[:, None])[:, 0]
        dead = ~torch.isfinite(best_gain) | (best_gain <= 0.0)
        bf = torch.where(dead, -1, best // b).to(torch.int32)
        bb = (best % b).to(torch.int32)
        feats[level, :n_nodes] = bf
        bins[level, :n_nodes] = bb
        if level == cfg.depth - 1:
            # the children's sums: left = cumulated up to the split bin (a
            # dead node: everything), right = the rest
            pick = (torch.arange(n_nodes, device=dev) * (f * b) + best.where(~dead, f * b - 1))
            left = cum.reshape(n_nodes * f * b, 2).index_select(0, pick)
            right = tot[:, 0, 0, :] - left
            leaf_q = torch.stack([left, right], dim=1).reshape(leaves, 2)
        # route rows: right iff bin[best_feat] > best_bin (dead -> left)
        nf = bf.clamp(min=0)[node_id].to(torch.int64)
        sample_bin = flat[row_base + nf].to(torch.int32)
        go_right = (bf[node_id] >= 0) & (sample_bin > bb[node_id])
        node_id = node_id * 2 + go_right.to(torch.int32)
    leaf_g, leaf_h = gbt_hist.from_fixed(leaf_q[:, 0], kg), gbt_hist.from_fixed(leaf_q[:, 1], kh)
    leaf = (-cfg.learning_rate * leaf_g / (leaf_h + lam)).float()
    return feats, bins, leaf, node_id


def _train(binned: torch.Tensor, y01: torch.Tensor, w: torch.Tensor, cfg: BoostConfig):
    """The whole fit on ``binned``'s device: (feats (T, D, 2^D), bins, leaves
    (T, 2^D)) as device tensors."""
    n = binned.shape[0]
    leaves = 1 << cfg.depth
    dev = binned.device
    margin = torch.full((n,), cfg.base_score, dtype=torch.float32, device=dev)
    all_feats = torch.empty((cfg.n_trees, cfg.depth, leaves), dtype=torch.int32, device=dev)
    all_bins = torch.empty_like(all_feats)
    all_leaves = torch.empty((cfg.n_trees, leaves), dtype=torch.float32, device=dev)
    for t in range(cfg.n_trees):
        p = _sigmoid(margin)
        g = w * (p - y01)
        h = torch.clamp(w * p * (1.0 - p), min=1e-12)
        feats, bins, leaf, node_id = _grow_tree(binned, g, h, cfg)
        margin = margin + leaf[node_id]
        all_feats[t], all_bins[t], all_leaves[t] = feats, bins, leaf
    return all_feats, all_bins, all_leaves


def fit(
    x: np.ndarray,
    y: np.ndarray,
    sample_weight: np.ndarray | None = None,
    cfg: BoostConfig = BoostConfig(),
    feature_names: list[str] | None = None,
    edges: np.ndarray | None = None,
    device: torch.device | str = "gpu",
) -> FlatForest:
    """Fit a boosted forest on ``device`` (the card unless the caller asks for
    the CPU). Host numpy inputs: the bin edges and the uint8 bin ids are
    computed on the host, and on the CPU the native trainer serves when
    ``VCTPU_NATIVE_GBT`` is on (see the module docstring)."""
    dev = device_mod.as_device(device)
    x = np.asarray(x, dtype=np.float32)
    y01 = np.asarray(y, dtype=np.float32)
    w = np.ones(len(y01), dtype=np.float32) if sample_weight is None else np.asarray(sample_weight, np.float32)
    if edges is None:
        edges = quantile_bin_edges(x, cfg.n_bins)
    edges = np.asarray(edges, dtype=np.float32)
    if edges.shape[1] >= cfg.n_bins:
        raise ValueError(f"{edges.shape[1]} bin edges for {cfg.n_bins} bins")
    binned = bin_features(x, edges)

    if dev.type == "cpu" and edges.shape[1] == cfg.n_bins - 1 and knobs.get_bool("VCTPU_NATIVE_GBT"):
        from variantcalling_tpu_torch import native

        res = native.gbt_fit(binned, y01, None if sample_weight is None else w,
                             cfg.n_trees, cfg.depth, cfg.n_bins, cfg.learning_rate, cfg.reg_lambda,
                             cfg.min_child_weight, cfg.base_score)
        if res is not None:
            return _to_flat_forest(*res, edges, cfg, feature_names)

    gbt_hist.load(dev)
    feats, bins, leaves = _train(torch.from_numpy(binned).to(dev), torch.from_numpy(y01).to(dev),
                                 torch.from_numpy(w).to(dev), cfg)
    return _to_flat_forest(feats.cpu().numpy(), bins.cpu().numpy(), leaves.cpu().numpy(), edges, cfg,
                           feature_names)


def _to_flat_forest(
    feats: np.ndarray,  # (T, D, 2^D)
    bins: np.ndarray,
    leaves: np.ndarray,  # (T, 2^D)
    edges: np.ndarray,  # (F, B-1)
    cfg: BoostConfig,
    feature_names: list[str] | None,
) -> FlatForest:
    """Heap-layout complete trees -> FlatForest node arrays.

    Internal node (level l, k-th) sits at heap index 2^l-1+k; leaves fill
    the last level. Dead splits keep feature 0 with threshold +inf (all
    samples route left), preserving the complete-tree shape.
    """
    t, d, _ = feats.shape
    n_leaves = 1 << d
    m = (1 << (d + 1)) - 1
    feature = np.full((t, m), LEAF, dtype=np.int32)
    threshold = np.zeros((t, m), dtype=np.float32)
    left = np.tile(np.arange(m, dtype=np.int32), (t, 1))
    right = np.tile(np.arange(m, dtype=np.int32), (t, 1))
    value = np.zeros((t, m), dtype=np.float32)
    for level in range(d):
        n_nodes = 1 << level
        base = (1 << level) - 1
        idx = base + np.arange(n_nodes)
        bf = feats[:, level, :n_nodes]  # (T, n_nodes)
        bb = bins[:, level, :n_nodes]
        dead = bf < 0
        safe_f = np.maximum(bf, 0)
        # split "bin <= j" -> threshold edges[f, j] (right-open); last edge
        # index clamped (the no-split rules make it unreachable)
        thr = edges[safe_f, np.minimum(bb, edges.shape[1] - 1)]
        feature[:, idx] = np.where(dead, 0, safe_f)
        threshold[:, idx] = np.where(dead, np.float32(np.inf), thr)
        left[:, idx] = 2 * idx + 1
        right[:, idx] = 2 * idx + 2
    leaf_idx = (1 << d) - 1 + np.arange(n_leaves)
    value[:, leaf_idx] = leaves
    return FlatForest(
        feature=feature,
        threshold=threshold,
        left=left,
        right=right,
        value=value,
        max_depth=d,
        aggregation="logit_sum",
        base_score=cfg.base_score,
        feature_names=feature_names or [],
    )
