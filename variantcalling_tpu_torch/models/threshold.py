"""Threshold model for somatic callsets (TLOD/SOR), in torch.

Counterpart of ``variantcalling_tpu/models/threshold.py``: each of the
model's features contributes ``sigmoid((x - thr) * sign / scale)`` and
TREE_SCORE is the product, 0.5 at a feature's threshold, PASS at
``score >= pass_threshold``. The field names are the reference's, so its
pickles unpickle into :class:`ThresholdModel` (``models/registry.py``).
:func:`fit_threshold_model` is the reference's grid fit, its sweep a torch
program on the run's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch.engine import EngineError


@dataclass
class ThresholdModel:
    feature_names: list[str]  # features used, in order of thresholds
    thresholds: np.ndarray  # float32 (F,)
    signs: np.ndarray  # +1 = higher is better, -1 = lower is better
    scales: np.ndarray  # softness per feature
    pass_threshold: float = 0.5
    all_feature_names: list[str] = field(default_factory=list)  # column order of X

    def column_indices(self, feature_names: list[str]) -> np.ndarray:
        missing = [f for f in self.feature_names if f not in feature_names]
        if missing:
            raise EngineError(f"threshold model needs feature(s) {missing} absent from the run's "
                              f"feature layout {sorted(feature_names)}")
        return np.asarray([feature_names.index(f) for f in self.feature_names], dtype=np.int32)


def predict_score(model: ThresholdModel, x: torch.Tensor, feature_names: list[str] | None = None
                  ) -> torch.Tensor:
    """TREE_SCORE in [0, 1] of (N, F) float32 features, on their device; the
    model's columns are chosen by name from ``feature_names`` (default: the
    model's own column order)."""
    return make_score_predictor(model, feature_names or model.all_feature_names or model.feature_names,
                                x.device)(x)


def make_score_predictor(model: ThresholdModel, feature_names: list[str], device: torch.device):
    """fn(x: (N, F) float32 on ``device``) -> (N,) float32 scores, the columns
    picked by name once."""
    cols = torch.as_tensor(model.column_indices(feature_names), dtype=torch.int64, device=device)

    def param(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    thr, sign, scale = param(model.thresholds), param(model.signs), param(model.scales)

    def program(x: torch.Tensor) -> torch.Tensor:
        margins = (x.index_select(1, cols) - thr) * sign / scale
        return torch.prod(torch.sigmoid(margins), dim=1)

    return program


#: rows of one step of the grid sweep: its (rows, combos, features) compare stays near 150 MB
_SWEEP_ROWS = 1 << 16


def fit_threshold_model(
    x: np.ndarray,
    y: np.ndarray,
    feature_names: list[str],
    candidate_features: list[str] | None = None,
    sample_weight: np.ndarray | None = None,
    n_grid: int = 24,
    pass_threshold: float = 0.25,
    device: torch.device | str = "gpu",
) -> ThresholdModel:
    """Fit thresholds by exhaustive grid search, as the reference does: the
    same 500,000-row subsample past that size (``default_rng(0)``), signs
    from the class means, per-feature candidates at the 2 %..98 % quantiles,
    and the joint grid scored on ``device`` (the card unless the caller asks
    for the CPU): every row passes a combination when each feature is on its
    good side, and the combination of highest F1 wins, the first on a tie.

    tp and fp are summed in float64, which is exact (and so independent of
    the order of the sum) for the integer-valued weights the tools pass;
    F1 is then formed in float32 as the reference forms it, so that
    ``argmax`` picks the reference's cell."""
    dev = device_mod.as_device(device)
    cand = [f for f in (candidate_features or ["tlod", "sor"]) if f in feature_names]
    if not cand:  # fall back to the two strongest features by |corr|
        corr = [abs(float(np.corrcoef(x[:, i], y)[0, 1])) if np.std(x[:, i]) > 0 else 0.0 for i in range(x.shape[1])]
        cand = [feature_names[i] for i in np.argsort(corr)[::-1][:2]]
    cols = [feature_names.index(f) for f in cand]
    xs = np.asarray(x[:, cols], dtype=np.float32)  # (N, F)
    yv = np.asarray(y, dtype=np.float32)
    wv = np.ones(len(y), np.float32) if sample_weight is None else np.asarray(sample_weight, np.float32)
    if len(xs) > 500_000:  # the reference's subsample
        sel = np.random.default_rng(0).choice(len(xs), 500_000, replace=False)
        xs, yv, wv = xs[sel], yv[sel], wv[sel]

    pos, neg = yv > 0.5, yv <= 0.5
    if not pos.any() or not neg.any():
        signs = np.ones(xs.shape[1], dtype=np.float32)
    else:
        signs = np.array(
            [1.0 if xs[pos, j].mean() >= xs[neg, j].mean() else -1.0 for j in range(xs.shape[1])],
            dtype=np.float32,
        )
    qs = np.linspace(0.02, 0.98, n_grid)
    cand_thr = np.quantile(xs, qs, axis=0).astype(np.float32)  # (G, F)
    grids = np.meshgrid(*[cand_thr[:, j] for j in range(xs.shape[1])], indexing="ij")
    combos = np.stack([g.ravel() for g in grids], axis=1)  # (G^F, F)
    idx = int(best_combo(xs, yv, wv, combos, signs, dev))
    thr = combos[idx]
    scales = np.maximum(np.std(xs, axis=0) * 0.05, 1e-3).astype(np.float32)
    return ThresholdModel(
        feature_names=cand,
        thresholds=thr.astype(np.float32),
        signs=signs,
        scales=scales,
        pass_threshold=pass_threshold,
        all_feature_names=list(feature_names),
    )


def best_combo(xs: np.ndarray, y: np.ndarray, w: np.ndarray, combos: np.ndarray, signs: np.ndarray,
               device: torch.device) -> torch.Tensor:
    """Index (a 0-d tensor on ``device``) of the max-F1 row of ``combos``
    (C, F): a row of ``xs`` passes a combination when ``(x - thr) * sign >=
    0`` for every feature; tp and fp in float64 over row steps, F1 in
    float32."""
    xs_d = torch.from_numpy(xs).to(device)
    c = torch.from_numpy(combos).to(device)
    s = torch.from_numpy(signs).to(device)
    wy = torch.from_numpy(w * y).to(device)
    wn = torch.from_numpy(w * (1 - y)).to(device)
    tp = torch.zeros(len(combos), dtype=torch.float64, device=device)
    fp = torch.zeros_like(tp)
    for lo in range(0, len(xs), _SWEEP_ROWS):
        hi = min(len(xs), lo + _SWEEP_ROWS)
        ok = (xs_d[lo:hi, None, :] - c[None, :, :]) * s[None, None, :] >= 0  # (rows, C, F)
        pred = ok.all(dim=2).double()  # (rows, C)
        tp += wy[lo:hi].double() @ pred
        fp += wn[lo:hi].double() @ pred
    tp32, fp32 = tp.float(), fp.float()
    fn = wy.double().sum().float() - tp32
    f1 = 2 * tp32 / torch.clamp(2 * tp32 + fp32 + fn, min=1e-9)
    return torch.argmax(f1)


def default_somatic_model(all_feature_names: list[str]) -> ThresholdModel:
    """TLOD/SOR thresholds per the somatic howto (TLOD high good, SOR low good)."""
    return ThresholdModel(
        feature_names=["tlod", "sor"],
        thresholds=np.asarray([6.3, 3.0], dtype=np.float32),
        signs=np.asarray([1.0, -1.0], dtype=np.float32),
        scales=np.asarray([2.0, 1.0], dtype=np.float32),
        pass_threshold=0.25,
        all_feature_names=list(all_feature_names),
    )
