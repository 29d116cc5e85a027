"""Threshold model for somatic callsets (TLOD/SOR), in torch.

Counterpart of ``variantcalling_tpu/models/threshold.py``: each of the
model's features contributes ``sigmoid((x - thr) * sign / scale)`` and
TREE_SCORE is the product, 0.5 at a feature's threshold, PASS at
``score >= pass_threshold``. The field names are the reference's, so its
pickles unpickle into :class:`ThresholdModel` (``models/registry.py``).
Fitting (``fit_threshold_model``) waits for the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

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
