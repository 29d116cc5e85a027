"""The port's threshold grid fit (``models/threshold.fit_threshold_model``)
against the JAX package's, at tolerance 0.

Same inputs, made with numpy from a seed, through both fits: the chosen
features, thresholds, signs and scales must be equal, on worlds with unit
weights and with exome weights of 2, on features whose grid cells tie on
F1, with the mutect candidates and with the |corr| fallback. The 500,000-row
subsample is held by the rows it chooses (the sweep itself is replaced by a
recorder), not by a sweep of that size.
"""

import numpy as np
import pytest
import torch

from variantcalling_tpu.models import threshold as jt
from variantcalling_tpu_torch.models import threshold as tt

NAMES = ["qual", "sor", "tlod", "exome.twist", "dp"]


def _world(seed: int, n: int, exome_weight: float | None):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(10, 90, n), np.round(rng.uniform(0, 3, n), 1), rng.uniform(0, 40, n),
                  (rng.random(n) < 0.3).astype(np.float64), rng.integers(10, 60, n)], axis=1).astype(np.float32)
    y = (0.05 * x[:, 0] - 0.8 * x[:, 1] + 0.05 * x[:, 2] + rng.normal(0, 1, n) > 1.5).astype(np.float32)
    w = None if exome_weight is None else np.where(x[:, 3] > 0, exome_weight, 1.0).astype(np.float32)
    return x, y, w


def _assert_same(got: tt.ThresholdModel, want: jt.ThresholdModel) -> None:
    assert got.feature_names == want.feature_names and got.all_feature_names == want.all_feature_names
    for field in ("thresholds", "signs", "scales"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype == np.float32, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.pass_threshold == want.pass_threshold


@pytest.mark.parametrize("exome_weight", [None, 2.0])
@pytest.mark.parametrize("cand", [["qual", "sor"], ["tlod", "sor"], ["absent"]])
@pytest.mark.parametrize("n", [40, 5000])
def test_fit_equals_the_reference(exome_weight, cand, n):
    x, y, w = _world(n, n, exome_weight)
    want = jt.fit_threshold_model(x, y, NAMES, candidate_features=cand, sample_weight=w)
    got = tt.fit_threshold_model(x, y, NAMES, candidate_features=cand, sample_weight=w, device="cpu")
    _assert_same(got, want)


@pytest.mark.parametrize("n_grid", [3, 24])
def test_f1_ties_take_the_reference_cell(n_grid):
    """A feature with few distinct values makes whole rows of the grid tie:
    argmax must pick the reference's (first) cell."""
    rng = np.random.default_rng(3)
    n = 3000
    x = np.stack([rng.integers(0, 3, n), rng.integers(0, 2, n)], axis=1).astype(np.float32)
    y = (x[:, 0] + rng.normal(0, 0.7, n) > 1).astype(np.float32)
    want = jt.fit_threshold_model(x, y, ["qual", "sor"], candidate_features=["qual", "sor"], n_grid=n_grid)
    got = tt.fit_threshold_model(x, y, ["qual", "sor"], candidate_features=["qual", "sor"], n_grid=n_grid,
                                 device="cpu")
    _assert_same(got, want)


def test_one_class_keeps_positive_signs():
    x, _, _ = _world(5, 200, None)
    y = np.ones(200, dtype=np.float32)
    want = jt.fit_threshold_model(x, y, NAMES, candidate_features=["qual", "sor"])
    got = tt.fit_threshold_model(x, y, NAMES, candidate_features=["qual", "sor"], device="cpu")
    _assert_same(got, want)
    assert (got.signs == 1).all()


def test_sweep_rows_are_summed_across_steps(monkeypatch):
    """The sweep in steps of a few rows gives the one-step sweep's cell."""
    x, y, w = _world(9, 3000, 2.0)
    whole = tt.fit_threshold_model(x, y, NAMES, candidate_features=["qual", "sor"], sample_weight=w, device="cpu")
    monkeypatch.setattr(tt, "_SWEEP_ROWS", 101)
    stepped = tt.fit_threshold_model(x, y, NAMES, candidate_features=["qual", "sor"], sample_weight=w, device="cpu")
    np.testing.assert_array_equal(stepped.thresholds, whole.thresholds)


def test_subsample_takes_the_reference_rows(monkeypatch):
    """Past 500,000 rows both fits sweep the rows ``default_rng(0).choice(n,
    500_000, replace=False)`` picks; the signs, grid and scales come from
    those rows."""
    n = 500_123
    x, y, w = _world(11, n, 2.0)
    seen = {}

    def record(xs, yv, wv, combos, signs, device):
        seen.update(xs=xs, y=yv, w=wv, combos=combos, signs=signs)
        return torch.tensor(5)

    monkeypatch.setattr(tt, "best_combo", record)
    model = tt.fit_threshold_model(x, y, NAMES, candidate_features=["qual", "sor"], sample_weight=w, device="cpu")
    sel = np.random.default_rng(0).choice(n, 500_000, replace=False)
    xs = np.asarray(x[:, [0, 1]], dtype=np.float32)[sel]  # as the reference lays it out (float32 sums follow it)
    np.testing.assert_array_equal(seen["xs"], xs)
    np.testing.assert_array_equal(seen["y"], y[sel])
    np.testing.assert_array_equal(seen["w"], w[sel])
    pos = y[sel] > 0.5
    signs = np.array([1.0 if xs[pos, j].mean() >= xs[~pos, j].mean() else -1.0 for j in range(2)], np.float32)
    np.testing.assert_array_equal(model.signs, signs)
    grid = np.quantile(xs, np.linspace(0.02, 0.98, 24), axis=0).astype(np.float32)
    np.testing.assert_array_equal(model.thresholds, [grid[0, 0], grid[5, 1]])
    np.testing.assert_array_equal(model.scales, np.maximum(np.std(xs, axis=0) * 0.05, 1e-3).astype(np.float32))
