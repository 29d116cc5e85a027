"""The port's DAN scorer against the JAX package's ``make_score_predictor``, to 1e-5.

The reference's DAN (its ``synthetic_dan``, weights from ``jax.random``) is
carried across by ``convert.dan_from_reference`` at hidden 16 and at the
width of ``train_dan``'s defaults (hidden 256, 2 layers, embed 16), and both
score the same numpy feature matrix:

- scores within 1e-5, f32, varying;
- columns chosen by name (a permuted layout scores the same rows equally);
- a missing feature raises ``EngineError``;
- an untrained head (``w_out`` = 0) scores exactly 0.5;
- scores equal (``torch.equal``) whatever the chunking of the rows;
- a ``DanModel`` pickled by the JAX package loads, with the same weights digest;
- TF32 or bfloat16 products requested globally change no score, and the
  request is left as it was.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from variantcalling_tpu.featurize import BASE_FEATURES
from variantcalling_tpu.models import dan as jdan
from variantcalling_tpu.models import registry as jregistry
from variantcalling_tpu.synthetic import synthetic_dan as jsynthetic_dan
from variantcalling_tpu_torch import synthetic
from variantcalling_tpu_torch.engine import EngineError
from variantcalling_tpu_torch.models import convert, dan, registry

TOL = 1e-5
WIDTHS = {"hidden16": dict(embed_dim=4, hidden=16, n_layers=2),
          "hidden256": dict(embed_dim=16, hidden=256, n_layers=2)}


def _carry(ref) -> dan.DanModel:
    return convert.dan_from_reference(ref.params_np, dataclasses.asdict(ref.cfg), ref.feature_names,
                                      ref.numeric_features, ref.pass_threshold, ref.norm_mu, ref.norm_sd)


def _reference(width: str, seed: int = 0):
    return jsynthetic_dan(np.random.default_rng(seed), list(BASE_FEATURES), **WIDTHS[width])


def _features(n: int, seed: int = 1, names=BASE_FEATURES) -> np.ndarray:
    """Each column uniform over its range in the port's synthetic callsets;
    motif codes as exact integers (some past the vocabulary, to be clipped)."""
    rng = np.random.default_rng(seed)
    cols = []
    for f in names:
        lo, hi = synthetic.FEATURE_RANGES[f]
        if f.endswith("_motif"):
            cols.append(rng.integers(-3, dan.MOTIF_VOCAB + 3, n).astype(np.float32))
        else:
            cols.append(rng.uniform(lo, hi, n).astype(np.float32))
    return np.stack(cols, axis=1)


def _port_scores(model, x: np.ndarray, names=BASE_FEATURES) -> np.ndarray:
    return dan.make_score_predictor(model, list(names), "cpu")(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("width", list(WIDTHS))
def test_scores_match_reference(width):
    ref = _reference(width)
    x = _features(3000)
    want = np.asarray(jdan.make_score_predictor(ref, list(BASE_FEATURES))(jnp.asarray(x)))
    got = _port_scores(_carry(ref), x)
    assert got.dtype == np.float32 and got.shape == (3000,)
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL, err
    assert len(np.unique(np.round(got, 4))) > 100


@pytest.mark.parametrize("width", list(WIDTHS))
def test_columns_chosen_by_name(width):
    model = _carry(_reference(width, seed=2))
    x = _features(1000, seed=3)
    perm = np.random.default_rng(4).permutation(len(BASE_FEATURES))
    names_p = [BASE_FEATURES[i] for i in perm]
    extra = np.random.default_rng(5).uniform(0, 9, (1000, 1)).astype(np.float32)  # a column the model ignores
    a = _port_scores(model, x)
    b = _port_scores(model, np.ascontiguousarray(np.concatenate([x[:, perm], extra], axis=1)), [*names_p, "tlod"])
    np.testing.assert_array_equal(a, b)


def test_missing_feature_raises():
    model = _carry(_reference("hidden16"))
    for absent in ("dp", "right_motif"):
        with pytest.raises(EngineError, match=absent):
            dan.make_score_predictor(model, [f for f in BASE_FEATURES if f != absent], "cpu")


@pytest.mark.parametrize("width", list(WIDTHS))
def test_untrained_head_scores_exactly_half(width):
    cfg = jdan.DanConfig(n_numeric=17, **WIDTHS[width])
    params = jdan.init_params(cfg, jax.random.PRNGKey(0))  # the output head is zero
    numeric = [f for f in BASE_FEATURES if not f.endswith("_motif")]
    ref = jdan.DanModel.from_params(cfg, params, BASE_FEATURES, numeric)
    got = _port_scores(_carry(ref), _features(333, seed=6))
    np.testing.assert_array_equal(got, np.full(333, 0.5, np.float32))


@pytest.mark.parametrize("width", list(WIDTHS))
def test_scores_do_not_depend_on_chunking(width):
    model = _carry(_reference(width, seed=7))
    x = torch.from_numpy(_features(dan.ROW_BLOCK + 1234, seed=8))
    scorer = dan.make_score_predictor(model, list(BASE_FEATURES), "cpu")
    whole = scorer(x)
    for rows, chunk in ((3000, 1000), (1000, 137), (x.shape[0], dan.ROW_BLOCK // 2 + 1)):
        parts = torch.cat([scorer(x[lo: min(lo + chunk, rows)]) for lo in range(0, rows, chunk)])
        assert torch.equal(parts, whole[:rows]), chunk


def test_reference_pickled_dan_loads(tmp_path):
    ref = _reference("hidden16", seed=9)
    ref.pass_threshold = 0.4
    path = str(tmp_path / "dan.pkl")
    jregistry.save_models(path, {"dan_model_ignore_gt_incl_hpol_runs": ref})
    model = registry.load_model(path, "dan_model_ignore_gt_incl_hpol_runs")
    assert isinstance(model, dan.DanModel) and isinstance(model.cfg, dan.DanConfig)
    assert registry.family_of(model) == "dan" and model.pass_threshold == 0.4
    assert dan.weights_digest(model) == jdan.weights_digest(ref)
    x = _features(500, seed=10)
    want = np.asarray(jdan.make_score_predictor(ref, list(BASE_FEATURES))(jnp.asarray(x)))
    assert float(np.max(np.abs(_port_scores(model, x) - want))) <= TOL
    with pytest.raises(dataclasses.FrozenInstanceError):
        model.cfg.hidden = 1


def _precision_state() -> tuple:
    m = torch.backends.cuda.matmul
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:  # backends set apart: the getter refuses
        legacy = None
    return legacy, m.fp32_precision, torch.backends.mkldnn.matmul.fp32_precision


@pytest.mark.parametrize("setting", ["allow_tf32", "high", "medium", "set_apart"])
def test_reduced_precision_request_changes_nothing_and_is_restored(setting):
    """TF32 (the card) or bfloat16 (oneDNN, on CPUs that have it) requested
    globally: the scores are the full-float32 ones, and the request is left
    exactly as it was."""
    model = _carry(_reference("hidden256", seed=11))
    x = torch.from_numpy(_features(700, seed=12))
    scorer = dan.make_score_predictor(model, list(BASE_FEATURES), "cpu")
    plain = scorer(x)
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    initial = [b.fp32_precision for b in backends]
    try:
        if setting == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        elif setting == "set_apart":
            torch.set_float32_matmul_precision("medium")
            torch.backends.cuda.matmul.allow_tf32 = False
        else:
            torch.set_float32_matmul_precision(setting)
        before = _precision_state()
        assert torch.equal(scorer(x), plain)
        assert _precision_state() == before
    finally:
        torch.set_float32_matmul_precision("highest")
        for b, precision in zip(backends, initial):
            b.fp32_precision = precision


def test_port_synthetic_dan_at_train_dan_width():
    model = synthetic.synthetic_dan(np.random.default_rng(13), list(BASE_FEATURES), 16, 256, 2)
    assert model.cfg.n_numeric == 17 and model.params_np["w_in"].shape == (49, 256)
    assert set(model.params_np) == {"motif_embed", "w_in", "b_in", "w_0", "b_0", "w_out", "b_out"}
    s = _port_scores(model, _features(2000, seed=14))
    assert 0.05 < float(np.mean(s > model.pass_threshold)) < 0.95
