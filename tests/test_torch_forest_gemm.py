"""The port's per-tree forest path against the JAX package's, bit for bit.

- the plain version of the per-tree CUDA kernel (``forest.predict_margin_gemm``)
  equals the reference's ``predict_margin_gemm`` and its Pallas
  ``_margin_pallas`` (interpret mode, as its own tests run it on the CPU),
  byte for byte, for sklearn, boosted and xgboost forests — the last with
  default_left routing and NaN inputs;
- the kernel's tables (``forest_cuda.tree_step_tables``): their bitmask leaf
  test equals the reference's ``d @ m2 + c == plen`` for every leaf, and a
  numpy replay of ``csrc/forest_tree_step.cu`` over them gives the same
  margins (the kernel itself needs the card);
- ``make_gemm_cuda_predictor`` against ``make_gemm_pallas_predictor``, with
  twins of ``tests/unit/test_forest_pallas.py``;
- the strategy rule and the ``VCTPU_FOREST_STRATEGY`` request;
- the wide kernel's plain version and a replay of its tables on default_left
  forests with NaN inputs, against the reference's ``predict_margin_wide``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_forest import _boosted_forest, _port, _sklearn_forests, _x
from tests.unit.test_xgb_ingest import _model_json, _probe_matrix, _two_tree_model, _xgb_tree
from variantcalling_tpu.models import forest as jforest
from variantcalling_tpu.models import xgb as jxgb
from variantcalling_tpu.models.forest_pallas import TILE_N, _margin_pallas, make_gemm_pallas_predictor
from variantcalling_tpu_torch import synthetic as tsynth
from variantcalling_tpu_torch.engine import EngineError
from variantcalling_tpu_torch.featurize import BASE_FEATURES
from variantcalling_tpu_torch.models import forest as tforest
from variantcalling_tpu_torch.models import forest_cuda
from variantcalling_tpu_torch.models import xgb as txgb

NAMES = ("sklearn_rf_ragged", "sklearn_gbt", "boosted_8x6", "stump_and_split", "xgb_two_tree",
         "xgb_synthetic_6x64", "sklearn_rf_ragged_dleft")


def _xgb_synthetic(seed: int, n_trees: int) -> dict:
    rng = np.random.default_rng(seed)
    forest = tsynth.filter_forest(rng, n_trees=n_trees, depth=7)
    return tsynth.xgboost_json(forest, rng.random(forest.feature.shape) < 0.5, 0.37)


def _range_features(n: int, seed: int, nan_share: float) -> np.ndarray:
    """(n, 19) features over BASE_FEATURES' value ranges, ``nan_share`` of the cells NaN."""
    rng = np.random.default_rng(seed)
    lo = np.asarray([tsynth.FEATURE_RANGES[f][0] for f in BASE_FEATURES], dtype=np.float32)
    hi = np.asarray([tsynth.FEATURE_RANGES[f][1] for f in BASE_FEATURES], dtype=np.float32)
    x = (lo + rng.random((n, len(BASE_FEATURES)), dtype=np.float32) * (hi - lo)).astype(np.float32)
    x[rng.random(x.shape) < nan_share] = np.nan
    return x


@pytest.fixture(scope="module")
def forests():
    """name -> (reference FlatForest, n_features, x (1000, F) float32: NaN only with default_left)."""
    rf, gbt = _sklearn_forests()
    stump = jforest.FlatForest(
        feature=np.asarray([[-1, -1, -1], [1, -1, -1]], np.int32),
        threshold=np.asarray([[0, 0, 0], [0.5, 0, 0]], np.float32),
        left=np.asarray([[0, 1, 2], [1, 1, 2]], np.int32), right=np.asarray([[0, 1, 2], [2, 1, 2]], np.int32),
        value=np.asarray([[0.25, 0, 0], [0, -1.5, 2.0]], np.float32), max_depth=2, aggregation="logit_sum")
    rf_dleft = jforest.FlatForest(**{k: np.asarray(getattr(rf, k)) for k in
                                     ("feature", "threshold", "left", "right", "value")},
                                  max_depth=rf.max_depth, aggregation=rf.aggregation,
                                  default_left=np.random.default_rng(6).random(rf.feature.shape) < 0.5)
    gbt_dleft = jforest.FlatForest(**{k: np.asarray(getattr(gbt, k)) for k in
                                      ("feature", "threshold", "left", "right", "value")},
                                   max_depth=gbt.max_depth, aggregation=gbt.aggregation, base_score=gbt.base_score,
                                   default_left=np.random.default_rng(15).random(gbt.feature.shape) < 0.5)
    nan_x = _x(1000, 8, 1.0, seed=11)
    nan_x[np.random.default_rng(12).random(nan_x.shape) < 0.1] = np.nan
    return {
        "sklearn_rf_ragged": (rf, 8, _x(1000, 8, 1.0)),
        "sklearn_gbt": (gbt, 8, _x(1000, 8, 1.0)),
        "boosted_8x6": (_boosted_forest(), 10, _x(1000, 10, 1.0)),
        "stump_and_split": (stump, 2, _x(1000, 2, 1.0)),
        "xgb_two_tree": (jxgb.from_xgboost_json(_two_tree_model()), 3,
                         np.concatenate([_probe_matrix(np.random.default_rng(0))] * 2)),
        "xgb_synthetic_6x64": (jxgb.from_xgboost_json(_xgb_synthetic(13, 6)), 19, _range_features(1000, 14, 0.1)),
        "sklearn_rf_ragged_dleft": (rf_dleft, 8, nan_x),
        "sklearn_gbt_dleft": (gbt_dleft, 8, nan_x),
    }


def _pack(bits: np.ndarray, w: int) -> np.ndarray:
    """(..., I) bool -> (..., W) uint32 with bit b of word j = bits[..., 32 j + b]."""
    out = np.zeros(bits.shape[:-1] + (w,), dtype=np.uint32)
    for k in range(bits.shape[-1]):
        out[..., k // 32] |= bits[..., k].astype(np.uint32) << np.uint32(k % 32)
    return out


def _leaf_hits(masks: np.ndarray, d: np.ndarray) -> np.ndarray:
    """The kernel's leaf test: (N, W) words of d against (L, 2, W) masks -> (N, L) bool."""
    lm, rm = masks[None, :, 0, :], masks[None, :, 1, :]
    dw = d[:, None, :]
    return np.all((dw & lm) == lm, axis=-1) & np.all((dw & rm) == 0, axis=-1)


def _replay_tree_step(kernel: forest_cuda.TreeStepKernel, x: np.ndarray) -> np.ndarray:
    """numpy replay of ``csrc/forest_tree_step.cu`` over the wrapper's tables."""
    nodes = kernel.nodes.numpy()
    masks = kernel.masks.numpy().view(np.uint32)
    values = kernel.values.numpy()
    dleft = None if kernel.dleft is None else kernel.dleft.numpy().view(np.uint32)
    k = np.arange(kernel.n_int)
    acc = np.zeros(len(x), dtype=np.float32)
    for t in range(kernel.n_trees):
        v = x[:, nodes[t, :, 0]]
        go_left = v <= nodes[t, :, 1].view(np.float32)
        if dleft is not None:
            go_left = np.where(np.isnan(v), ((dleft[t][k // 32] >> (k % 32)) & 1).astype(bool), go_left)
        hit = _leaf_hits(masks[t], _pack(go_left, kernel.n_words))
        assert (hit.sum(axis=1) == 1).all()
        acc = (acc + values[t][hit.argmax(axis=1)]).astype(np.float32)
    return acc


@pytest.mark.parametrize("name", NAMES)
def test_gemm_encoding_equals_reference(forests, name):
    """Weights across: the port's to_gemm of the carried-over forest equals the
    reference's array for array, default_left forests included."""
    ref, f, _ = forests[name]
    jg, tg = jforest.to_gemm(ref, f), tforest.to_gemm(_port(ref), f)
    for k in ("a", "thr", "m2", "c", "plen", "value", "dleft"):
        want, got = getattr(jg, k), getattr(tg, k)
        assert (want is None) == (got is None), k
        if want is not None:
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=k)
    assert (tg.aggregation, tg.base_score) == (jg.aggregation, jg.base_score)


@pytest.mark.parametrize("name", NAMES)
def test_gemm_margins_bit_identical_to_reference_and_pallas(forests, name):
    ref, f, x = forests[name]
    jg = jforest.to_gemm(ref, f)
    want = np.asarray(jax.jit(lambda v: jforest.predict_margin_gemm(jg, v))(jnp.asarray(x)))
    np.testing.assert_array_equal(np.asarray(jax.jit(lambda v: jforest.predict_margin(ref, v))(x)), want)
    kernel = forest_cuda.TreeStepKernel(tforest.to_gemm(_port(ref), f), "cpu")
    xt = torch.from_numpy(x)
    before = forest_cuda.TREE_STEP_LAUNCHES
    got = kernel(xt).numpy()
    assert forest_cuda.TREE_STEP_LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.tobytes() == want.tobytes()
    assert tforest.predict_margin(_port(ref), xt).numpy().tobytes() == want.tobytes()
    assert _replay_tree_step(kernel, x).tobytes() == want.tobytes()
    # the Pallas kernel has no default-left table: hold it to finite inputs, where
    # the default never applies
    xf = np.nan_to_num(x, nan=0.25)
    pad = (-len(xf)) % TILE_N
    tables = tuple(jnp.asarray(getattr(jg, k)) for k in ("a", "thr", "m2", "c", "plen", "value"))
    pallas = np.asarray(_margin_pallas(tables, jnp.pad(jnp.asarray(xf), ((0, pad), (0, 0))), True))[:len(xf)]
    assert kernel(torch.from_numpy(xf)).numpy().tobytes() == pallas.tobytes()


@pytest.mark.parametrize("name", NAMES)
def test_bitmask_leaf_test_equals_reference_routing(forests, name):
    """For random decisions d, the tables' bitmask test picks exactly the leaves
    ``d @ m2 + c == plen`` picks — complete and ragged trees, padded leaves,
    a stump — and the masks agree with to_gemm's c and plen."""
    ref, f, _ = forests[name]
    jg = jforest.to_gemm(ref, f)
    m2, c, plen = (np.asarray(getattr(jg, k)) for k in ("m2", "c", "plen"))
    nodes, dleft, masks, values = forest_cuda.tree_step_tables(tforest.to_gemm(_port(ref), f))
    t, i, l = m2.shape
    w = -(-i // 32)
    assert nodes.shape == (t, i, 2) and masks.shape == (t, l, 2, w) and masks.dtype == np.uint32
    np.testing.assert_array_equal(values, np.asarray(jg.value))
    assert (dleft is None) == (jg.dleft is None)
    if dleft is not None:
        np.testing.assert_array_equal(dleft, _pack(np.asarray(jg.dleft) > 0.5, w))
    popcount = np.vectorize(lambda v: bin(int(v)).count("1"))
    real = plen >= 0
    np.testing.assert_array_equal(popcount(masks[:, :, 1]).sum(-1)[real], c[real])
    np.testing.assert_array_equal(popcount(masks[:, :, 0]).sum(-1)[real] + c[real], plen[real])
    rng = np.random.default_rng(i * 100 + l)
    for ti in range(t):
        d = rng.random((256, i)) < 0.5
        want = (d.astype(np.float32) @ m2[ti] + c[ti]) == plen[ti]
        got = _leaf_hits(masks[ti], _pack(d, w))
        np.testing.assert_array_equal(got, want)
        if not real[ti].all():
            assert not got[:, ~real[ti]].any()


@pytest.mark.parametrize("n", (0, 1, 511, 513))
@pytest.mark.parametrize("name", ["sklearn_rf_ragged", "xgb_synthetic_6x64"])
def test_gemm_margins_at_edge_batch_sizes(forests, name, n):
    ref, f, x = forests[name]
    x = np.ascontiguousarray(np.resize(x, (n, f)))
    jg = jforest.to_gemm(ref, f)
    want = np.asarray(jforest.predict_margin_gemm(jg, jnp.asarray(x)))
    got = forest_cuda.TreeStepKernel(tforest.to_gemm(_port(ref), f), "cpu")(torch.from_numpy(x))
    assert got.shape == (n,) and got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("name", ["sklearn_rf_ragged", "sklearn_gbt", "boosted_8x6", "stump_and_split"])
def test_cuda_predictor_matches_pallas_predictor(forests, name):
    """Device-finalized scores: equal bytes for mean; 1e-6 for logit_sum, whose
    sigmoid runs in each library's own implementation."""
    ref, f, x = forests[name]
    want = np.asarray(make_gemm_pallas_predictor(jforest.to_gemm(ref, f), interpret=True)(jnp.asarray(x)))
    got = forest_cuda.make_gemm_cuda_predictor(tforest.to_gemm(_port(ref), f), "cpu")(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if ref.aggregation == "mean":
        assert got.numpy().tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tforest.predict_score_gemm(tforest.to_gemm(_port(ref), f), torch.from_numpy(x)).numpy(),
                               np.asarray(jforest.predict_score_gemm(jforest.to_gemm(ref, f), x)), rtol=0, atol=1e-6)


def test_cuda_predictor_matches_gemm_on_boosted_forest(rng):
    """Twin of test_forest_pallas.test_pallas_matches_gemm_on_boosted_forest."""
    from variantcalling_tpu.models import boosting

    x = rng.random((1000, 8)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0.8).astype(np.float32)
    forest = boosting.fit(x, y, cfg=boosting.BoostConfig(n_trees=12, depth=4, n_bins=32))
    ref = np.asarray(jforest.predict_score_gemm(jforest.to_gemm(forest, 8), jnp.asarray(x)))
    got = forest_cuda.make_gemm_cuda_predictor(tforest.to_gemm(_port(forest), 8), "cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    walk = np.asarray(jforest.predict_score(forest, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), walk, atol=1e-6)


def test_cuda_predictor_matches_sklearn_rf(rng):
    """Twin of test_forest_pallas.test_pallas_matches_sklearn_rf."""
    from sklearn.ensemble import RandomForestClassifier

    x = rng.random((TILE_N, 6)).astype(np.float32)
    y = (x[:, 0] > 0.5).astype(int)
    clf = RandomForestClassifier(n_estimators=7, max_depth=5, random_state=0).fit(x, y)
    gf = tforest.to_gemm(tforest.from_sklearn(clf), 6)
    got = forest_cuda.make_gemm_cuda_predictor(gf, "cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), clf.predict_proba(x)[:, 1], atol=2e-6)


def test_cuda_predictor_rejects_missing_value_forests():
    """Twin of test_forest_pallas.test_pallas_rejects_missing_value_forests."""
    t0 = _xgb_tree(left=[1, -1, -1], right=[2, -1, -1],
                   cond=[0.5, -0.3, 0.4], sidx=[0, 0, 0], default_left=[1, 0, 0])
    gf = tforest.to_gemm(txgb.from_xgboost_json(_model_json([t0])), 3)
    with pytest.raises(ValueError, match="default_left"):
        forest_cuda.make_gemm_cuda_predictor(gf, "cpu")
    # the kernel itself serves it: the pipeline's cuda-gemm path
    x = torch.tensor([[np.nan, 0.0, 0.0], [0.7, 0.0, 0.0], [0.1, 0.0, 0.0]])
    assert forest_cuda.TreeStepKernel(gf, "cpu")(x).tolist() == pytest.approx([-0.3, 0.4, -0.3])


def test_tree_step_wrapper_checks_inputs(forests):
    ref, f, _ = forests["boosted_8x6"]
    kernel = forest_cuda.TreeStepKernel(tforest.to_gemm(_port(ref), f), "cpu")
    before = forest_cuda.TREE_STEP_LAUNCHES
    for bad in (torch.zeros((4, f + 1)), torch.zeros((4, f), dtype=torch.float64), torch.zeros((f, 4)).t()):
        with pytest.raises(ValueError):
            kernel.launch(bad)
    assert forest_cuda.TREE_STEP_LAUNCHES == before


def _with_leaves(forest: tforest.FlatForest, n_internal: int) -> tforest.FlatForest:
    """``forest`` with more internal nodes per tree than GEMM_MAX_LEAVES allows (a strategy probe)."""
    reps = (1, -(-(n_internal + 1) // forest.feature.shape[1]))
    big = tforest.FlatForest(**{k: np.tile(getattr(forest, k), reps) for k in
                                ("feature", "threshold", "left", "right", "value")},
                             max_depth=forest.max_depth, default_left=None if forest.default_left is None
                             else np.tile(forest.default_left, reps))
    big.feature[:, :n_internal] = 0
    return big


@pytest.mark.parametrize("request_,dleft,leaves,device,want", [
    ("auto", True, "small", "cuda", "cuda-wide"),
    ("auto", False, "small", "cuda", "cuda-wide"),
    ("auto", True, "huge", "cuda", "gather"),
    ("auto", True, "small", "cpu", "gather"),
    ("gemm", True, "huge", "cuda", "cuda-gemm"),
    ("gemm", False, "small", "cpu", "gemm"),
    ("wide", False, "small", "cuda", "cuda-wide"),
    ("wide", True, "small", "cpu", "wide"),
    ("pallas", False, "small", "cpu", "wide"),
    ("gather", True, "small", "cuda", "gather"),
    (" GEMM ", False, "small", "cuda", "cuda-gemm"),
    ("", True, "small", "cuda", "cuda-wide"),
])
def test_strategy_request_resolution(forests, monkeypatch, request_, dleft, leaves, device, want):
    forest = _port(forests["xgb_synthetic_6x64"][0])
    if not dleft:
        forest.default_left = None
    if leaves == "huge":
        forest = _with_leaves(forest, 2 * tforest.GEMM_MAX_LEAVES)
        assert tforest.max_tree_leaves(forest) > tforest.GEMM_MAX_LEAVES
    monkeypatch.setenv(tforest.FOREST_STRATEGY_ENV, request_)
    assert tforest.resolve_strategy(forest, torch.device(device)) == want
    assert want in tforest.STRATEGIES


@pytest.mark.parametrize("request_", ["pallas"])
def test_explicit_wide_refuses_default_left(forests, monkeypatch, request_):
    """``pallas`` names the reference's Pallas wide-block kernel, which refuses
    default_left forests (``forest_pallas.py:147``): so does the port."""
    monkeypatch.setenv(tforest.FOREST_STRATEGY_ENV, request_)
    for device in ("cuda", "cpu"):
        with pytest.raises(EngineError, match="gemm"):
            tforest.resolve_strategy(_port(forests["xgb_synthetic_6x64"][0]), torch.device(device))


@pytest.mark.parametrize("device,want", [("cuda", "cuda-wide"), ("cpu", "wide")])
def test_explicit_wide_serves_default_left(forests, monkeypatch, device, want):
    """An explicit ``wide`` serves a default_left forest, as the reference's
    ``wide`` does; on the CPU its margins are the reference's bytes."""
    monkeypatch.setenv(tforest.FOREST_STRATEGY_ENV, "wide")
    ref, f, x = forests["xgb_synthetic_6x64"]
    forest = _port(ref)
    assert tforest.resolve_strategy(forest, torch.device(device)) == want
    fn = tforest.make_margin_predictor(forest, f, "wide", torch.device("cpu"))
    want_bytes = np.asarray(jforest.predict_margin_wide(jforest.to_wide(jforest.to_gemm(ref, f)), jnp.asarray(x)))
    assert fn(torch.from_numpy(x)).numpy().tobytes() == want_bytes.tobytes()


@pytest.mark.parametrize("tree_block", [None, 1, 3])
@pytest.mark.parametrize("name", ["xgb_two_tree", "xgb_synthetic_6x64", "sklearn_rf_ragged_dleft",
                                  "sklearn_gbt_dleft"])
def test_wide_plain_equals_reference_on_default_left(forests, name, tree_block):
    """The wide kernel's plain version on default_left forests with NaN cells
    equals the reference's ``predict_margin_wide`` byte for byte (its NaN-mask
    branch), and so does a numpy replay of the kernel over its tables."""
    from tests.test_torch_forest import _walk_compact_tables

    ref, f, x = forests[name]
    assert ref.default_left is not None and np.isnan(x).any()
    jw = jforest.to_wide(jforest.to_gemm(ref, f), tree_block)
    want = np.asarray(jax.jit(lambda v: jforest.predict_margin_wide(jw, v))(jnp.asarray(x)))
    np.testing.assert_array_equal(np.asarray(jax.jit(lambda v: jforest.predict_margin(ref, v))(x)), want)
    kernel = forest_cuda.WideForestKernel(_port(ref), f, "cpu")
    before = forest_cuda.LAUNCHES
    got = kernel(torch.from_numpy(x)).numpy()
    assert forest_cuda.LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.tobytes() == want.tobytes()
    wf = tforest.to_wide(tforest.to_gemm(_port(ref), f), tree_block)
    assert forest_cuda.wide_margin_plain(wf, torch.from_numpy(x)).numpy().tobytes() == want.tobytes()
    assert _walk_compact_tables(forest_cuda.compact_tables(_port(ref), f), x)[0].tobytes() == want.tobytes()


def test_malformed_strategy_request_raises(monkeypatch):
    monkeypatch.setenv(tforest.FOREST_STRATEGY_ENV, "fastest")
    with pytest.raises(EngineError, match="VCTPU_FOREST_STRATEGY"):
        tforest.validate_strategy_env()
    monkeypatch.delenv(tforest.FOREST_STRATEGY_ENV)
    tforest.validate_strategy_env()
    assert tforest.requested_strategy() == "auto"


@pytest.mark.parametrize("strategy", ["gemm", "wide", "gather"])
def test_margin_predictor_by_strategy_on_cpu(forests, strategy):
    ref, f, x = forests["boosted_8x6"]
    want = np.asarray(jforest.predict_margin(ref, jnp.asarray(x)))
    fn = tforest.make_margin_predictor(_port(ref), f, strategy, torch.device("cpu"))
    assert fn(torch.from_numpy(x)).numpy().tobytes() == want.tobytes()
