"""The port's forest layer against the JAX package's, bit for bit.

- ``to_gemm``/``to_wide`` arrays equal the reference's element by element;
- the plain wide margins (the CUDA kernel's plain version) and the plain
  gather walk equal the reference's Pallas wide-block kernel (interpret
  mode, as its own tests run it on the CPU) and its ``wide``/``gather``
  strategies, bit for bit;
- the kernel's compact tables, built from the forest's node arrays and
  walked in numpy exactly as the CUDA source walks them, give the same
  bits (the kernel itself needs the card);
- ``finalize_margin`` bytes, the forest conversion, default_left forests
  on the wide kernel's path, and the strategy rule.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from variantcalling_tpu.models import forest as jforest
from variantcalling_tpu.models.forest_pallas import make_wide_pallas_margin_predictor
from variantcalling_tpu.synthetic import synthetic_forest as j_synthetic_forest
from variantcalling_tpu_torch import synthetic as tsynth
from variantcalling_tpu_torch.models import forest as tforest
from variantcalling_tpu_torch.models import forest_cuda
from variantcalling_tpu_torch.models.convert import REFERENCE_ARRAYS, forest_from_reference

N_VALUES = (0, 1, 511, 513, 2048)
META = ("max_depth", "aggregation", "base_score", "feature_names", "pass_threshold")


def _port(ref) -> tforest.FlatForest:
    arrays = {k: np.asarray(getattr(ref, k)) for k in REFERENCE_ARRAYS if getattr(ref, k) is not None}
    return forest_from_reference(arrays, **{k: getattr(ref, k) for k in META})


def _sklearn_forests():
    from sklearn.ensemble import GradientBoostingClassifier, RandomForestClassifier

    rng = np.random.default_rng(3)
    x = rng.random((1500, 8)).astype(np.float32)
    y = (x[:, 0] + 0.3 * x[:, 1] + rng.normal(0, 0.2, 1500) > 0.6).astype(int)
    return [
        jforest.from_sklearn(RandomForestClassifier(n_estimators=9, max_depth=7, random_state=0).fit(x, y)),
        jforest.from_sklearn(GradientBoostingClassifier(n_estimators=5, max_depth=4, random_state=0).fit(x, y)),
    ]


def _boosted_forest():
    """The train_models default shape (depth 6, logit_sum), cut to 8 trees."""
    from variantcalling_tpu.models import boosting

    rng = np.random.default_rng(4)
    x = rng.random((3000, 10)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 3] - x[:, 7] * x[:, 2] + rng.normal(0, 0.1, 3000) > 0.5).astype(np.float32)
    ref = boosting.fit(x, y, cfg=boosting.BoostConfig(n_trees=8, depth=6))
    for k in ("feature", "threshold", "left", "right", "value"):
        setattr(ref, k, np.asarray(getattr(ref, k)))
    return ref


@pytest.fixture(scope="module")
def forests():
    """name -> (reference FlatForest, n_features, feature scale)."""
    rf, gbt = _sklearn_forests()
    rng = np.random.default_rng(5)
    return {
        "sklearn_rf_ragged": (rf, 8, 1.0),
        "sklearn_gbt": (gbt, 8, 1.0),
        "synthetic_deep": (j_synthetic_forest(rng, n_trees=5, depth=9, n_features=12), 12, 50.0),
        "synthetic_depth7": (j_synthetic_forest(rng, n_trees=6, depth=7, n_features=19), 19, 50.0),
        "boosted_8x6": (_boosted_forest(), 10, 1.0),
    }


def _x(n: int, f: int, scale: float, seed: int = 9) -> np.ndarray:
    return (np.random.default_rng(seed).random((n, f)) * scale).astype(np.float32)


def _walk_compact_tables(tables: forest_cuda.WideTables, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """numpy replay of ``csrc/forest_wide.cu``'s per-row walk over the compact
    tables, ``depth`` steps a tree with the leaves' extra feature of -inf, over
    8-byte records in a chunk held in shared memory and 16-byte ones in a
    global chunk: (margins (N,), the record each row ends on per tree (N, T))."""
    rec = tables.records
    n, t = len(x), len(tables.tree_off)
    xe = np.concatenate([x, np.full((n, 1), -np.inf, dtype=np.float32)], axis=1)
    acc = np.zeros(n, dtype=np.float32)
    ends = np.zeros((n, t), dtype=np.int64)
    rows = np.arange(n)
    for c in range(tables.n_chunks):
        wide = 2 if tables.chunk_global[c] else 1  # records a slot takes
        for ti in range(tables.chunk_tree[c], tables.chunk_tree[c + 1]):
            base = int(tables.chunk_rec[c]) + wide * int(tables.tree_off[ti])
            s = np.full(n, base, dtype=np.int64)
            for _ in range(tables.depth[ti]):
                y = rec[s, 1].astype(np.int64)
                v = xe[rows, y & 0x7FFF]
                thr = rec[s, 0].view(np.float32)
                right = np.where((y & 0x8000) != 0, v > thr, ~(v <= thr))
                first = rec[s + 1, 0].astype(np.int64) if wide == 2 else y >> 16
                s = base + wide * (first + right)
            ends[:, ti] = s
            acc = (acc + rec[s, 0].view(np.float32)).astype(np.float32)
    return acc, ends


@pytest.mark.parametrize("name", ["sklearn_rf_ragged", "sklearn_gbt", "synthetic_deep",
                                  "synthetic_depth7", "boosted_8x6"])
@pytest.mark.parametrize("tree_block", [1, 2, 4])
def test_gemm_and_wide_encodings_equal_reference(forests, name, tree_block):
    ref, f, _ = forests[name]
    jg, tg = jforest.to_gemm(ref, f), tforest.to_gemm(_port(ref), f)
    for k in ("a", "thr", "m2", "c", "plen", "value"):
        np.testing.assert_array_equal(getattr(tg, k), getattr(jg, k), err_msg=k)
    jw, tw = jforest.to_wide(jg, tree_block), tforest.to_wide(tg, tree_block)
    for k in ("a", "thr", "m2", "c", "plen", "value"):
        np.testing.assert_array_equal(getattr(tw, k), getattr(jw, k), err_msg=k)
    assert (tw.n_trees, tw.tree_block) == (jw.n_trees, jw.tree_block)
    assert tforest.max_tree_leaves(_port(ref)) == jg.n_leaves


@pytest.mark.parametrize("name,tree_block", [
    ("sklearn_rf_ragged", None), ("sklearn_gbt", None), ("synthetic_deep", None),
    ("synthetic_depth7", 1), ("synthetic_depth7", 2), ("synthetic_depth7", 4),
    ("boosted_8x6", 1), ("boosted_8x6", 2), ("boosted_8x6", 4)])
def test_wide_margins_bit_identical_to_pallas_and_strategies(forests, name, tree_block):
    ref, f, scale = forests[name]
    forest = _port(ref)
    jw = jforest.to_wide(jforest.to_gemm(ref, f), tree_block)
    pallas = make_wide_pallas_margin_predictor(jforest.to_gemm(ref, f), tree_block=tree_block,
                                               interpret=True)
    kernel = forest_cuda.WideForestKernel(forest, f, "cpu")
    tw = tforest.to_wide(tforest.to_gemm(forest, f), tree_block)
    tables = forest_cuda.compact_tables(forest, f)
    # the plain version packs the trees as the reference's wide encoding does; the
    # kernel's tables hold every tree, one record per reachable node
    assert (tw.n_blocks, tw.tree_block) == (jw.n_blocks, jw.tree_block)
    assert len(tables.tree_off) == jw.n_trees
    assert (tables.node >= 0).sum() == 2 * (np.asarray(jw.plen) >= 0).sum() - jw.n_trees
    x = _x(1100, f, scale)
    want = np.asarray(pallas(jnp.asarray(x)))
    np.testing.assert_array_equal(np.asarray(jax.jit(lambda v: jforest.predict_margin_wide(jw, v))(x)), want)
    np.testing.assert_array_equal(np.asarray(jax.jit(lambda v: jforest.predict_margin(ref, v))(x)), want)
    xt = torch.from_numpy(x)
    got_wide = kernel(xt).numpy()
    assert got_wide.tobytes() == want.tobytes()
    assert forest_cuda.wide_margin_plain(tw, xt).numpy().tobytes() == want.tobytes()
    assert tforest.predict_margin(forest, xt).numpy().tobytes() == want.tobytes()
    assert _walk_compact_tables(tables, x)[0].tobytes() == want.tobytes()


@pytest.mark.parametrize("n", N_VALUES)
@pytest.mark.parametrize("name", ["sklearn_rf_ragged", "boosted_8x6"])
def test_margins_at_edge_batch_sizes(forests, name, n):
    ref, f, scale = forests[name]
    forest = _port(ref)
    x = _x(n, f, scale, seed=n)
    want = np.asarray(jax.jit(lambda v: jforest.predict_margin(ref, v))(jnp.asarray(x)))
    if n:
        pallas = make_wide_pallas_margin_predictor(jforest.to_gemm(ref, f), interpret=True)
        np.testing.assert_array_equal(np.asarray(pallas(jnp.asarray(x))), want)
    xt = torch.from_numpy(x)
    kernel = tforest.make_margin_predictor(forest, f, "cuda-wide", torch.device("cpu"))
    for got in (kernel(xt), tforest.predict_margin(forest, xt)):
        assert got.shape == (n,) and got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes()


def test_sequential_tree_sum_is_ascending_order():
    """The reduction adds trees one by one in ascending order, like the
    reference's loop-carried sum; values where reassociation changes the bits."""
    per_tree = np.asarray([[1e8, 1.0, -1e8, 1.0] * 8], dtype=np.float32).repeat(3, axis=0)
    want = np.asarray(jforest.sequential_tree_sum(jnp.asarray(per_tree)))
    got = tforest.sequential_tree_sum(torch.from_numpy(per_tree)).numpy()
    assert got.tobytes() == want.tobytes()
    acc = np.zeros(3, np.float32)
    for t in range(per_tree.shape[1]):
        acc = acc + per_tree[:, t]
    assert got.tobytes() == acc.tobytes()


@pytest.mark.parametrize("name", ["sklearn_rf_ragged", "sklearn_gbt", "boosted_8x6"])
def test_finalize_margin_bytes_equal(forests, name):
    ref, f, scale = forests[name]
    margin = np.random.default_rng(2).normal(0, 3, 4096).astype(np.float32)
    assert tforest.finalize_margin(margin, _port(ref)).tobytes() == \
        jforest.finalize_margin(margin, ref).tobytes()


def test_forest_from_reference_round_trips(forests):
    for ref, _, _ in forests.values():
        port = _port(ref)
        for k in ("feature", "threshold", "left", "right", "value"):
            got, want = getattr(port, k), np.asarray(getattr(ref, k))
            assert got.dtype == want.dtype and np.array_equal(got, want), k
        for k in META:
            assert getattr(port, k) == getattr(ref, k), k
    dl = forest_from_reference({k: np.asarray(getattr(ref, k)) for k in REFERENCE_ARRAYS[:5]}
                               | {"default_left": np.ones(ref.feature.shape, bool)}, max_depth=ref.max_depth)
    assert dl.default_left.dtype == bool and dl.default_left.all()
    with pytest.raises(KeyError):
        forest_from_reference({"feature": ref.feature}, max_depth=1)


def test_from_sklearn_matches_reference():
    from sklearn.ensemble import GradientBoostingClassifier, RandomForestClassifier

    rng = np.random.default_rng(8)
    x = rng.random((800, 6)).astype(np.float32)
    y = (x[:, 1] > 0.4).astype(int)
    for clf in (RandomForestClassifier(n_estimators=4, max_depth=5, random_state=1).fit(x, y),
                GradientBoostingClassifier(n_estimators=3, max_depth=3, random_state=1).fit(x, y)):
        got, want = tforest.from_sklearn(clf), jforest.from_sklearn(clf)
        for k in ("feature", "threshold", "left", "right", "value"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        for k in META:
            assert getattr(got, k) == getattr(want, k), k


def test_synthetic_forest_matches_reference():
    got = tsynth.synthetic_forest(np.random.default_rng(1), n_trees=3, depth=7, n_features=19)
    want = j_synthetic_forest(np.random.default_rng(1), n_trees=3, depth=7, n_features=19)
    for k in ("feature", "threshold", "left", "right", "value"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    gf = tforest.to_gemm(got, 19)  # depth=d: 2^(d-1) leaves, here the 63/64 of boosting's depth 6
    assert gf.a.shape[2] == 63 and gf.n_leaves == 64
    assert tforest.to_wide(gf).tree_block == jforest.default_tree_block(63) == 2


def test_default_left_refused_on_kernel_path(forests, monkeypatch):
    """default_left forests: the card resolves them to the wide kernel
    (``cuda-wide``), as the reference's ``auto`` resolves them to ``wide``;
    its wrapper takes them and its plain version takes the node's default on
    NaN, as the reference's ``predict_margin_wide`` does; the CPU walks them."""
    monkeypatch.delenv(tforest.FOREST_STRATEGY_ENV, raising=False)
    ref, f, _ = forests["boosted_8x6"]
    forest = _port(ref)
    forest.default_left = np.random.default_rng(10).random(forest.feature.shape) < 0.5
    assert tforest.resolve_strategy(forest, torch.device("cuda")) == "cuda-wide"
    kernel = forest_cuda.WideForestKernel(forest, f, "cpu")
    assert tforest.resolve_strategy(forest, torch.device("cpu")) == "gather"
    x = _x(300, f, 1.0)
    x[::3, :] = np.nan
    x[1::3, 2] = np.nan
    jref = jforest.FlatForest(**{k: getattr(ref, k) for k in REFERENCE_ARRAYS[:5]}, max_depth=ref.max_depth,
                              default_left=forest.default_left)
    want = np.asarray(jax.jit(lambda v: jforest.predict_margin(jref, v))(jnp.asarray(x)))
    jw = jforest.to_wide(jforest.to_gemm(jref, f))
    np.testing.assert_array_equal(np.asarray(jax.jit(lambda v: jforest.predict_margin_wide(jw, v))(x)), want)
    xt = torch.from_numpy(x)
    assert tforest.predict_margin(forest, xt).numpy().tobytes() == want.tobytes()
    assert kernel(xt).numpy().tobytes() == want.tobytes()
    assert _walk_compact_tables(forest_cuda.compact_tables(forest, f), x)[0].tobytes() == want.tobytes()


def test_strategy_rule(forests, monkeypatch):
    monkeypatch.delenv(tforest.FOREST_STRATEGY_ENV, raising=False)
    ref, f, _ = forests["synthetic_depth7"]
    cuda = torch.device("cuda")
    assert tforest.resolve_strategy(_port(ref), cuda) == "cuda-wide"
    assert tforest.resolve_strategy(_port(ref), torch.device("cpu")) == "gather"
    dleft = _port(ref)
    dleft.default_left = np.ones(dleft.feature.shape, dtype=bool)
    assert tforest.resolve_strategy(dleft, cuda) == "cuda-wide"
    big = _port(forests["synthetic_deep"][0])  # depth 9: 256 leaves, still under the limit
    assert tforest.resolve_strategy(big, cuda) == "cuda-wide"
    huge = tforest.FlatForest(**{k: np.tile(getattr(big, k), (1, 4)) for k in REFERENCE_ARRAYS[:5]},
                              max_depth=big.max_depth)
    huge.feature[:, : 2 * tforest.GEMM_MAX_LEAVES] = 0  # more internal nodes than the limit allows
    assert tforest.max_tree_leaves(huge) > tforest.GEMM_MAX_LEAVES
    assert tforest.resolve_strategy(huge, cuda) == "gather"
    huge.default_left = np.ones(huge.feature.shape, dtype=bool)
    assert tforest.resolve_strategy(huge, cuda) == "gather"


def test_kernel_wrapper_checks_inputs(forests):
    ref, f, _ = forests["synthetic_depth7"]
    kernel = forest_cuda.WideForestKernel(_port(ref), f, "cpu")
    before = forest_cuda.LAUNCHES
    with pytest.raises(ValueError):
        kernel.launch(torch.zeros((4, f + 1)))
    with pytest.raises(ValueError):
        kernel.launch(torch.zeros((4, f), dtype=torch.float64))
    with pytest.raises(ValueError):
        kernel.launch(torch.zeros((f, 4)).t())
    assert forest_cuda.LAUNCHES == before
    with pytest.raises(ValueError):  # the forest reads a feature the matrix does not have
        forest_cuda.WideForestKernel(_port(ref), f - 1, "cpu")
