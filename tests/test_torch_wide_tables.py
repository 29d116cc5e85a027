"""The wide kernel's tables against the reference's gather walk, in numpy.

The kernel needs the card (``tests/test_torch_cuda.py``); here its tables
(``forest_cuda.compact_tables``) are decoded and walked as
``csrc/forest_wide.cu`` walks them:

- the structure: each tree's root in its first slot, breadth first, an
  internal node's children in the adjacent slots ``first`` and
  ``first + 1``, the feature, threshold and default bit of its node, a
  leaf's value and its step onto itself; chunks of whole trees in order;
- the walk: the leaf each row reaches in each tree, and its value, equal
  the reference's gather walk (``predict_margin`` of one tree at a time,
  with node ids for values), with NaN taking the default bit — on
  complete, ragged and stump trees, default_left forests, trees of 256
  and 512 leaves, and a forest cut into chunks;
- the limits: the record's fields, the chunk budget (trees of 2,048
  leaves cut inside a group of four), the launch shape;
- trees too large for a chunk (above 7,264 and above 32,768 nodes): global
  chunks of 16-byte records with 32-bit child slots, walked to the
  reference's leaves, and explicit ``wide`` resolved to the kernel on the
  card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_forest import _port, _sklearn_forests, _walk_compact_tables
from tests.test_torch_forest_gemm import _range_features, _xgb_synthetic
from variantcalling_tpu.models import forest as jforest
from variantcalling_tpu.models import xgb as jxgb
from variantcalling_tpu.synthetic import synthetic_forest as j_synthetic_forest
from variantcalling_tpu_torch.engine import EngineError
from variantcalling_tpu_torch.models import forest as tforest
from variantcalling_tpu_torch.models import forest_cuda

ARRAYS = ("feature", "threshold", "left", "right", "value")


def _stump_and_split() -> jforest.FlatForest:
    return jforest.FlatForest(
        feature=np.asarray([[-1, -1, -1], [1, -1, -1]], np.int32),
        threshold=np.asarray([[0, 0, 0], [0.5, 0, 0]], np.float32),
        left=np.asarray([[0, 1, 2], [1, 1, 2]], np.int32), right=np.asarray([[0, 1, 2], [2, 1, 2]], np.int32),
        value=np.asarray([[0.25, 0, 0], [0, -1.5, 2.0]], np.float32), max_depth=2, aggregation="logit_sum")


def _with_dleft(ref, seed: int) -> jforest.FlatForest:
    return jforest.FlatForest(**{k: np.asarray(getattr(ref, k)) for k in ARRAYS}, max_depth=ref.max_depth,
                              aggregation=ref.aggregation,
                              default_left=np.random.default_rng(seed).random(ref.feature.shape) < 0.5)


def _uniform(n: int, f: int, scale: float, seed: int, nan_share: float = 0.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.random((n, f)) * scale).astype(np.float32)
    x[rng.random(x.shape) < nan_share] = np.nan
    return x


def _concat(parts: list, dleft_seed: int | None = None) -> jforest.FlatForest:
    """The trees of ``parts`` (reference FlatForests) in order, padded to one node count."""
    m = max(pt.feature.shape[1] for pt in parts)
    arrays = {k: np.concatenate([np.pad(np.asarray(getattr(pt, k)), ((0, 0), (0, m - pt.feature.shape[1])),
                                        constant_values=-1 if k == "feature" else 0) for pt in parts])
              for k in ARRAYS}
    dleft = None if dleft_seed is None else np.random.default_rng(dleft_seed).random(arrays["feature"].shape) < 0.5
    return jforest.FlatForest(**arrays, max_depth=max(pt.max_depth for pt in parts), aggregation="logit_sum",
                              default_left=dleft)


@pytest.fixture(scope="module")
def cases():
    """name -> (reference FlatForest, n_features, x (N, F) float32, smem budget)."""
    rf, _ = _sklearn_forests()
    rng = np.random.default_rng(31)
    x19 = _uniform(400, 19, 50.0, 32)
    return {
        "complete_64_leaves": (j_synthetic_forest(rng, n_trees=6, depth=7, n_features=19), 19, x19,
                               forest_cuda.SMEM_BYTES),
        "ragged_sklearn_rf": (rf, 8, _uniform(400, 8, 1.0, 33), forest_cuda.SMEM_BYTES),
        "stump_and_split": (_stump_and_split(), 2, _uniform(400, 2, 1.0, 34), forest_cuda.SMEM_BYTES),
        "xgboost_default_left_nan": (jxgb.from_xgboost_json(_xgb_synthetic(13, 6)), 19,
                                     _range_features(400, 35, 0.1), forest_cuda.SMEM_BYTES),
        "ragged_default_left_nan": (_with_dleft(rf, 36), 8, _uniform(400, 8, 1.0, 37, 0.15),
                                    forest_cuda.SMEM_BYTES),
        "leaves_256": (j_synthetic_forest(rng, n_trees=3, depth=9, n_features=19), 19, x19,
                       forest_cuda.SMEM_BYTES),
        "leaves_512_default_left_nan": (_with_dleft(j_synthetic_forest(rng, n_trees=2, depth=10, n_features=19), 38),
                                        19, _uniform(400, 19, 50.0, 39, 0.1), forest_cuda.SMEM_BYTES),
        # 11 trees of 64 leaves over a budget that leaves room for 4 of them a chunk
        "chunked": (j_synthetic_forest(rng, n_trees=11, depth=7, n_features=19), 19, x19,
                    2 * 20 * forest_cuda.tile_rows(19) * 4 + 2 * 4 * 127 * 8 + 16),
        # 64-leaf trees around two of 16,383 nodes: chunks in shared memory, global, in shared memory
        "trees_past_7264_nodes_default_left_nan": (
            _concat([j_synthetic_forest(rng, n_trees=k, depth=d, n_features=19) for k, d in ((3, 7), (2, 14), (2, 7))],
                    dleft_seed=44), 19, _uniform(400, 19, 50.0, 45, 0.1), forest_cuda.SMEM_BYTES),
        # a tree of 65,535 nodes (past the 15-bit child slot) beside a 256-leaf tree
        "tree_past_32768_nodes": (_concat([j_synthetic_forest(rng, n_trees=1, depth=d, n_features=19) for d in (16, 9)]),
                                  19, x19, forest_cuda.SMEM_BYTES),
    }


def _reference_leaves(ref: jforest.FlatForest, x: np.ndarray) -> np.ndarray:
    """(N, T) node each row reaches in each tree, by the reference's gather walk:
    one tree at a time, with each node's id as its value."""
    t, m = ref.feature.shape
    ids = np.arange(m, dtype=np.float32)[None, :]
    out = []
    for ti in range(t):
        one = jforest.FlatForest(**{k: np.asarray(getattr(ref, k))[ti:ti + 1] for k in ARRAYS[:4]}, value=ids,
                                 max_depth=ref.max_depth,
                                 default_left=None if ref.default_left is None else ref.default_left[ti:ti + 1])
        out.append(np.asarray(jforest.predict_margin(one, jnp.asarray(x))))
    return np.stack(out, axis=1).astype(np.int64)


def _tree_slots(tables: forest_cuda.WideTables, ti: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tree ti's slots in order: (the record index of each, its node id, its
    feature word (default bit, feature), its first child)."""
    c = int(np.searchsorted(tables.chunk_tree, ti, side="right")) - 1
    wide = 2 if tables.chunk_global[c] else 1
    start = int(tables.chunk_rec[c]) + wide * int(tables.tree_off[ti])
    stop = int(tables.chunk_rec[c]) + (wide * int(tables.tree_off[ti + 1]) if ti + 1 < tables.chunk_tree[c + 1]
                                       else int(tables.chunk_rec[c + 1]) - int(tables.chunk_rec[c]))
    at = np.arange(start, stop, wide)
    y = tables.records[at, 1].astype(np.int64)
    if wide == 2:  # a 16-byte record: [bits, feature word, first, 0]
        assert (tables.node[at + 1] == -1).all() and (tables.records[at + 1, 1] == 0).all()
        return at, tables.node[at], y, tables.records[at + 1, 0].astype(np.int64)
    return at, tables.node[at], y & 0xFFFF, y >> 16


@pytest.mark.parametrize("name", ["complete_64_leaves", "ragged_sklearn_rf", "stump_and_split",
                                  "xgboost_default_left_nan", "ragged_default_left_nan", "leaves_256",
                                  "leaves_512_default_left_nan", "chunked", "trees_past_7264_nodes_default_left_nan",
                                  "tree_past_32768_nodes"])
def test_tables_decode_to_the_forest(cases, name):
    ref, f, _, smem = cases[name]
    forest = _port(ref)
    tables = forest_cuda.compact_tables(forest, f, smem)
    rec = tables.records
    dleft = np.zeros(forest.feature.shape, bool) if forest.default_left is None else forest.default_left
    for ti in range(forest.n_trees):
        at, node, y, first = _tree_slots(tables, ti)
        leaf = (y & 0x7FFF) == f
        n_real = int((node >= 0).sum())
        assert (node[:n_real] >= 0).all() and (node[n_real:] < 0).all()  # slots packed from the root
        assert node[0] == 0
        depth = np.zeros(n_real, dtype=np.int64)
        for s in range(n_real):
            k, r = node[s], at[s]
            if forest.feature[ti, k] == tforest.LEAF:
                assert leaf[s] and first[s] == s and y[s] & 0x8000  # a leaf steps onto itself
                assert rec[r, 0] == forest.value[ti, k:k + 1].view(np.int32)[0]
                continue
            assert not leaf[s] and first[s] > s
            assert node[first[s]] == forest.left[ti, k] and node[first[s] + 1] == forest.right[ti, k]
            assert (y[s] & 0x7FFF) == forest.feature[ti, k] and bool(y[s] & 0x8000) == bool(dleft[ti, k])
            assert rec[r, 0] == forest.threshold[ti, k:k + 1].view(np.int32)[0]
            depth[first[s]] = depth[first[s] + 1] = depth[s] + 1
        assert (np.diff(depth) >= 0).all()  # breadth first
        assert tables.depth[ti] == depth.max()
    # chunks: whole trees in order, even record counts, each chunk within its budget
    assert tables.chunk_tree[0] == 0 and tables.chunk_tree[-1] == forest.n_trees
    assert (np.diff(tables.chunk_tree) > 0).all() and (np.diff(tables.chunk_rec) % 2 == 0).all()
    assert tables.smem_bytes(f, forest_cuda.tile_rows(f)) <= smem
    if name == "chunked":
        assert tables.n_chunks == 3 and list(tables.chunk_tree) == [0, 4, 8, 11]
    if name.startswith("trees_past"):  # chunks: local, global, local
        assert list(tables.chunk_tree) == [0, 3, 5, 7] and list(tables.chunk_global) == [False, True, False]
    elif name == "tree_past_32768_nodes":
        assert list(tables.chunk_global) == [True, False] and int(np.diff(tables.chunk_rec)[0]) == 2 * 65_535
    else:
        assert not tables.chunk_global.any()


@pytest.mark.parametrize("name", ["complete_64_leaves", "ragged_sklearn_rf", "stump_and_split",
                                  "xgboost_default_left_nan", "ragged_default_left_nan", "leaves_256",
                                  "leaves_512_default_left_nan", "chunked", "trees_past_7264_nodes_default_left_nan",
                                  "tree_past_32768_nodes"])
def test_table_walk_reaches_the_reference_leaf(cases, name):
    ref, f, x, smem = cases[name]
    forest = _port(ref)
    tables = forest_cuda.compact_tables(forest, f, smem)
    margin, ends = _walk_compact_tables(tables, x)
    want_leaf = _reference_leaves(ref, x)
    np.testing.assert_array_equal(tables.node[ends], want_leaf)
    t_idx = np.arange(forest.n_trees)[None, :]
    assert tables.records[ends, 0].view(np.float32).tobytes() == forest.value[t_idx, want_leaf].tobytes()
    want = np.asarray(jforest.predict_margin(ref, jnp.asarray(x)))
    assert margin.tobytes() == want.tobytes()
    if tables.chunk_global.any():  # the plain version's wide encoding of such trees would take gigabytes
        assert tforest.predict_margin(forest, torch.from_numpy(x)).numpy().tobytes() == want.tobytes()
    else:
        assert forest_cuda.WideForestKernel(forest, f, "cpu")(torch.from_numpy(x)).numpy().tobytes() == want.tobytes()


def test_default_budget_streams_the_256_leaf_forest():
    """100 trees of 256 leaves (409 KB of records) stream in chunks of whole
    groups of trees; 100 trees of 64 leaves stay resident in one chunk."""
    rng = np.random.default_rng(40)
    big = forest_cuda.compact_tables(tforest.FlatForest(
        **{k: np.asarray(getattr(j_synthetic_forest(rng, n_trees=100, depth=9, n_features=19), k)) for k in ARRAYS},
        max_depth=9), 19)
    assert big.n_chunks > 1 and (np.diff(big.chunk_tree)[:-1] % forest_cuda.TREES_AT_ONCE == 0).all()
    assert 2 * big.chunk_records * 8 + 2 * 20 * 512 * 4 <= forest_cuda.SMEM_BYTES
    small = forest_cuda.compact_tables(tforest.FlatForest(
        **{k: np.asarray(getattr(j_synthetic_forest(rng, n_trees=100, depth=7, n_features=19), k)) for k in ARRAYS},
        max_depth=7), 19)
    assert small.n_chunks == 1 and small.chunk_records == 100 * 127


def test_trees_of_2048_leaves_cut_inside_a_group():
    """10 trees of 2,048 leaves (4,095 records each; four of them exceed a
    chunk): the chunks cut between single trees, each chunk and the launch
    fit the shared memory, and the walk reaches the reference's leaves."""
    ref = j_synthetic_forest(np.random.default_rng(41), n_trees=10, depth=12, n_features=19)
    forest = _port(ref)
    tables = forest_cuda.compact_tables(forest, 19)
    per_tree = 2 * 2048 - 1
    assert tables.n_chunks > 1 and 4 * per_tree > tables.chunk_records >= per_tree
    assert any(int(k) % forest_cuda.TREES_AT_ONCE for k in tables.chunk_tree[1:-1])
    assert (np.diff(tables.chunk_tree) > 0).all() and (np.diff(tables.chunk_rec) % 2 == 0).all()
    for rows in (forest_cuda.tile_rows(19), 32):
        assert tables.smem_bytes(19, rows) <= forest_cuda.SMEM_BYTES
    x = _uniform(300, 19, 50.0, 42)
    margin, ends = _walk_compact_tables(tables, x)
    np.testing.assert_array_equal(tables.node[ends], _reference_leaves(ref, x))
    assert margin.tobytes() == np.asarray(jforest.predict_margin(ref, jnp.asarray(x))).tobytes()


@pytest.mark.parametrize("request_", ["wide", "pallas"])
def test_tree_past_the_card_limit_refused_at_resolve(monkeypatch, request_):
    """Trees past what a chunk buffer holds — two of 16,383 nodes, and one of
    65,535 past the 15-bit child slot — are no longer refused: an explicit
    ``wide`` (or ``pallas``, which names the wide kernel) resolves to the
    kernel on the card and its tables walk them from device memory, in global
    chunks; ``auto`` still sends them to the gather walk. No wide encoding
    is built (its m2 would take gigabytes)."""
    rng = np.random.default_rng(43)
    for forest in (_port(j_synthetic_forest(rng, n_trees=2, depth=14, n_features=19)),
                   _port(j_synthetic_forest(rng, n_trees=1, depth=16, n_features=19))):
        nodes = 2 * tforest.max_tree_leaves(forest) - 1
        assert nodes > forest_cuda.SMEM_BYTES // 32
        monkeypatch.setenv(tforest.FOREST_STRATEGY_ENV, request_)
        assert tforest.resolve_strategy(forest, torch.device("cuda")) == "cuda-wide"
        assert tforest.resolve_strategy(forest, torch.device("cpu")) == "wide"
        assert forest_cuda.WideForestKernel(forest, 19, "cpu").tables is None
        tables = forest_cuda.compact_tables(forest, 19)
        assert tables.chunk_global.all() and tables.chunk_records == 0
        assert tables.smem_bytes(19, forest_cuda.tile_rows(19)) <= forest_cuda.SMEM_BYTES
        monkeypatch.setenv(tforest.FOREST_STRATEGY_ENV, "auto")
        assert tforest.resolve_strategy(forest, torch.device("cuda")) == "gather"


def test_every_tree_within_the_card_limit_fits_a_chunk():
    """A chunk buffer holds at least a quarter of the shared memory at any
    feature count: trees of up to SMEM_BYTES // 32 nodes stay in shared
    memory, and the chunks fit beside the feature tiles."""
    n_nodes = forest_cuda.SMEM_BYTES // 32
    n_int = (n_nodes - 1) // 2  # a caterpillar tree of n_nodes nodes
    m = 2 * n_int + 1
    feature = np.full((3, m), tforest.LEAF, np.int32)
    feature[:, :n_int] = 0
    left = np.tile(np.arange(m, dtype=np.int32), (3, 1))
    right = left.copy()
    left[:, :n_int] = np.arange(n_int) + n_int
    right[:, :n_int - 1] = np.arange(1, n_int)
    right[:, n_int - 1] = 2 * n_int
    forest = tforest.FlatForest(feature=feature, threshold=np.zeros((3, m), np.float32), left=left, right=right,
                                value=np.zeros((3, m), np.float32), max_depth=n_int)
    for f in (1, 19, 27, 28, 100, 453):  # 453: the most a 32-row feature tile takes
        tables = forest_cuda.compact_tables(forest, f)
        assert not tables.chunk_global.any()
        assert tables.smem_bytes(f, forest_cuda.tile_rows(f)) <= forest_cuda.SMEM_BYTES


def test_record_fields_overflow_raises():
    """The feature field still bounds the feature count; the child slot no
    longer bounds a tree: a caterpillar of 32,769 slots, one past the 15-bit
    field, goes to a global chunk whose 32-bit child slots reach the
    reference's leaves."""
    forest = _port(_stump_and_split())
    forest.feature = forest.feature.copy()
    forest.feature[1, 0] = 19
    with pytest.raises(ValueError, match="reads feature 19 of 19"):
        forest_cuda.compact_tables(forest, 19)
    with pytest.raises(ValueError, match="feature index"):  # the leaves' feature row
        forest_cuda.compact_tables(forest, 1 << 15)
    # a caterpillar tree of 16,384 internal nodes: 32,769 slots, one past the old child field
    n_int = 1 << 14
    m = 2 * n_int + 1
    rng = np.random.default_rng(46)
    feature = np.full((1, m), tforest.LEAF, np.int32)
    feature[0, :n_int] = 0
    left = np.arange(m, dtype=np.int32)[None, :].copy()
    right = left.copy()
    left[0, :n_int] = np.arange(n_int) + n_int  # a leaf
    right[0, :n_int - 1] = np.arange(1, n_int)  # the next internal node
    right[0, n_int - 1] = 2 * n_int
    threshold = np.zeros((1, m), np.float32)
    threshold[0, :n_int] = np.sort(rng.random(n_int)).astype(np.float32)
    ref = jforest.FlatForest(feature=feature, threshold=threshold, left=left, right=right,
                             value=rng.normal(size=(1, m)).astype(np.float32), max_depth=n_int)
    tables = forest_cuda.compact_tables(_port(ref), 1)
    assert list(tables.chunk_global) == [True] and len(tables.records) == 2 * m + 1 + 1 - 2
    x = rng.random((64, 1)).astype(np.float32)
    x[:4, 0] = [0.0, 0.999, 2.0, threshold[0, n_int - 1]]  # the first leaf, deep ones, the last leaf
    margin, ends = _walk_compact_tables(tables, x)
    np.testing.assert_array_equal(tables.node[ends], _reference_leaves(ref, x))
    assert margin.tobytes() == np.asarray(jforest.predict_margin(ref, jnp.asarray(x))).tobytes()
    with pytest.raises(ValueError, match="features per row"):
        forest_cuda.tile_rows(1 << 12)


@pytest.mark.parametrize("n", [1, 31, 513, 70_001, 104_000, 262_144, 5_000_000])
def test_launch_shape_covers_the_rows(n):
    rows, grid = forest_cuda.launch_shape(n, 132, 512)
    tiles = -(-n // rows)
    assert rows % 32 == 0 and 32 <= rows <= 512 and 1 <= grid <= 132
    assert grid == min(tiles, 132)
    # no more rounds over the SMs than full 512-row tiles would take
    assert -(-tiles // grid) == -(-n // (132 * 512))
