"""The port's per-tree forest path against the JAX package's, bit for bit.

- the plain version of the per-tree CUDA kernel (``forest.predict_margin_gemm``)
  equals the reference's ``predict_margin_gemm`` and its Pallas
  ``_margin_pallas`` (interpret mode, as its own tests run it on the CPU),
  byte for byte, for sklearn, boosted and xgboost forests — the last with
  default_left routing and NaN inputs;
- the kernel's int8 tables (``forest_cuda.tree_step_tables``): their
  routing (int32 sums of int8 products against ``plen - c``, over the
  k-blocks each pass of 64 leaves reads, B fragments decoded by the PTX
  layout of ``mma.m16n8k32``) equals the reference's ``d @ m2 + c == plen``
  for every leaf, and a numpy replay of ``csrc/forest_tree_step.cu`` over
  them gives the reference's and the Pallas kernel's margins bit for bit —
  also on trees of several passes, of I and L off the 32/64 grid, and with
  passes cut into several units (the kernel itself needs the card); each
  k-block's nodes sit in an order that spares the kernel's feature loads
  bank conflicts;
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
from variantcalling_tpu import synthetic as jsynth
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


# The B fragment of ``mma.m16n8k32.row.col`` with int8 operands (PTX ISA,
# "Matrix fragments for mma.m16n8k32"): lane 4g + q holds in register r, byte
# i, the element at k = 4q + i + 16r, n = g. A k-block's fragments are read by
# lane l as four words at (pair * 32 + l) * 4: words 0, 1 the registers of
# n-tile 2 pair, words 2, 3 those of n-tile 2 pair + 1.
_P, _L, _W, _B = np.meshgrid(np.arange(4), np.arange(32), np.arange(4), np.arange(4), indexing="ij")
_FRAG_LEAF = 8 * (2 * _P + (_W >> 1)) + (_L >> 2)
_FRAG_NODE = 4 * (_L & 3) + _B + 16 * (_W & 1)


def _b_matrix(words: np.ndarray) -> np.ndarray:
    """A k-block's 512 fragment words -> its (64 leaves, 32 nodes) int8 block of m2."""
    out = np.zeros((64, 32), dtype=np.int8)
    out[_FRAG_LEAF, _FRAG_NODE] = words.view(np.int8).reshape(4, 32, 4, 4)
    return out


def _decode_units(tables: forest_cuda.TreeStepTables):
    """Yield (flags, [(node entries (32, 2), m2 block (64, 32)) per k-block],
    leaf table (64, 2) or None) per unit, decoded as the kernel reads them."""
    blob = tables.blob
    for off, word in tables.units:
        pos, blocks = int(off) * 4, []
        for _ in range(int(word) & 0xFFFF):
            blocks.append((blob[pos:pos + 64].reshape(32, 2), _b_matrix(blob[pos + 64:pos + 576])))
            pos += 576
        leaves = blob[pos:pos + 128].reshape(64, 2) if word & forest_cuda.UNIT_LAST_PASS else None
        yield int(word), blocks, leaves


def _unit_layout(m2: np.ndarray, plen: np.ndarray) -> list[tuple[int, int, np.ndarray]]:
    """(tree, pass, k-blocks) of each unit the per-tree tables hold, in order,
    from the reference's ``m2`` (T, I, L) and ``plen`` (T, L): per tree the
    passes of 64 leaves that hold a real leaf, each over the k-blocks of 32
    nodes whose m2 block under its leaves is not all zero, cut into runs of at
    most ``UNIT_K_BLOCKS`` (a pass with none is one empty unit)."""
    t, i, l = m2.shape
    ip, lp = -(-i // 32) * 32, -(-l // 64) * 64
    m2p = np.zeros((t, ip, lp), m2.dtype)
    m2p[:, :i, :l] = m2
    live = m2p.reshape(t, ip // 32, 32, lp // 64, 64).any(axis=(2, 4))  # (T, k-blocks, passes)
    real = np.pad(plen >= 0, ((0, 0), (0, lp - l))).reshape(t, lp // 64, 64).any(axis=2)
    out, step = [], forest_cuda.UNIT_K_BLOCKS
    for ti in range(t):
        for pi in np.flatnonzero(real[ti]):
            kbs = np.flatnonzero(live[ti, :, pi])
            out += [(ti, pi, kbs[lo:lo + step]) for lo in range(0, max(len(kbs), 1), step)]
    return out


def _replay_tree_step(tables: forest_cuda.TreeStepTables, x: np.ndarray) -> np.ndarray:
    """numpy replay of ``csrc/forest_tree_step.cu`` over the wrapper's int8
    tables: the feature rows (and, with default_left, the rows with NaN read
    as -inf), per k-block the decisions ``v <= thr`` as int8 -1 / 0, int32
    sums of int8 products, the hit test against ``c - plen``, the value
    select, and the ascending float32 tree sum."""
    n = len(x)
    rows = x if tables.columns == x.shape[1] else np.concatenate([x, np.where(np.isnan(x), -np.inf, x)], axis=1)
    acc = np.zeros(n, dtype=np.float32)
    pick, hits = np.zeros(n, dtype=np.uint32), np.zeros(n, dtype=np.int64)
    for word, blocks, leaves in _decode_units(tables):
        if word & forest_cuda.UNIT_FIRST:
            sums = np.zeros((n, 64), dtype=np.int32)
        for nodes, m2 in blocks:
            d = np.where(rows[:, nodes[:, 1]] <= nodes[:, 0].view(np.float32), -1, 0).astype(np.int8)
            sums += d.astype(np.int32) @ m2.astype(np.int32).T
        if leaves is not None:
            hit = sums == leaves[None, :, 0]
            hits += hit.sum(axis=1)
            pick |= np.bitwise_or.reduce(np.where(hit, leaves[None, :, 1].view(np.uint32), np.uint32(0)), axis=1)
        if word & forest_cuda.UNIT_LAST_TREE:
            assert (hits == 1).all()  # exactly one leaf of the tree hits each row
            acc = (acc + pick.view(np.float32)).astype(np.float32)
            pick[:], hits[:] = 0, 0
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
    assert _replay_tree_step(kernel.tables, x).tobytes() == want.tobytes()
    # the Pallas kernel has no default-left table: hold it to finite inputs, where
    # the default never applies
    xf = np.nan_to_num(x, nan=0.25)
    pad = (-len(xf)) % TILE_N
    tables = tuple(jnp.asarray(getattr(jg, k)) for k in ("a", "thr", "m2", "c", "plen", "value"))
    pallas = np.asarray(_margin_pallas(tables, jnp.pad(jnp.asarray(xf), ((0, pad), (0, 0))), True))[:len(xf)]
    assert kernel(torch.from_numpy(xf)).numpy().tobytes() == pallas.tobytes()


@pytest.mark.parametrize("name", NAMES)
def test_bitmask_leaf_test_equals_reference_routing(forests, name):
    """For random decisions d, the int8 tables' routing — int32 sums of -d
    times each unit's m2 blocks, hit where the sum equals the leaf table's
    ``c - plen`` — picks exactly the leaves ``d @ m2 + c == plen`` picks, on
    complete and ragged trees, padded leaves and a stump; the k-blocks a pass
    skips are zero in m2; the node entries (a default-left node reads the
    column ``F + feature``) and m2 rows are to_gemm's in each k-block's bank
    order (a padded node reads its load's first column), and the leaf tables
    are to_gemm's."""
    ref, f, _ = forests[name]
    jg = jforest.to_gemm(ref, f)
    m2, c, plen, value, thr = (np.asarray(getattr(jg, k)) for k in ("m2", "c", "plen", "value", "thr"))
    tables = forest_cuda.tree_step_tables(tforest.to_gemm(_port(ref), f))
    t, i, l = m2.shape
    ip, lp = -(-i // 32) * 32, -(-l // 64) * 64
    m2p = np.zeros((t, ip, lp), np.float32)
    m2p[:, :i, :l] = m2
    entry = np.zeros((t, ip, 2), np.int32)
    entry[:, :i, 0] = thr.view(np.int32)
    dleft = np.zeros((t, i), bool) if jg.dleft is None else np.asarray(jg.dleft) > 0.5
    entry[:, :i, 1] = np.asarray(jg.a).argmax(axis=1) + f * dleft
    assert tables.columns == (f if jg.dleft is None else 2 * f)
    rng = np.random.default_rng(i * 100 + l)
    d = (rng.random((t, 256, ip)) < 0.5).astype(np.int8)
    want = (np.einsum("tnk,tkl->tnl", d[:, :, :i].astype(np.float32), m2) + c[:, None, :]) == plen[:, None, :]
    got = np.zeros((t, 256, lp), dtype=bool)
    seen = np.zeros((t, lp // 64, ip // 32), dtype=bool)
    layout = _unit_layout(m2, plen)
    units = list(_decode_units(tables))
    assert len(units) == len(layout)
    for u, ((word, blocks, leaves), (ti, pi, kbs)) in enumerate(zip(units, layout)):
        last_of_pass = u + 1 == len(layout) or layout[u + 1][:2] != (ti, pi)
        assert bool(word & forest_cuda.UNIT_FIRST) == (u == 0 or layout[u - 1][:2] != (ti, pi))
        assert (leaves is not None) == last_of_pass
        assert bool(word & forest_cuda.UNIT_LAST_TREE) == (u + 1 == len(layout) or layout[u + 1][0] != ti)
        assert len(blocks) == len(kbs)
        if word & forest_cuda.UNIT_FIRST:
            sums = np.zeros((256, 64), dtype=np.int32)
        leaf_cols = slice(pi * 64, (pi + 1) * 64)
        for (nodes, b), kb in zip(blocks, kbs):
            ks = slice(kb * 32, (kb + 1) * 32)
            seen[ti, pi, kb] = True
            order = forest_cuda._bank_order(entry[ti, ks, 1], np.arange(kb * 32, (kb + 1) * 32) < i)
            want_nodes = entry[ti, ks][order]
            want_nodes[order >= i - kb * 32, 1] = want_nodes[np.arange(32) & ~12, 1][order >= i - kb * 32]
            np.testing.assert_array_equal(nodes, want_nodes)
            np.testing.assert_array_equal(b, m2p[ti, ks, leaf_cols][order].T.astype(np.int8))
            sums -= d[ti, :, ks][:, order].astype(np.int32) @ b.astype(np.int32).T
        if leaves is not None:
            got[ti, :, leaf_cols] = sums == leaves[None, :, 0]
            real = np.arange(pi * 64, (pi + 1) * 64) < l
            np.testing.assert_array_equal(leaves[real, 0], (c - plen)[ti, leaf_cols][real[:l - pi * 64]])
            np.testing.assert_array_equal(leaves[real, 1].view(np.float32), value[ti, leaf_cols][real[:l - pi * 64]])
            assert (leaves[~real] == [1, 0]).all()
    blocks = m2p.reshape(t, ip // 32, 32, lp // 64, 64).transpose(0, 3, 1, 2, 4)
    assert not blocks[~seen].any()  # a skipped k-block adds nothing
    np.testing.assert_array_equal(got[:, :, :l], want)  # padded leaves (plen = -1) included
    assert not got[:, :, l:].any()


def _load_wavefronts(cols: np.ndarray) -> np.ndarray:
    """(32,) columns of a k-block in slot order -> (8,) shared-memory
    wavefronts of the kernel's 8 feature loads: lanes q = 0..3 read slots
    ``s | 4 q``, column c at bank offset 8 c mod 32, so a load takes as many
    wavefronts as it has distinct columns of one class c mod 4, at most."""
    loads = [{int(cols[s + 4 * q]) for q in range(4)} for s in (0, 1, 2, 3, 16, 17, 18, 19)]
    return np.asarray([max(sum(1 for c in load if c % 4 == r) for r in range(4)) for load in loads])


@pytest.mark.parametrize("case", ["distinct_32", "one_column", "classes_crowded", "padded_tail",
                                  "xgb_synthetic_6x64", "sklearn_rf_ragged_dleft"])
def test_bank_order_spreads_each_load_over_the_banks(forests, case):
    """Each k-block's bank order is a permutation of its 32 slots with the
    padded nodes in the loads' last lanes; it leaves every load
    conflict-free where the block's columns allow it, and costs the kernel's
    feature loads fewer shared-memory wavefronts than to_gemm's order."""
    rng = np.random.default_rng(90)
    if case in forests:
        ref, f, _ = forests[case]
        jg = jforest.to_gemm(ref, f)
        i = jg.m2.shape[1]
        cols = np.zeros((jg.m2.shape[0], -(-i // 32) * 32), np.int64)
        dleft = np.zeros(cols[:, :i].shape, bool) if jg.dleft is None else np.asarray(jg.dleft) > 0.5
        cols[:, :i] = np.asarray(jg.a).argmax(axis=1) + f * dleft
        blocks, real = cols.reshape(-1, 32), (np.arange(cols.shape[1]) < i)[None].repeat(len(cols), 0).reshape(-1, 32)
    else:
        blocks = {"distinct_32": rng.permutation(32), "one_column": np.full(32, 7),
                  "classes_crowded": rng.choice([0, 4, 8, 12, 1, 5, 2, 3], 32),
                  "padded_tail": rng.integers(0, 38, 32)}[case][None]
        real = np.ones((1, 32), bool)
        if case == "padded_tail":
            real[0, 27:] = False
    got = was = 0
    for c, r in zip(blocks, real):
        order = forest_cuda._bank_order(c, r)
        assert sorted(order.tolist()) == list(range(32))
        placed = c[order].copy()
        placed[~r[order]] = placed[np.arange(32) & ~12][~r[order]]  # a padded node reads its load's first column
        for s in (0, 1, 2, 3, 16, 17, 18, 19):
            lanes = r[order][[s + 4 * q for q in range(4)]]
            assert not (lanes[1:] & ~lanes[:-1]).any()  # padded nodes after the real ones
        waves = _load_wavefronts(placed)
        if case in ("distinct_32", "one_column"):
            assert (waves == 1).all()
        got, was = got + waves.sum(), was + _load_wavefronts(np.where(r, c, 0)).sum()
    assert got <= was and (got < was or case == "one_column")


def _caterpillar(n_int: int, seed: int) -> jforest.FlatForest:
    """One tree of ``n_int`` internal nodes in a chain (each a leaf on its
    left), with default_left: its last leaf's path reads every node."""
    rng = np.random.default_rng(seed)
    m = 2 * n_int + 1
    feature = np.full((1, m), -1, np.int32)
    feature[0, :n_int] = rng.integers(0, 19, n_int)
    left = np.arange(m, dtype=np.int32)[None, :].copy()
    right = left.copy()
    left[0, :n_int] = np.arange(n_int) + n_int
    right[0, :n_int - 1] = np.arange(1, n_int)
    right[0, n_int - 1] = 2 * n_int
    threshold = np.zeros((1, m), np.float32)
    threshold[0, :n_int] = rng.uniform(45, 50, n_int)  # most rows walk deep
    return jforest.FlatForest(feature=feature, threshold=threshold, left=left, right=right,
                              value=rng.normal(size=(1, m)).astype(np.float32), max_depth=n_int,
                              aggregation="logit_sum", default_left=rng.random((1, m)) < 0.5)


@pytest.mark.parametrize("name", ["complete_256_leaves", "ragged_rf_100_leaves", "caterpillar_600_dleft",
                                  "mixed_depths_dleft"])
def test_int8_tables_across_passes_and_units(name):
    """The per-tree tables on trees of several 64-leaf passes, I and L off the
    32/64 grid, and a pass of more than 16 live k-blocks cut into units: the
    numpy replay equals the reference's ``predict_margin_gemm`` and gather
    walk, and (on finite inputs) its Pallas ``_margin_pallas``, bit for bit."""
    rng = np.random.default_rng(70)
    x = rng.uniform(0, 50, (600, 19)).astype(np.float32)
    if name == "complete_256_leaves":
        ref = jsynth.synthetic_forest(rng, n_trees=3, depth=9, n_features=19)
    elif name == "ragged_rf_100_leaves":
        from sklearn.ensemble import RandomForestClassifier

        y = (x[:, 0] + rng.normal(0, 8, len(x)) > 25).astype(int)
        ref = jforest.from_sklearn(RandomForestClassifier(n_estimators=3, max_leaf_nodes=100, random_state=0)
                                   .fit(x, y))
    elif name == "caterpillar_600_dleft":
        ref = _caterpillar(600, 71)
        x[rng.random(x.shape) < 0.1] = np.nan
    else:  # a stump, a depth-3 tree and a 128-leaf tree in one forest, default_left
        parts = [jsynth.synthetic_forest(rng, n_trees=1, depth=d, n_features=19) for d in (1, 3, 8)]
        m = max(pt.feature.shape[1] for pt in parts)
        arrays = {k: np.concatenate([np.pad(np.asarray(getattr(pt, k)), ((0, 0), (0, m - pt.feature.shape[1])),
                                            constant_values=-1 if k == "feature" else 0) for pt in parts])
                  for k in ("feature", "threshold", "left", "right", "value")}
        ref = jforest.FlatForest(**arrays, max_depth=8, default_left=rng.random((3, m)) < 0.5)
        x[rng.random(x.shape) < 0.1] = np.nan
    jg = jforest.to_gemm(ref, 19)
    i, l = jg.m2.shape[1:]
    tables = forest_cuda.tree_step_tables(tforest.to_gemm(_port(ref), 19))
    if name == "caterpillar_600_dleft":
        assert -(-i // 32) > forest_cuda.UNIT_K_BLOCKS  # the deepest pass reads every k-block
        assert not (tables.units[:, 1] & forest_cuda.UNIT_FIRST).all()  # ... in more than one unit
    if name != "mixed_depths_dleft":
        assert l > forest_cuda.PASS_LEAVES and (i % 32 or l % 64 or name == "complete_256_leaves")
    want = np.asarray(jforest.predict_margin_gemm(jg, jnp.asarray(x)))
    np.testing.assert_array_equal(np.asarray(jforest.predict_margin(ref, jnp.asarray(x))), want)
    assert _replay_tree_step(tables, x).tobytes() == want.tobytes()
    assert forest_cuda.TreeStepKernel(tforest.to_gemm(_port(ref), 19), "cpu")(torch.from_numpy(x)).numpy().tobytes() \
        == want.tobytes()
    if not np.isnan(x).any():
        pad = (-len(x)) % TILE_N
        pallas_tables = tuple(jnp.asarray(getattr(jg, k)) for k in ("a", "thr", "m2", "c", "plen", "value"))
        pallas = np.asarray(_margin_pallas(pallas_tables, jnp.pad(jnp.asarray(x), ((0, pad), (0, 0))), True))
        assert pallas[:len(x)].tobytes() == want.tobytes()


@pytest.mark.parametrize("columns,stage_bytes,want_warps", [(19, 16_384, 4), (38, 16_384, 4), (38, 37_376, 4),
                                                            (453, 37_376, 2), (1_300, 5_120, 1)])
def test_tree_step_plan_fits_the_shared_memory(columns, stage_bytes, want_warps):
    warps, grid, smem = forest_cuda.tree_step_plan(104_000, columns, stage_bytes, 232_448)
    assert (warps, grid) == (want_warps, -(-104_000 // (32 * want_warps)))
    assert smem == 2 * stage_bytes + columns * (32 * warps + 8) * 4 <= 232_448
    with pytest.raises(RuntimeError, match="shared memory"):
        forest_cuda.tree_step_plan(10, 4_000, stage_bytes, 232_448)


@pytest.mark.parametrize("name", ["sklearn_rf_ragged", "xgb_synthetic_6x64"])
def test_tree_step_stages_cover_the_units_in_order(forests, name):
    """The stages the kernel copies whole: consecutive runs of units in blob
    order, each within STAGE_BYTES unless it is one larger unit."""
    ref, f, _ = forests[name]
    tables = forest_cuda.tree_step_tables(tforest.to_gemm(_port(ref), f))
    st = tables.stages
    assert st[0, 2] == 0 and (st[1:, 2] == st[:-1, 2] + st[:-1, 3]).all() and st[-1, 2] + st[-1, 3] == len(tables.units)
    assert (st[:, 0] == tables.units[st[:, 2], 0]).all()
    assert st[-1, 0] + st[-1, 1] == len(tables.blob) // 4 and (st[1:, 0] == st[:-1, 0] + st[:-1, 1]).all()
    assert ((16 * st[:, 1] <= forest_cuda.STAGE_BYTES) | (st[:, 3] == 1)).all()
    assert tables.stage_bytes == 16 * st[:, 1].max()


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
