"""The boosted-forest fit of the port (``models/boosting``, ``models/gbt_hist``,
the native ``bin_features``/``gbt_fit``) against the JAX package's.

Bars: the quantile edges and bin ids equal (tolerance 0); the native
trainer's trees equal (tolerance 0: the same C++ source); the torch program
(``VCTPU_NATIVE_GBT=0``) against the JAX package's jitted fit at that
package's own native-vs-jit bar (``tests/unit/test_boosting.py``:
features equal, thresholds to 1e-6, values to 1e-2 / 1e-5, scores to
1e-5); one tree's splits, level by level, equal to the reference's
``_grow_tree`` under both of its histogram strategies on bf16-exact
gradients (tolerance 0). The fixed-point histogram is exact: it equals
float64 sums where those are exact and does not change under a row
permutation. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from variantcalling_tpu.models import boosting as jb
from variantcalling_tpu.models.forest import predict_score as j_predict_score
from variantcalling_tpu_torch import native
from variantcalling_tpu_torch.models import boosting as tb
from variantcalling_tpu_torch.models import forest as tf
from variantcalling_tpu_torch.models import gbt_hist


def _toy(rng, n=8000, f=6):
    x = rng.random((n, f)).astype(np.float32)
    logit = 3 * (x[:, 0] - 0.5) + 2 * (x[:, 1] - 0.5) - 2.5 * (x[:, 2] - 0.5)
    y = (logit + rng.normal(0, 0.5, n) > 0).astype(np.float32)
    return x, y


def _cfgs(**kw):
    return jb.BoostConfig(**kw), tb.BoostConfig(**kw)


def _port_score(forest, x) -> np.ndarray:
    return tf.finalize_margin(tf.predict_margin(forest, torch.from_numpy(x)).numpy(), forest)


def _native_or_skip():
    if not native.available():
        pytest.skip("the native engine did not build here (no g++)")


@pytest.mark.parametrize("n_bins", [8, 64, 256])
def test_binning_equals_the_reference(rng, n_bins, monkeypatch):
    x = rng.normal(size=(3000, 5)).astype(np.float32)
    x[:, 4] = np.round(x[:, 4])  # duplicate edges
    edges = tb.quantile_bin_edges(x, n_bins, max_sample=1000)
    want_edges = jb.quantile_bin_edges(x, n_bins, max_sample=1000)
    np.testing.assert_array_equal(edges, want_edges)
    x[::17, 2] = np.nan  # binned into the last bin
    # the reference bins host inputs on the host (its native kernel, else numpy), NaN last
    want = np.empty(x.shape, dtype=np.uint8)
    for j in range(x.shape[1]):
        want[:, j] = np.searchsorted(want_edges[j], x[:, j])
    from variantcalling_tpu import native as jnative

    ref_native = jnative.bin_features(x, want_edges)
    if ref_native is not None:
        np.testing.assert_array_equal(ref_native, want)
    finite = ~np.isnan(x).any(axis=1)  # its device binning, on the rows without NaN
    np.testing.assert_array_equal(np.asarray(jb.bin_features(jnp.asarray(x), jnp.asarray(want_edges)))[finite],
                                  want[finite])
    got = tb.bin_features(x, edges)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("VCTPU_NO_NATIVE", "1")  # the numpy version
    np.testing.assert_array_equal(tb.bin_features(x, edges), want)
    assert (got[::17, 2] == n_bins - 1).all()  # NaN in the last bin


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kw", [dict(n_trees=20, depth=5, n_bins=32, learning_rate=0.3),
                                dict(n_trees=6, depth=3, n_bins=64)])
def test_native_fit_equals_the_reference(rng, weighted, kw):
    _native_or_skip()
    x, y = _toy(rng, n=20000, f=8)
    w = np.where(y > 0.5, 3.0, 1.0).astype(np.float32) if weighted else None
    jcfg, tcfg = _cfgs(**kw)
    want = jb.fit(x, y, sample_weight=w, cfg=jcfg, feature_names=[f"f{i}" for i in range(8)])
    before = native.CALLS["gbt_fit"]["native"]
    got = tb.fit(x, y, sample_weight=w, cfg=tcfg, feature_names=[f"f{i}" for i in range(8)], device="cpu")
    assert native.CALLS["gbt_fit"]["native"] == before + 1
    for field in ("feature", "threshold", "left", "right", "value"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert (got.max_depth, got.aggregation, got.base_score, got.feature_names) == \
        (want.max_depth, want.aggregation, want.base_score, want.feature_names)


@pytest.mark.parametrize("weighted", [False, True])
def test_torch_program_fit_meets_the_native_vs_jit_bar(rng, weighted, monkeypatch):
    x, y = _toy(rng, n=20000, f=8)
    w = np.where(y > 0.5, 3.0, 1.0).astype(np.float32) if weighted else None
    jcfg, tcfg = _cfgs(n_trees=20, depth=5, n_bins=32, learning_rate=0.3)
    monkeypatch.setenv("VCTPU_NATIVE_GBT", "0")
    want = jb.fit(x, y, sample_weight=w, cfg=jcfg)
    before = native.CALLS["gbt_fit"]["native"]
    got = tb.fit(x, y, sample_weight=w, cfg=tcfg, device="cpu")
    assert native.CALLS["gbt_fit"]["native"] == before
    np.testing.assert_array_equal(got.feature, want.feature)
    np.testing.assert_allclose(got.threshold, want.threshold, rtol=1e-6)
    np.testing.assert_allclose(got.value, want.value, rtol=1e-2, atol=1e-5)
    np.testing.assert_allclose(_port_score(got, x), np.asarray(j_predict_score(want, x)), atol=1e-5)


def _grow_tree_port(binned, g, h, cfg):
    feats, bins, leaf, node = tb._grow_tree(torch.from_numpy(binned.astype(np.uint8)), torch.from_numpy(g),
                                            torch.from_numpy(h), cfg)
    return feats.numpy(), bins.numpy(), leaf.numpy(), node.numpy()


@pytest.mark.parametrize("use_matmul", [True, False])
def test_splits_per_level_equal_the_reference(rng, use_matmul):
    """Every level's split features (and bins of live nodes) equal the
    reference's ``_grow_tree`` on bf16-exact gradients, under its matmul and
    scatter histograms alike; the leaves agree to float32 rounding."""
    n, f = 2048, 5
    jcfg, tcfg = _cfgs(n_trees=1, depth=3, n_bins=16)
    binned = rng.integers(0, 16, size=(n, f)).astype(np.int32)
    g = (rng.integers(-8, 9, size=n) / 8.0).astype(np.float32)
    h = (rng.integers(1, 9, size=n) / 8.0).astype(np.float32)
    jf, jbins, jleaf, jnode = jax.jit(
        lambda bn, gg, hh: jb._grow_tree(bn, None, gg, hh, jcfg, use_matmul=use_matmul)
    )(jnp.asarray(binned), jnp.asarray(g), jnp.asarray(h))
    feats, bins, leaf, node = _grow_tree_port(binned, g, h, tcfg)
    for level in range(tcfg.depth):
        k = 1 << level
        np.testing.assert_array_equal(feats[level], np.asarray(jf)[level], err_msg=f"level {level}")
        live = feats[level, :k] >= 0
        np.testing.assert_array_equal(bins[level, :k][live], np.asarray(jbins)[level, :k][live])
    np.testing.assert_array_equal(node, np.asarray(jnode))
    np.testing.assert_allclose(leaf, np.asarray(jleaf), rtol=1e-6, atol=1e-7)


def test_leaf_sums_from_the_last_level_equal_a_pass_over_the_rows(rng):
    """The leaf values come from the last level's cumulated sums: they equal
    -lr * G / (H + lambda) over each leaf's rows, summed exactly."""
    n, f = 3000, 4
    cfg = tb.BoostConfig(n_trees=1, depth=4, n_bins=8)
    binned = rng.integers(0, 8, size=(n, f))
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    _, _, leaf, node = _grow_tree_port(binned, g, h, cfg)
    for k in range(1 << cfg.depth):
        rows = node == k
        want = -cfg.learning_rate * g[rows].astype(np.float64).sum() / (h[rows].astype(np.float64).sum() + 1.0)
        assert abs(leaf[k] - np.float32(want)) <= 2 * np.spacing(np.float32(abs(want)) + np.float32(1e-30))


def test_fixed_point_histogram_is_exact_and_order_free(rng):
    n, f, b, nodes = 5000, 6, 16, 8
    binned = torch.from_numpy(rng.integers(0, b, size=(n, f), dtype=np.uint8))
    node = torch.from_numpy(rng.integers(0, nodes, size=n, dtype=np.int32))
    g = torch.from_numpy((rng.integers(-64, 65, size=n) / 64).astype(np.float32))  # exact in float64 sums
    h = torch.from_numpy((rng.integers(1, 65, size=n) / 64).astype(np.float32))
    ghq, kg, kh = gbt_hist.to_fixed(g, h)
    hist = gbt_hist.gbt_hist(binned, node, ghq, nodes, b)
    assert hist.shape == (nodes, f, b, 2) and hist.dtype == torch.int64
    want = np.zeros((nodes, f, b, 2))
    for j in range(f):
        np.add.at(want[..., 0], (node.numpy(), j, binned[:, j].numpy()), g.numpy().astype(np.float64))
        np.add.at(want[..., 1], (node.numpy(), j, binned[:, j].numpy()), h.numpy().astype(np.float64))
    np.testing.assert_array_equal(gbt_hist.from_fixed(hist[..., 0], kg).numpy(), want[..., 0])
    np.testing.assert_array_equal(gbt_hist.from_fixed(hist[..., 1], kh).numpy(), want[..., 1])
    perm = torch.from_numpy(rng.permutation(n))
    again = gbt_hist.gbt_hist(binned[perm].contiguous(), node[perm].contiguous(), ghq[:, perm].contiguous(), nodes, b)
    assert torch.equal(hist, again)
    slabs = gbt_hist.hist_plain(binned, node, ghq, nodes, b)  # one slab here; the slab loop below
    assert torch.equal(slabs, hist)


def test_plain_histogram_over_several_slabs(rng, monkeypatch):
    monkeypatch.setattr(gbt_hist, "_PLAIN_SLAB", 97)
    n, f, b = 1000, 3, 8
    binned = torch.from_numpy(rng.integers(0, b, size=(n, f), dtype=np.uint8))
    node = torch.from_numpy(rng.integers(0, 4, size=n, dtype=np.int32))
    ghq, _, _ = gbt_hist.to_fixed(torch.from_numpy(rng.normal(size=n).astype(np.float32)),
                                  torch.from_numpy(rng.random(n).astype(np.float32)))
    got = gbt_hist.hist_plain(binned, node, ghq, 4, b)
    want = torch.zeros(4 * f * b, 2, dtype=torch.int64)
    ids = (node[:, None].long() * f * b + torch.arange(f) * b + binned.long()).reshape(-1)
    want.index_add_(0, ids, ghq.t()[:, None, :].expand(n, f, 2).reshape(-1, 2))
    assert torch.equal(got, want.view(4, f, b, 2))


@pytest.mark.parametrize("n,top", [(1, 1.0), (5_000_000, 0.25), (5_000_000, 3e4), (1 << 20, 1e-30), (7, 0.0)])
def test_fixed_point_sums_stay_below_two_to_the_62(n, top):
    """round(x * 2^k) summed over n rows cannot reach 2^62, from the exact maximum."""
    a = torch.full((n,), top, dtype=torch.float32)
    k = int(gbt_hist.scale_exponent(a, n))
    q = torch.ldexp(a[:1].double(), torch.tensor(float(k))).round()
    assert float(q[0]) * n < 2.0 ** gbt_hist.SUM_BITS
    if top:
        assert float(q[0]) * n >= 2.0 ** (gbt_hist.SUM_BITS - 2)  # and no coarser than it must be


@pytest.mark.parametrize("n,f,b,nodes", [(5_000_000, 20, 64, 1), (5_000_000, 20, 64, 32), (17, 3, 8, 4),
                                         (1000, 200, 256, 16)])
def test_launch_plan_covers_every_pair_within_shared_memory(n, f, b, nodes):
    tile, rows, gx, gy, smem = gbt_hist.launch_plan(n, f, b, nodes, sm_count=132, smem_optin=232_448)
    assert tile * gy >= nodes * f > tile * (gy - 1)
    assert rows * gx >= n > rows * (gx - 1) and smem == tile * b * 16 <= gbt_hist.TILE_BYTES
    with pytest.raises(ValueError, match="bins need"):
        gbt_hist.launch_plan(n, f, 256, nodes, sm_count=132, smem_optin=2048)


def test_kernel_inputs_are_checked(rng):
    binned = torch.zeros((4, 2), dtype=torch.uint8)
    ghq = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="node_id"):
        gbt_hist.gbt_hist(binned, torch.zeros(4, dtype=torch.int64), ghq, 1, 4)
    with pytest.raises(ValueError, match="binned"):
        gbt_hist.gbt_hist(binned.int(), torch.zeros(4, dtype=torch.int32), ghq, 1, 4)
    with pytest.raises(ValueError, match="runs on the card"):
        gbt_hist.hist_launch(binned, torch.zeros(4, dtype=torch.int32), ghq, 1, 4)


@pytest.mark.parametrize("native_gbt", ["1", "0"])
def test_degenerate_inputs(rng, native_gbt, monkeypatch):
    """All-one-class labels: a dead root pushing toward the class; N smaller
    than the bins works; both trainers."""
    if native_gbt == "1":
        _native_or_skip()
    monkeypatch.setenv("VCTPU_NATIVE_GBT", native_gbt)
    x = rng.random((64, 3)).astype(np.float32)
    y = np.ones(64, dtype=np.float32)
    cfg = tb.BoostConfig(n_trees=3, depth=3, n_bins=8)
    forest = tb.fit(x, y, cfg=cfg, device="cpu")
    assert np.all(_port_score(forest, x) > 0.5)
    assert (forest.threshold[:, : (1 << 3) - 1] == np.inf).all()  # every split dead
    x2, y2 = _toy(rng, n=17, f=3)
    forest2 = tb.fit(x2, y2, cfg=cfg, device="cpu")
    assert np.isfinite(_port_score(forest2, x2)).all()
    jforest2 = jb.fit(x2, y2, cfg=jb.BoostConfig(n_trees=3, depth=3, n_bins=8))
    np.testing.assert_array_equal(forest2.feature, jforest2.feature)


def test_fit_learns_and_refuses_bad_edges(rng, monkeypatch):
    monkeypatch.setenv("VCTPU_NATIVE_GBT", "0")
    x, y = _toy(rng)
    forest = tb.fit(x, y, cfg=tb.BoostConfig(n_trees=30, depth=4, n_bins=32, learning_rate=0.3),
                    feature_names=[f"f{i}" for i in range(x.shape[1])], device="cpu")
    assert ((_port_score(forest, x) > 0.5) == (y > 0.5)).mean() > 0.85
    assert forest.aggregation == "logit_sum" and forest.feature_names == [f"f{i}" for i in range(6)]
    with pytest.raises(ValueError, match="bin edges"):
        tb.fit(x, y, cfg=tb.BoostConfig(n_bins=8), edges=np.zeros((6, 8), np.float32), device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        tb.fit(x, y, cfg=tb.BoostConfig(n_bins=300), device="cpu")
