"""The port's coverage reductions against the JAX package's, on the CPU.

``ops/coverage`` on torch tensors against ``variantcalling_tpu.ops.coverage``
on the same numpy inputs: window means bit for bit while every window sum
is below 2^24 (and within 1e-6 relative above it, where the port rounds the
exact sum once), histograms (masked and not) and interval histograms at
tolerance 0, percentiles exact (a differing entry only where the
reference's cdf lies within 1e-6 of q, counted), stats to 1e-6 relative,
interval masks and depth integration equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from variantcalling_tpu.ops import coverage as jcov
from variantcalling_tpu_torch.ops import coverage as tcov

QS = np.arange(0, 101, 5) / 100.0


def _depth(seed: int, n: int, mean: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.poisson(mean, n).astype(np.int32)
    d[rng.random(n) < 0.05] = 0
    d[rng.random(n) < 0.001] = 1500  # past the histogram's last bin
    return d


@pytest.mark.parametrize("window", [1, 7, 100, 1000, 10_000, 100_000, 250_000])
@pytest.mark.parametrize("n", [1, 999, 123_457])
def test_binned_mean_is_the_reference_bit_for_bit(n, window):
    d = _depth(n, n, 30.0)
    got = tcov.binned_mean(torch.from_numpy(d), window).numpy()
    want = np.asarray(jcov.binned_mean(jnp.asarray(d), window))
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_binned_mean_past_2_24():
    """Window sums above 2^24 (100 kb windows at depth 200): the port rounds
    the exact int64 sum once, the reference adds in float32; within 1e-6."""
    d = _depth(3, 1_000_003, 200.0)
    got = tcov.binned_mean(torch.from_numpy(d), 100_000).numpy()
    want = np.asarray(jcov.binned_mean(jnp.asarray(d), 100_000))
    exact = np.add.reduceat(d.astype(np.int64), np.arange(0, len(d), 100_000)) / np.minimum(
        100_000, len(d) - np.arange(0, len(d), 100_000))
    assert (exact[:-1] * 100_000 > 2 ** 24).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, exact, rtol=1e-7, atol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("max_depth", [1000, 50])
def test_depth_histogram_equals_the_reference(masked, max_depth):
    d = _depth(4, 200_001, 30.0)
    mask = np.random.default_rng(5).random(len(d)) < 0.3 if masked else None
    got = tcov.depth_histogram(torch.from_numpy(d), None if mask is None else torch.from_numpy(mask),
                               max_depth=max_depth).numpy()
    want = np.asarray(jcov.depth_histogram(jnp.asarray(d), None if mask is None else jnp.asarray(mask),
                                           max_depth=max_depth, method="bincount"))
    assert got.dtype == np.float32 and np.array_equal(got, want)


def _near_ties(hist: np.ndarray, got: np.ndarray, want: np.ndarray) -> int:
    """Entries that differ, each allowed only where the cdf at the depth one
    side picked, or the one before the other's, lies within 1e-6 of q as
    ``percentiles_from_histogram`` backs it off."""
    cdf = np.cumsum(hist.astype(np.float64)) / max(hist.sum(), 1.0)
    backed_off = np.maximum(np.float32(QS) * np.float32(1.0 - 1e-6), np.float32(1e-9)).astype(np.float64)
    n = 0
    for q, a, b in zip(backed_off, got, want):
        if a != b:
            lo = min(a, b)
            assert min(abs(cdf[lo] - q), abs(cdf[max(a, b) - 1] - q)) <= 1e-6, (q, a, b)
            n += 1
    return n


@pytest.mark.parametrize("seed,mean", [(6, 30.0), (7, 2.0), (8, 400.0), (9, 0.0)])
def test_percentiles_and_stats_equal_the_reference(seed, mean):
    d = _depth(seed, 300_000, mean) if mean else np.zeros(1000, np.int32)
    hist = np.array(jcov.depth_histogram(jnp.asarray(d), method="bincount"))
    got_p = tcov.percentiles_from_histogram(torch.from_numpy(hist), QS).numpy()
    want_p = np.asarray(jcov.percentiles_from_histogram(jnp.asarray(hist), QS))
    assert got_p.dtype == np.int32
    assert _near_ties(hist, got_p, want_p) == 0  # none at these sizes
    got = {k: float(v) for k, v in tcov.stats_from_histogram(torch.from_numpy(hist)).items()}
    want = {k: float(v) for k, v in jcov.stats_from_histogram(jnp.asarray(hist)).items()}
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=0), k
    assert got["median"] == want["median"]


def test_chr20_scale_histogram_counts_past_2_24():
    """A chr20-sized histogram (64,444,167 positions, Poisson(30), 3 M
    zeros): bins above 2^24 round on both sides alike; stats to 1e-6."""
    rng = np.random.default_rng(20)
    hist = np.bincount(np.minimum(rng.poisson(30, 61_444_167), 1000), minlength=1001).astype(np.float32)
    hist[0] += 3_000_000
    got_p = tcov.percentiles_from_histogram(torch.from_numpy(hist), QS).numpy()
    want_p = np.asarray(jcov.percentiles_from_histogram(jnp.asarray(hist), QS))
    print("near ties", _near_ties(hist, got_p, want_p))
    got = {k: float(v) for k, v in tcov.stats_from_histogram(torch.from_numpy(hist)).items()}
    want = {k: float(v) for k, v in jcov.stats_from_histogram(jnp.asarray(hist)).items()}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=0), k


def test_interval_histograms_equal_the_reference():
    d = _depth(10, 40_000, 20.0)
    masks = np.random.default_rng(11).random((3, len(d))) < np.array([[0.1], [0.5], [1.0]])
    got = tcov.interval_histograms(torch.from_numpy(d), torch.from_numpy(masks)).numpy()
    want = np.asarray(jcov.interval_histograms(jnp.asarray(d), jnp.asarray(masks)))
    assert got.shape == (3, tcov.MAX_DEPTH_BIN + 1) and np.array_equal(got, want)


@pytest.mark.parametrize("length", [1, 100, 10_000])
def test_mask_from_intervals_equals_the_reference(length):
    rng = np.random.default_rng(length)
    starts = np.sort(rng.integers(-5, length + 5, 40))
    ends = starts + rng.integers(0, max(2, length // 10), 40)
    got = tcov.mask_from_intervals(length, starts, ends, device="cpu").numpy()
    assert np.array_equal(got, jcov.mask_from_intervals(length, starts, ends))


def test_depth_from_diff_is_the_int32_cumsum():
    diff = np.random.default_rng(12).integers(-3, 4, 10_001).astype(np.int32)
    got = tcov.depth_from_diff(torch.from_numpy(diff))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.cumsum(diff[:-1], dtype=np.int32))
