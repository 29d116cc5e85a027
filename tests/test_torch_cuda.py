"""The forest kernels on the card against their plain versions, bit for bit.

Needs a CUDA device, nvcc and the kernel's build; skips without a device.
Imports only the port (no JAX), so it runs on the machine with the card:
``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from variantcalling_tpu_torch.models import forest as fmod
from variantcalling_tpu_torch.models import forest_cuda
from variantcalling_tpu_torch.synthetic import synthetic_forest


@pytest.mark.cuda
@pytest.mark.parametrize("depth,n_trees,dleft", [
    (3, 7, False), (7, 100, False), (9, 10, False), (7, 9, False), (7, 100, True), (9, 10, True),
    (9, 100, True),  # 100 trees of 256 leaves: over the shared memory, streamed in chunks
    (12, 10, False),  # 10 trees of 2,048 leaves (explicit wide): chunks cut inside a group of four
])
@pytest.mark.parametrize("n", [1, 513, 70_001])
def test_kernel_matches_plain_version_on_card(depth, n_trees, dleft, n):
    """The wide kernel, with and without default_left (NaN inputs only with it),
    on forests resident in shared memory and on one that streams in chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(depth * 1000 + n)
    forest = synthetic_forest(rng, n_trees=n_trees, depth=depth, n_features=19)
    x = rng.uniform(0, 50, (n, 19)).astype(np.float32)
    if dleft:
        forest.default_left = (rng.random(forest.feature.shape) < 0.5) & (forest.feature != fmod.LEAF)
        x[rng.random(x.shape) < 0.1] = np.nan
    kernel = forest_cuda.WideForestKernel(forest, 19, "cuda")
    if (depth, n_trees) in ((9, 100), (12, 10)):
        assert kernel.tables.n_chunks > 1
    xt = torch.from_numpy(x).cuda()
    before = forest_cuda.LAUNCHES
    got = kernel(xt)
    torch.cuda.synchronize()
    assert forest_cuda.LAUNCHES == before + 1
    assert torch.equal(got, kernel.plain(xt))
    assert torch.equal(got, fmod.predict_margin(forest, xt))


@pytest.mark.cuda
@pytest.mark.parametrize("depths,dleft", [((7, 14, 7), True), ((16, 9), False)])
@pytest.mark.parametrize("n", [1, 513, 70_001])
def test_wide_kernel_walks_large_trees_from_device_memory(depths, dleft, n):
    """Trees past the chunk buffers (16,383 and 65,535 nodes) under an explicit
    ``wide``: global chunks, bit for bit the gather walk on the card (the
    plain version's wide encoding would take gigabytes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(sum(depths) * 1000 + n)
    parts = [synthetic_forest(rng, n_trees=2, depth=d, n_features=19) for d in depths]
    m = max(pt.feature.shape[1] for pt in parts)
    arrays = {k: np.concatenate([np.pad(getattr(pt, k), ((0, 0), (0, m - pt.feature.shape[1])),
                                        constant_values=fmod.LEAF if k == "feature" else 0) for pt in parts])
              for k in ("feature", "threshold", "left", "right", "value")}
    forest = fmod.FlatForest(**arrays, max_depth=max(depths))
    x = rng.uniform(0, 50, (n, 19)).astype(np.float32)
    if dleft:
        forest.default_left = (rng.random(forest.feature.shape) < 0.5) & (forest.feature != fmod.LEAF)
        x[rng.random(x.shape) < 0.1] = np.nan
    kernel = forest_cuda.WideForestKernel(forest, 19, "cuda")
    assert kernel.tables.chunk_global.any()
    xt = torch.from_numpy(x).cuda()
    before = forest_cuda.LAUNCHES
    got = kernel(xt)
    torch.cuda.synchronize()
    assert forest_cuda.LAUNCHES == before + 1
    assert torch.equal(got, fmod.predict_margin(forest, xt))


@pytest.mark.cuda
@pytest.mark.parametrize("depth,n_trees,dleft", [(3, 7, False), (7, 100, False), (7, 100, True), (9, 10, True),
                                                 (11, 3, False), (11, 2, True), (1, 3, False), (12, 2, True)])
@pytest.mark.parametrize("n", [1, 513, 70_001])
def test_tree_step_kernel_matches_plain_version_on_card(depth, n_trees, dleft, n):
    """The per-tree kernel, with and without default_left (NaN inputs only with
    it), from stumps up to trees of 2,048 leaves (32 passes of 64 leaves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(depth * 1000 + n)
    forest = synthetic_forest(rng, n_trees=n_trees, depth=depth, n_features=19)
    x = rng.uniform(0, 50, (n, 19)).astype(np.float32)
    if dleft:
        forest.default_left = (rng.random(forest.feature.shape) < 0.5) & (forest.feature != fmod.LEAF)
        x[rng.random(x.shape) < 0.1] = np.nan
    kernel = forest_cuda.TreeStepKernel(fmod.to_gemm(forest, 19), "cuda")
    xt = torch.from_numpy(x).cuda()
    before = forest_cuda.TREE_STEP_LAUNCHES
    got = kernel(xt)
    torch.cuda.synchronize()
    assert forest_cuda.TREE_STEP_LAUNCHES == before + 1
    assert torch.equal(got, kernel.plain(xt))
    assert torch.equal(got, fmod.predict_margin(forest, xt))
