"""The forest kernels for Hopper: their wrappers, launch counts and plain versions.

Two hand-written CUDA C++ kernels, each beside its plain torch version
(what a CPU tensor gets; a CUDA tensor goes to the kernel or raises) and
its own launch counter.

**The wide-block kernel** (``csrc/forest_wide.cu``, :class:`WideForestKernel`,
count :data:`LAUNCHES`) replaces the Pallas kernel ``_wide_block_kernel``
(``variantcalling_tpu/models/forest_pallas.py:105``), launched by
``make_wide_pallas_margin_predictor``. That kernel computes, per 512-row
tile and block of G trees, the one-hot feature pick ``x @ a``, the
compare with ``thr``, the block-diagonal routing ``d @ m2 + c``, the leaf
match ``== plen`` and each tree's leaf value; the ascending tree sum runs
outside it. The CUDA kernel computes the same function without the
contractions, from compact per-node tables that the wrapper builds once
from the forest's node arrays (:func:`compact_tables`): per internal node
its feature index, its threshold and its two children (small signed ints:
>= 0 an internal node, < 0 the leaf ``~child``), packed G trees to a block
as :func:`forest.to_wide` packs them. Walking a tree from its root reaches
the one leaf whose ``d @ m2 + c == plen`` in the wide encoding. Its plain
version is :func:`wide_margin_plain`.

**The per-tree kernel** (``csrc/forest_tree_step.cu``, :class:`TreeStepKernel`,
count :data:`TREE_STEP_LAUNCHES`) replaces the Pallas kernel
``_tree_step_kernel`` (``forest_pallas.py:51``), launched by
``_margin_pallas`` and driven by ``make_gemm_pallas_predictor``: per tile
and tree, trees innermost, the same chain for one tree and ``out += hit @
value``. The CUDA kernel keeps that formulation with bits for products:
it decides every internal node of a tree into a bitmask ``d`` and tests
every leaf with two masks (:func:`tree_step_tables`, built from the
:class:`GemmForest`'s ``m2`` and ``plen``), ``(d & lmask) == lmask and
(d & rmask) == 0`` — exactly ``d @ m2 + c == plen``. It also takes the
default-left table, deciding a NaN feature by the node's default as the
reference's ``predict_margin_gemm`` does. Its plain version is
:func:`forest.predict_margin_gemm`.

Both kernels read ``x[row, feat]`` exactly — no TF32 product, no
``torch.matmul`` — and add each tree's leaf value to one float32
accumulator per row in ascending tree order, writing (N,) margins.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from variantcalling_tpu_torch.models.forest import (LEAF, FlatForest, GemmForest, WideGemmForest,
                                                   _device_finalize, predict_margin_gemm,
                                                   resolved_tree_block, sequential_tree_sum, to_gemm,
                                                   to_wide)

#: launches of the wide-block kernel in this process (the wrapper adds one per launch)
LAUNCHES = 0
#: launches of the per-tree kernel in this process (the wrapper adds one per launch)
TREE_STEP_LAUNCHES = 0

_LIBS: dict[str, ctypes.CDLL] = {}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # x, n, f, nodes, leaf_val, roots, b, g, i, l, t, out, stream
    "forest_wide": ("forest_wide_margin", [_P, _LL, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]),
    # x, n, f, nodes, dleft, masks, values, t, i, l, w, out, stream
    "forest_tree_step": ("forest_tree_step_margin", [_P, _LL, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P]),
}


def _lib(name: str):
    """The C entry point of ``csrc/<name>.cu``, built and loaded at first use."""
    if name not in _LIBS:
        from variantcalling_tpu_torch.csrc import build

        _LIBS[name] = ctypes.CDLL(str(build.build(name)))
        fn_name, argtypes = _SIGNATURES[name]
        fn = getattr(_LIBS[name], fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return getattr(_LIBS[name], _SIGNATURES[name][0])


def _check_input(x: torch.Tensor, n_features: int, table: torch.Tensor, what: str) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != n_features:
        raise ValueError(f"{what}: expected float32 (N, {n_features}), got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if table.device != x.device:
        raise ValueError(f"{what}: tables on {table.device}, x on {x.device}")


def compact_tables(forest: FlatForest, tree_block: int | None = None
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(nodes int32 (B, G*I, 4), leaf values f32 (B, G*L), roots int32 (B*G,), G).

    Built straight from the forest's node arrays: each tree's reachable
    internal nodes are renumbered 0..I-1 and its reachable leaves 0..L-1
    in node order. A node row is [feature, threshold bits, left child,
    right child]; a child >= 0 is an internal node of the same tree, < 0
    the leaf ``~child``. Trees are packed G to a block as :func:`to_wide`
    packs them; padded trees past T and padded node rows are never walked.
    """
    feat, left, right = forest.feature, forest.left, forest.right
    t, m = feat.shape
    internal = feat != LEAF
    reach = np.zeros((t, m), dtype=bool)
    reach[:, 0] = True
    frontier = reach & internal
    while frontier.any():
        ti, ni = np.nonzero(frontier)
        kids = np.zeros_like(reach)
        kids[ti, left[ti, ni]] = True
        kids[ti, right[ti, ni]] = True
        frontier = kids & ~reach & internal
        reach |= kids
    is_int, is_leaf = reach & internal, reach & ~internal
    code = np.where(internal, np.cumsum(is_int, axis=1) - 1, ~(np.cumsum(is_leaf, axis=1) - 1))
    n_int = max(1, int(is_int.sum(axis=1).max()))
    n_leaf = int(is_leaf.sum(axis=1).max())
    g = resolved_tree_block(n_int, t, tree_block)
    b = -(-t // g)
    nodes = np.zeros((b * g, n_int, 4), dtype=np.int32)
    nodes[:, :, 2:] = ~0
    ti, ni = np.nonzero(is_int)
    k = code[ti, ni]
    nodes[ti, k, 0] = feat[ti, ni]
    nodes[ti, k, 1] = forest.threshold[ti, ni].astype(np.float32).view(np.int32)
    nodes[ti, k, 2] = code[ti, left[ti, ni]]
    nodes[ti, k, 3] = code[ti, right[ti, ni]]
    leaf_val = np.zeros((b * g, n_leaf), dtype=np.float32)
    ti, ni = np.nonzero(is_leaf)
    leaf_val[ti, ~code[ti, ni]] = forest.value[ti, ni]
    roots = np.full(b * g, ~0, dtype=np.int32)
    roots[:t] = code[:, 0]
    return nodes.reshape(b, g * n_int, 4), leaf_val.reshape(b, g * n_leaf), roots, g


def predict_pertree_margin_wide(wf: WideGemmForest, x: torch.Tensor) -> torch.Tensor:
    """(N, T) per-tree leaf margins via the wide formulation, in plain torch.

    The one-hot feature pick is an index gather (exact; an all-zero padded
    column picks 0) — a float32 one-hot product would be exact only with TF32
    off, and even then turns a NaN or inf anywhere in a row into NaN for every
    node; the pipeline's features are finite. The routing product ``d @ m2`` has operands in
    {-1, 0, 1} and sums of at most the tree depth, exact in float32 and in
    TF32 alike. The leaf pick multiplies a 0/1 match by the leaf values;
    every term but one is zero, so the per-tree value is exact in any order.
    """
    dev = x.device
    n = x.shape[0]
    b, g = wf.n_blocks, wf.tree_block
    n_leaf = wf.value.shape[2]
    a = torch.as_tensor(wf.a, device=dev)  # (B, F, G*I)
    has = a.ne(0).any(dim=1)  # (B, G*I)
    feat = a.argmax(dim=1)
    thr = torch.as_tensor(wf.thr, device=dev)
    m2 = torch.as_tensor(wf.m2, device=dev)
    c = torch.as_tensor(wf.c, device=dev)
    plen = torch.as_tensor(wf.plen, device=dev)
    value = torch.as_tensor(wf.value, device=dev)
    out = torch.empty((n, b * g), dtype=torch.float32, device=dev)
    for bi in range(b):
        xf = torch.where(has[bi], x[:, feat[bi]], torch.zeros((), device=dev))
        d = (xf <= thr[bi]).to(torch.float32)
        match = d @ m2[bi] + c[bi]
        hit = (match == plen[bi]).to(torch.float32).view(n, g, n_leaf)
        out[:, bi * g:(bi + 1) * g] = (hit * value[bi]).sum(dim=2)
    return out[:, :wf.n_trees]


def wide_margin_plain(wf: WideGemmForest, x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: per-tree margins reduced in ascending tree order."""
    return sequential_tree_sum(predict_pertree_margin_wide(wf, x))


class WideForestKernel:
    """fn(x) -> (N,) margins for one forest, through the wide-block kernel.

    The compact tables are built once, on ``device``. A CPU tensor is scored
    by the plain version over the forest's wide encoding (built on first
    use); a CUDA tensor launches the kernel.
    """

    def __init__(self, forest: FlatForest, n_features: int, device: torch.device | str,
                 tree_block: int | None = None):
        if forest.default_left is not None:
            raise NotImplementedError("the wide forest kernel does not implement default_left routing")
        self.forest = forest
        self.n_features = n_features
        nodes, leaf_val, roots, self.tree_block = compact_tables(forest, tree_block)
        if int(nodes[:, :, 0].max()) >= n_features:
            raise ValueError(f"forest reads feature {int(nodes[:, :, 0].max())} of {n_features}")
        self.n_blocks = nodes.shape[0]
        self.n_int = nodes.shape[1] // self.tree_block
        self.n_leaf = leaf_val.shape[1] // self.tree_block
        device = torch.device(device)
        self.nodes = torch.from_numpy(nodes).to(device)
        self.leaf_val = torch.from_numpy(leaf_val).to(device)
        self.roots = torch.from_numpy(roots).to(device)
        self._wide: WideGemmForest | None = None

    def wide(self) -> WideGemmForest:
        """The forest's wide encoding, with the kernel's tree block."""
        if self._wide is None:
            self._wide = to_wide(to_gemm(self.forest, self.n_features), self.tree_block)
        return self._wide

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel's plain version on ``x``, on whatever device ``x`` lives on."""
        return wide_margin_plain(self.wide(), x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return self.plain(x)
        if x.device.type != "cuda":
            raise ValueError(f"forest kernel: unsupported device {x.device}")
        return self.launch(x)

    def launch(self, x: torch.Tensor) -> torch.Tensor:
        global LAUNCHES
        _check_input(x, self.n_features, self.nodes, "forest kernel")
        n = x.shape[0]
        out = torch.empty(n, dtype=torch.float32, device=x.device)
        if n == 0:
            return out
        fn = _lib("forest_wide")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(
                x.data_ptr(), n, self.n_features, self.nodes.data_ptr(), self.leaf_val.data_ptr(),
                self.roots.data_ptr(), self.n_blocks, self.tree_block, self.n_int, self.n_leaf,
                self.forest.n_trees, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"forest_wide_margin failed: cudaError_t {err}")
        LAUNCHES += 1
        return out


def tree_step_tables(gf: GemmForest) -> tuple[np.ndarray, np.ndarray | None, np.ndarray, np.ndarray]:
    """The per-tree kernel's tables, built from a :class:`GemmForest`.

    Returns (nodes int32 (T, I, 2), dleft uint32 (T, W) or None, masks
    uint32 (T, L, 2, W), values float32 (T, L)) with W = ceil(I / 32). A
    node row is [feature index (``a``'s one-hot row; 0 for a padded column,
    which no mask reads), threshold bits]. Bit k of word k // 32 stands for
    internal node k: in ``dleft`` its default branch, in a leaf's ``lmask``
    a node on its left path (``m2 == 1``), in ``rmask`` one on its right
    path (``m2 == -1``). A padded leaf (``plen == -1``) gets bit 0 in both
    masks, which no ``d`` satisfies.
    """
    t, _, i = gf.a.shape
    w = -(-i // 32)

    def pack(bits: np.ndarray) -> np.ndarray:  # (..., I) bool -> (..., W) uint32
        padded = np.zeros(bits.shape[:-1] + (w * 32,), dtype=bool)
        padded[..., :i] = bits
        return np.packbits(padded, axis=-1, bitorder="little").view("<u4").astype(np.uint32)

    nodes = np.stack([gf.a.argmax(axis=1).astype(np.int32),
                      gf.thr.astype(np.float32).view(np.int32)], axis=2)
    route = gf.m2.transpose(0, 2, 1)  # (T, L, I)
    lmask, rmask = pack(route == 1.0), pack(route == -1.0)
    padded_leaf = gf.plen < 0
    lmask[padded_leaf, 0] |= 1
    rmask[padded_leaf, 0] |= 1
    dleft = None if gf.dleft is None else pack(gf.dleft > 0.5)
    return nodes, dleft, np.stack([lmask, rmask], axis=2), gf.value.astype(np.float32)


class TreeStepKernel:
    """fn(x) -> (N,) margins for one forest, through the per-tree kernel.

    The tables are built once from ``gf``, on ``device``. A CPU tensor is
    scored by the plain version (:func:`forest.predict_margin_gemm`); a
    CUDA tensor launches the kernel.
    """

    def __init__(self, gf: GemmForest, device: torch.device | str):
        self.gf = gf
        self.n_features = gf.a.shape[1]
        nodes, dleft, masks, values = tree_step_tables(gf)
        self.n_trees, self.n_int = nodes.shape[:2]
        self.n_leaf, self.n_words = masks.shape[1], masks.shape[3]
        device = torch.device(device)
        self.nodes = torch.from_numpy(nodes).to(device)
        self.dleft = None if dleft is None else torch.from_numpy(dleft.view(np.int32)).to(device)
        self.masks = torch.from_numpy(masks.view(np.int32)).to(device)
        self.values = torch.from_numpy(values).to(device)

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel's plain version on ``x``, on whatever device ``x`` lives on."""
        return predict_margin_gemm(self.gf, x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return self.plain(x)
        if x.device.type != "cuda":
            raise ValueError(f"per-tree forest kernel: unsupported device {x.device}")
        return self.launch(x)

    def launch(self, x: torch.Tensor) -> torch.Tensor:
        global TREE_STEP_LAUNCHES
        _check_input(x, self.n_features, self.nodes, "per-tree forest kernel")
        n = x.shape[0]
        out = torch.empty(n, dtype=torch.float32, device=x.device)
        if n == 0:
            return out
        fn = _lib("forest_tree_step")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), n, self.n_features, self.nodes.data_ptr(),
                     None if self.dleft is None else self.dleft.data_ptr(), self.masks.data_ptr(),
                     self.values.data_ptr(), self.n_trees, self.n_int, self.n_leaf, self.n_words,
                     out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"forest_tree_step_margin failed: cudaError_t {err} (trees of "
                               f"{self.n_int} internal nodes and {self.n_leaf} leaves)")
        TREE_STEP_LAUNCHES += 1
        return out


def make_gemm_cuda_predictor(gf: GemmForest, device: torch.device | str):
    """fn(x) -> scores for a GemmForest through the per-tree kernel, with the
    finalize on the device (mean: ``total / n_trees``; logit_sum:
    ``sigmoid(total + base)``): the counterpart of the reference's
    ``make_gemm_pallas_predictor``.

    Like it, refuses forests with missing-value routing (ValueError); the
    filter pipeline scores those through :class:`TreeStepKernel` itself,
    and finalizes margins on the host.
    """
    if gf.dleft is not None:
        raise ValueError("the per-tree forest predictor does not implement default_left routing")
    kernel = TreeStepKernel(gf, device)
    n_trees = gf.m2.shape[0]
    return lambda x: _device_finalize(kernel(x), gf.aggregation, n_trees, gf.base_score)
