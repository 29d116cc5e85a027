"""The wide-block forest kernel for Hopper: its wrapper, launch count and plain version.

Replaces the Pallas kernel ``_wide_block_kernel``
(``variantcalling_tpu/models/forest_pallas.py:105``), launched by
``make_wide_pallas_margin_predictor``. That kernel computes, per 512-row
tile and block of G trees, the one-hot feature pick ``x @ a``, the
compare with ``thr``, the block-diagonal routing ``d @ m2 + c``, the leaf
match ``== plen`` and each tree's leaf value; the ascending tree sum runs
outside it.

The CUDA kernel (``csrc/forest_wide.cu``) computes the same function
without the contractions, from compact per-node tables that the wrapper
builds once from the forest's node arrays (:func:`compact_tables`): per
internal node its feature index, its threshold and its two children
(small signed ints: >= 0 an internal node, < 0 the leaf ``~child``),
packed G trees to a block as :func:`forest.to_wide` packs them. Walking a
tree from its root reaches the one leaf whose ``d @ m2 + c == plen`` in
the wide encoding. The kernel reads ``x[row, feat]`` exactly — no TF32
product, no ``torch.matmul`` — and adds each tree's leaf value to one
float32 accumulator per row in ascending tree order, writing (N,)
margins. Padded trees past T and rows past N are never touched.

The plain version (:func:`predict_pertree_margin_wide`) keeps the
reference's formulation in torch and is what a CPU tensor gets; a CUDA
tensor goes to the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from variantcalling_tpu_torch.models.forest import (LEAF, FlatForest, WideGemmForest, resolved_tree_block,
                                                   sequential_tree_sum, to_gemm, to_wide)

#: launches of the CUDA kernel in this process (the wrapper adds one per launch)
LAUNCHES = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from variantcalling_tpu_torch.csrc import build

        lib = ctypes.CDLL(str(build.build("forest_wide")))
        lib.forest_wide_margin.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,  # x, n, f
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # nodes, leaf_val, roots
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # b, g, i, l, t
            ctypes.c_void_p, ctypes.c_void_p]  # out, stream
        lib.forest_wide_margin.restype = ctypes.c_int
        _LIB = lib
    return _LIB


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
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != self.n_features:
            raise ValueError(f"forest kernel: expected float32 (N, {self.n_features}), "
                             f"got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("forest kernel: x must be contiguous")
        if self.nodes.device != x.device:
            raise ValueError(f"forest kernel: tables on {self.nodes.device}, x on {x.device}")
        n = x.shape[0]
        out = torch.empty(n, dtype=torch.float32, device=x.device)
        if n == 0:
            return out
        lib = _lib()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.forest_wide_margin(
                x.data_ptr(), n, self.n_features, self.nodes.data_ptr(), self.leaf_val.data_ptr(),
                self.roots.data_ptr(), self.n_blocks, self.tree_block, self.n_int, self.n_leaf,
                self.forest.n_trees, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"forest_wide_margin failed: cudaError_t {err}")
        LAUNCHES += 1
        return out
