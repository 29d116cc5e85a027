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
contractions, by walking each tree from its root over 8-byte node records
that the wrapper builds once from the forest's node arrays
(:func:`compact_tables`): per internal node its threshold, feature index,
default-left bit and the slot of its first child, the two children
adjacent; per leaf its value. The walk reaches the one leaf whose
``d @ m2 + c == plen`` in the wide encoding; a NaN feature takes the
node's default branch (the reference's NaN mask), or the right branch
without ``default_left``. The records of the whole forest, or of one chunk
of trees at a time, sit in shared memory (:class:`WideTables`). Its plain
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
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from variantcalling_tpu_torch.models.forest import (LEAF, FlatForest, GemmForest, WideGemmForest,
                                                   _device_finalize, predict_margin_gemm,
                                                   sequential_tree_sum, to_gemm, to_wide)

#: launches of the wide-block kernel in this process (the wrapper adds one per launch)
LAUNCHES = 0
#: launches of the per-tree kernel in this process (the wrapper adds one per launch)
TREE_STEP_LAUNCHES = 0

_LIBS: dict[str, ctypes.CDLL] = {}
#: (SM count, opt-in shared memory per block) by device index
_LIMITS: dict[int, tuple[int, int]] = {}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C entry point -> (kernel source, argument types)
_ENTRIES = {
    # sm_count*, smem_optin*
    "forest_wide_prepare": ("forest_wide", [_P, _P]),
    # x, n, f, records, tree_info, chunk_tree, chunk_rec, chunks, chunk_records, rows, grid, smem, out, stream
    "forest_wide_margin": ("forest_wide", [_P, _LL, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]),
    # x, n, f, nodes, dleft, masks, values, t, i, l, w, out, stream
    "forest_tree_step_margin": ("forest_tree_step",
                                [_P, _LL, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P]),
}


def _entry(fn_name: str):
    """The C entry point ``fn_name``, its source built and loaded at first use."""
    name = _ENTRIES[fn_name][0]
    if name not in _LIBS:
        from variantcalling_tpu_torch.csrc import build

        lib = ctypes.CDLL(str(build.build(name)))
        for entry, (source, argtypes) in _ENTRIES.items():
            if source == name:
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        _LIBS[name] = lib
    return getattr(_LIBS[name], fn_name)


def _check_input(x: torch.Tensor, n_features: int, tables_on: torch.device, what: str) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != n_features:
        raise ValueError(f"{what}: expected float32 (N, {n_features}), got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if tables_on != x.device:
        raise ValueError(f"{what}: tables on {tables_on}, x on {x.device}")


#: shared memory one block may hold on sm_90 (227 KB): the wide kernel's
#: budget for the forest and two feature tiles
SMEM_BYTES = 232_448
#: rows a block of the wide kernel scores at once, one thread each, at most
MAX_TILE_ROWS = 512
#: trees each thread of the wide kernel walks at once (``kTrees`` in its source)
TREES_AT_ONCE = 4
#: a record's 15-bit feature index and 15-bit child slot
_MAX_FIELD = 0x7FFF
#: the most nodes a tree may have on the card: a chunk buffer holds at least
#: a quarter of :data:`SMEM_BYTES` whatever the feature count (the feature
#: tiles take at most half, and two buffers share the rest)
MAX_TREE_NODES = SMEM_BYTES // 32


@dataclass
class WideTables:
    """The wide-block kernel's tables, built by :func:`compact_tables`.

    ``records`` int32 (S, 2): one 8-byte record per tree slot. An internal
    node is [threshold bits, ``first << 16 | default_left << 15 | feature``]
    and its children sit in slots ``first`` (left) and ``first + 1`` (right)
    of the same tree. A leaf is [value bits, ``slot << 16 | 1 << 15 |
    n_features``]: its feature is the kernel's extra feature row of -inf and
    its ``first`` its own slot, so that a step from a leaf stays on it. Each
    tree's slots run root first, breadth first. The trees are cut into
    chunks of whole trees: chunk ``c`` holds trees
    ``chunk_tree[c]:chunk_tree[c + 1]`` in records
    ``chunk_rec[c]:chunk_rec[c + 1]`` (an even count: 16-byte copies);
    ``tree_off[t]`` is tree t's root slot counted from its chunk's first
    record, and ``depth[t]`` its internal levels (the steps a walk takes).
    ``node`` int32 (S,) names the forest node each slot holds (-1: padding).
    """

    records: np.ndarray
    tree_off: np.ndarray
    depth: np.ndarray
    chunk_tree: np.ndarray
    chunk_rec: np.ndarray
    node: np.ndarray

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_tree) - 1

    @cached_property
    def chunk_records(self) -> int:
        """Records of the largest chunk: the size of one shared-memory buffer."""
        return int(np.diff(self.chunk_rec).max())

    def smem_bytes(self, n_features: int, rows: int) -> int:
        """Shared memory of one block: the forest (one buffer when it is one
        chunk, else two that alternate) and two feature tiles of ``rows`` rows,
        each with the leaves' extra row."""
        buffers = 1 if self.n_chunks == 1 else 2
        return buffers * self.chunk_records * 8 + 2 * (n_features + 1) * rows * 4


def tile_rows(n_features: int) -> int:
    """The most rows a block scores at once: two feature tiles take at most
    half of :data:`SMEM_BYTES`, leaving the rest to the forest."""
    rows = MAX_TILE_ROWS
    while 2 * (n_features + 1) * rows * 4 > SMEM_BYTES // 2:
        rows //= 2
        if rows < 32:
            raise ValueError(f"wide forest kernel: {n_features} features per row do not fit a 32-row tile")
    return rows


def launch_shape(n: int, sm_count: int, rows_max: int) -> tuple[int, int]:
    """(rows per tile, blocks) for ``n`` rows: a persistent grid of at most one
    block per SM, with the tile cut (to a multiple of 32 rows) so that the
    tiles come out close to a whole number of rounds over the SMs."""
    rounds = -(-n // (sm_count * rows_max))
    per_tile = -(-n // (sm_count * rounds))
    rows = min(rows_max, -(-per_tile // 32) * 32)
    return rows, min(-(-n // rows), sm_count)


def compact_tables(forest: FlatForest, n_features: int, smem_bytes: int = SMEM_BYTES) -> WideTables:
    """The wide kernel's 8-byte-record tables (:class:`WideTables`), built
    straight from the forest's node arrays.

    Each tree's reachable nodes are numbered breadth first from the root,
    so that every internal node's two children take adjacent slots. The
    trees stay one chunk when they fit the shared memory that two feature
    tiles leave (:func:`tile_rows`); otherwise they are cut, in order, into
    chunks of at most half of it, between the kernel's groups of
    :data:`TREES_AT_ONCE` trees where a group fits a chunk and between
    single trees where it does not. Raises ValueError where the forest reads
    a feature past ``n_features``, a field of the record would overflow or
    a tree does not fit a chunk.
    """
    feat, left, right = forest.feature, forest.left, forest.right
    t, m = feat.shape
    internal = feat != LEAF
    slot = np.full((t, m), -1, dtype=np.int64)
    first = np.zeros((t, m), dtype=np.int64)
    slot[:, 0] = 0
    n_slots = np.ones(t, dtype=np.int64)
    depth = np.zeros(t, dtype=np.int32)
    ti, ni = np.arange(t), np.zeros(t, dtype=np.int64)  # one level, sorted by (tree, slot)
    for _ in range(m):
        keep = internal[ti, ni]
        ti, ni = ti[keep], ni[keep]
        if not len(ti):
            break
        depth[np.unique(ti)] += 1
        rank = np.arange(len(ti)) - np.searchsorted(ti, ti)
        f0 = n_slots[ti] + 2 * rank
        first[ti, ni] = f0
        slot[ti, left[ti, ni]] = f0
        slot[ti, right[ti, ni]] = f0 + 1
        n_slots += 2 * np.bincount(ti, minlength=t)
        ti, ni = np.repeat(ti, 2), np.stack([left[ti, ni], right[ti, ni]], axis=1).reshape(-1)
    ti, ni = np.nonzero(slot >= 0)
    inner = internal[ti, ni]
    reads = int(feat[ti, ni][inner].max()) if inner.any() else -1
    if reads >= n_features:
        raise ValueError(f"forest reads feature {reads} of {n_features}")
    if n_features > _MAX_FIELD:  # the leaves' feature is n_features itself
        raise ValueError(f"wide forest kernel: feature index {n_features} overflows the record's "
                         f"{_MAX_FIELD.bit_length()}-bit field")
    if int(n_slots.max()) - 1 > _MAX_FIELD:
        raise ValueError(f"wide forest kernel: a tree of {int(n_slots.max())} nodes overflows the "
                         f"record's child slot (at most {_MAX_FIELD + 1} nodes a tree)")
    dleft = np.zeros((t, m), dtype=bool) if forest.default_left is None else forest.default_left
    word = (first[ti, ni] << 16) | (dleft[ti, ni].astype(np.int64) << 15) | feat[ti, ni]
    per_tree = np.zeros((t, int(n_slots.max()), 2), dtype=np.int32)
    per_tree[ti, slot[ti, ni], 0] = np.where(inner, forest.threshold[ti, ni], forest.value[ti, ni]) \
        .astype(np.float32).view(np.int32)
    leaf_word = (slot[ti, ni] << 16) | (1 << 15) | n_features
    per_tree[ti, slot[ti, ni], 1] = np.where(inner, word, leaf_word)
    node_of = np.full(per_tree.shape[:2], -1, dtype=np.int32)
    node_of[ti, slot[ti, ni]] = ni

    # the chunks: whole trees in order; one chunk if the forest fits beside the feature tiles
    budget = (smem_bytes - 2 * (n_features + 1) * tile_rows(n_features) * 4) // 8
    cap = budget if int(n_slots.sum()) + 1 <= budget else budget // 4 * 2  # even: 16-byte copies
    if int(n_slots.max()) > cap:
        raise ValueError(f"wide forest kernel: a tree of {int(n_slots.max())} nodes does not fit a "
                         f"chunk of {cap} records")
    chunk_tree, tree_off, used = [0], np.zeros(t, dtype=np.int32), 0
    for k0 in range(0, t, TREES_AT_ONCE):
        if used and used + int(n_slots[k0:k0 + TREES_AT_ONCE].sum()) > cap:  # a new chunk for the group
            chunk_tree.append(k0)
            used = 0
        for k in range(k0, min(k0 + TREES_AT_ONCE, t)):
            if used + int(n_slots[k]) > cap:  # a group larger than a chunk is cut inside
                chunk_tree.append(k)
                used = 0
            tree_off[k] = used
            used += int(n_slots[k])
    chunk_tree.append(t)
    chunk_of = np.repeat(np.arange(len(chunk_tree) - 1), np.diff(chunk_tree))
    ends = tree_off + n_slots
    sizes = np.asarray([ends[chunk_tree[c + 1] - 1] for c in range(len(chunk_tree) - 1)])
    chunk_rec = np.concatenate([[0], np.cumsum(sizes + sizes % 2)]).astype(np.int32)
    start = chunk_rec[chunk_of] + tree_off  # each tree's first record in the whole table
    live = np.arange(per_tree.shape[1])[None, :] < n_slots[:, None]
    at = (start[:, None] + np.arange(per_tree.shape[1])[None, :])[live]
    records = np.zeros((int(chunk_rec[-1]), 2), dtype=np.int32)
    records[at] = per_tree[live]
    node = np.full(len(records), -1, dtype=np.int32)
    node[at] = node_of[live]
    return WideTables(records, tree_off, depth, np.asarray(chunk_tree, dtype=np.int32), chunk_rec, node)


def predict_pertree_margin_wide(wf: WideGemmForest, x: torch.Tensor) -> torch.Tensor:
    """(N, T) per-tree leaf margins via the wide formulation, in plain torch.

    The one-hot feature pick is an index gather (exact; an all-zero padded
    column picks 0) — a float32 one-hot product would be exact only with TF32
    off, and even then turns a NaN or inf anywhere in a row into NaN for every
    node. With ``default_left`` a NaN feature takes the node's default branch,
    the reference's NaN-mask branch; without it the pipeline's features are
    finite. The routing product ``d @ m2`` has operands in
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
    dleft = None if wf.dleft is None else torch.as_tensor(wf.dleft, device=dev).gt(0.5)
    out = torch.empty((n, b * g), dtype=torch.float32, device=dev)
    for bi in range(b):
        xf = torch.where(has[bi], x[:, feat[bi]], torch.zeros((), device=dev))
        d = xf <= thr[bi]
        if dleft is not None:  # missing (NaN) takes the node's default branch
            d = torch.where(torch.isnan(xf), dleft[bi], d)
        match = d.to(torch.float32) @ m2[bi] + c[bi]
        hit = (match == plen[bi]).to(torch.float32).view(n, g, n_leaf)
        out[:, bi * g:(bi + 1) * g] = (hit * value[bi]).sum(dim=2)
    return out[:, :wf.n_trees]


def wide_margin_plain(wf: WideGemmForest, x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: per-tree margins reduced in ascending tree order."""
    return sequential_tree_sum(predict_pertree_margin_wide(wf, x))


def _device_limits(device: torch.device) -> tuple[int, int]:
    """(SM count, opt-in shared memory per block) of ``device``, asked once per
    device; the first ask also lets the wide kernel use that shared memory."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _LIMITS:
        sm_count, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _entry("forest_wide_prepare")(ctypes.byref(sm_count), ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f"forest_wide_prepare failed: cudaError_t {err}")
        _LIMITS[index] = (sm_count.value, smem.value)
    return _LIMITS[index]


class WideForestKernel:
    """fn(x) -> (N,) margins for one forest, through the wide-block kernel.

    On a CUDA ``device`` the compact tables are built once and put there,
    and a CUDA tensor launches the kernel. A CPU tensor is scored by the
    plain version over the forest's wide encoding (built on first use); a
    kernel made for the CPU builds no tables, so it takes trees of any size.
    """

    def __init__(self, forest: FlatForest, n_features: int, device: torch.device | str):
        reads = int(forest.feature.max())
        if reads >= n_features:
            raise ValueError(f"forest reads feature {reads} of {n_features}")
        self.forest = forest
        self.n_features = n_features
        self.device = torch.device(device)
        self.tables: WideTables | None = None
        self._wide: WideGemmForest | None = None
        #: rows -> (rows a tile, blocks, shared memory bytes) of a launch
        self._plans: dict[int, tuple[int, int, int]] = {}
        if self.device.type != "cuda":
            return
        self.tables = compact_tables(forest, n_features)
        self._rows_max = tile_rows(n_features)
        self.records = torch.from_numpy(self.tables.records).to(self.device)
        self.tree_info = torch.from_numpy(np.stack([self.tables.tree_off, self.tables.depth], axis=1)).to(self.device)
        self.chunk_tree = torch.from_numpy(self.tables.chunk_tree).to(self.device)
        self.chunk_rec = torch.from_numpy(self.tables.chunk_rec).to(self.device)
        self.device = self.records.device  # with its index
        # the launch's arguments after x and n, fixed for the kernel's life
        self._table_args = (n_features, self.records.data_ptr(), self.tree_info.data_ptr(),
                            self.chunk_tree.data_ptr(), self.chunk_rec.data_ptr(), self.tables.n_chunks,
                            self.tables.chunk_records)

    def wide(self) -> WideGemmForest:
        """The forest's wide encoding, as the plain version packs it."""
        if self._wide is None:
            self._wide = to_wide(to_gemm(self.forest, self.n_features))
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

    def _plan(self, n: int, device: torch.device) -> tuple[int, int, int]:
        """(rows a tile, blocks, shared memory bytes) of a launch over ``n``
        rows, worked out at the first launch over ``n`` rows."""
        sm_count, smem_optin = _device_limits(device)
        rows, grid = launch_shape(n, sm_count, self._rows_max)
        smem = self.tables.smem_bytes(self.n_features, rows)
        if smem > smem_optin:
            raise RuntimeError(f"forest kernel: a chunk of {self.tables.chunk_records} records and "
                               f"{rows}-row feature tiles need {smem} bytes of shared memory; the "
                               f"device allows {smem_optin}")
        if len(self._plans) >= 64:
            self._plans.clear()
        self._plans[n] = plan = (rows, grid, smem)
        return plan

    def launch(self, x: torch.Tensor) -> torch.Tensor:
        global LAUNCHES
        _check_input(x, self.n_features, self.device, "forest kernel")
        if self.tables is None:
            raise ValueError(f"forest kernel: made for {self.device}, which holds no tables")
        n = x.shape[0]
        out = torch.empty(n, dtype=torch.float32, device=x.device)
        if n == 0:
            return out
        plan = self._plans.get(n) or self._plan(n, x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _entry("forest_wide_margin")(x.data_ptr(), n, *self._table_args, *plan, out.data_ptr(), stream)
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
        _check_input(x, self.n_features, self.nodes.device, "per-tree forest kernel")
        n = x.shape[0]
        out = torch.empty(n, dtype=torch.float32, device=x.device)
        if n == 0:
            return out
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _entry("forest_tree_step_margin")(x.data_ptr(), n, self.n_features, self.nodes.data_ptr(),
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
