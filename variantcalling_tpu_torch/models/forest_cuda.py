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
of trees at a time, sit in shared memory (:class:`WideTables`); trees too
large for a chunk are walked from device memory over 16-byte records, so
every tree size is served. Its plain version is :func:`wide_margin_plain`.

**The per-tree kernel** (``csrc/forest_tree_step.cu``, :class:`TreeStepKernel`,
count :data:`TREE_STEP_LAUNCHES`) replaces the Pallas kernel
``_tree_step_kernel`` (``forest_pallas.py:51``), launched by
``_margin_pallas`` and driven by ``make_gemm_pallas_predictor``: per tile
and tree, trees innermost, the same chain for one tree and ``out += hit @
value``. The CUDA kernel keeps that contraction and runs the routing ``d @
m2`` on the tensor cores as an int8 ``mma`` with exact int32 sums: each
lane decides the nodes of its A fragment straight from the feature tile
(NaN takes the node's default with ``default_left``, as the reference's
``predict_margin_gemm`` does), multiplies them with ``m2`` fragments
streamed through shared memory (:func:`tree_step_tables`), and picks the
leaf whose sum equals ``c - plen`` (a true decision is -1). Its plain version is
:func:`forest.predict_margin_gemm`.

Both kernels read ``x[row, feat]`` exactly — no TF32 product, no
``torch.matmul`` — and add each tree's leaf value to one float32
accumulator per row in ascending tree order, writing (N,) margins.

Both compute the same function, so both have one least work
(:func:`scoring_work`, each kernel's ``work``): the count ``chip_smoke.py``
bounds each kernel with and the run telemetry's ``cost_analysis`` event
carries.
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter
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
#: guards the two counts: the streaming executor's workers launch concurrently
_COUNT_LOCK = threading.Lock()


def _count_launch(name: str) -> None:
    """Add one launch to the count ``name`` (``LAUNCHES`` or ``TREE_STEP_LAUNCHES``)."""
    with _COUNT_LOCK:
        globals()[name] += 1


#: H100 SXM published peaks (NVIDIA data sheet, at the 700 W power limit): the
#: card's memory rate and its float32 rate outside the tensor cores
H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_OPS_PER_S = 67e12


def scoring_work(n: int, n_features: int, table_bytes: int, depths) -> dict:
    """The least work of scoring ``n`` rows with a forest whose trees take
    ``depths`` compares from root to leaf (complete trees: each row walks
    every tree to that depth): each input byte read once (the (n, F) float32
    features, the kernel's ``table_bytes``), each float32 margin written
    once; operations are a row's threshold compares and the adds of its tree
    sum. ``bound_ms`` is the larger of the bytes over the H100's memory rate
    and the operations over its float32 rate, ``bound_by`` which one."""
    depths = np.asarray(depths, dtype=np.int64)
    nbytes = n * n_features * 4 + int(table_bytes) + n * 4
    ops = n * (int(depths.sum()) + len(depths))
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


#: one load of each kernel library, whichever thread asks first
_LIB_LOCK = threading.Lock()

_LIBS: dict[str, ctypes.CDLL] = {}
#: (SM count, opt-in shared memory per block) by (prepare entry point, device index)
_LIMITS: dict[tuple[str, int], tuple[int, int]] = {}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C entry point -> (kernel source, argument types)
_ENTRIES = {
    # sm_count*, smem_optin*
    "forest_wide_prepare": ("forest_wide", [_P, _P]),
    # x, n, f, records, tree_info, chunk_tree, chunk_rec, chunk_global, chunks, chunk_records, rows, grid,
    # smem, out, stream
    "forest_wide_margin": ("forest_wide", [_P, _LL, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]),
    # sm_count*, smem_optin*
    "forest_tree_step_prepare": ("forest_tree_step", [_P, _P]),
    # x, n, f, columns, blob, units, stages, n_stages, stage_bytes, warps, grid, smem, out, stream
    "forest_tree_step_margin": ("forest_tree_step", [_P, _LL, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]),
}


def _entry(fn_name: str):
    """The C entry point ``fn_name``, its source built and loaded at first use."""
    name = _ENTRIES[fn_name][0]
    with _LIB_LOCK:
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
#: a record's 15-bit feature index (and, in shared memory, 15-bit child slot)
_MAX_FIELD = 0x7FFF


@dataclass
class WideTables:
    """The wide-block kernel's tables, built by :func:`compact_tables`.

    ``records`` int32 (S, 2). The trees are cut into chunks of whole trees:
    chunk ``c`` holds trees ``chunk_tree[c]:chunk_tree[c + 1]`` in records
    ``chunk_rec[c]:chunk_rec[c + 1]`` (an even count: 16-byte copies). A
    chunk that fits a shared-memory buffer holds one 8-byte record per
    tree slot. An internal node is [threshold bits, ``first << 16 |
    default_left << 15 | feature``] and its children sit in slots ``first``
    (left) and ``first + 1`` (right) of the same tree. A leaf is [value
    bits, ``slot << 16 | 1 << 15 | n_features``]: its feature is the
    kernel's extra feature row of -inf and its ``first`` its own slot, so
    that a step from a leaf stays on it. A *global* chunk
    (``chunk_global[c]``) holds trees too large for a buffer; the kernel
    reads it from device memory, and each of its slots takes two records, a
    16-byte record [threshold or value bits, ``default_left << 15 |
    feature``, ``first``, 0] whose ``first`` has all 32 bits. Each tree's
    slots run root first, breadth first; ``tree_off[t]`` is tree t's root
    slot counted from its chunk's first record (in slots), and ``depth[t]``
    its internal levels (the steps a walk takes). ``node`` int32 (S,) names
    the forest node each record holds (-1: padding, and the second half of
    a 16-byte record).
    """

    records: np.ndarray
    tree_off: np.ndarray
    depth: np.ndarray
    chunk_tree: np.ndarray
    chunk_rec: np.ndarray
    chunk_global: np.ndarray
    node: np.ndarray

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_tree) - 1

    @cached_property
    def chunk_records(self) -> int:
        """Records of the largest chunk held in shared memory: the size of one
        buffer (0 when every chunk is global)."""
        local = np.diff(self.chunk_rec)[~self.chunk_global]
        return int(local.max()) if len(local) else 0

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
    """The wide kernel's tables (:class:`WideTables`), built straight from the
    forest's node arrays.

    Each tree's reachable nodes are numbered breadth first from the root,
    so that every internal node's two children take adjacent slots. The
    trees stay one chunk when they fit the shared memory that two feature
    tiles leave (:func:`tile_rows`); otherwise they are cut, in order, into
    chunks of at most half of it, between the kernel's groups of
    :data:`TREES_AT_ONCE` trees where a group fits a chunk and between
    single trees where it does not. A tree larger than a chunk goes, with
    the large trees next to it, into a global chunk of 16-byte records that
    the kernel reads from device memory: any tree size is served. Raises
    ValueError where the forest reads a feature past ``n_features`` or the
    feature count overflows the record's field.
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

    # the chunks: whole trees in order; one chunk if the forest fits beside the feature tiles
    budget = (smem_bytes - 2 * (n_features + 1) * tile_rows(n_features) * 4) // 8
    cap = budget if int(n_slots.sum()) + 1 <= budget else budget // 4 * 2  # even: 16-byte copies
    assert cap <= _MAX_FIELD + 1  # a tree in shared memory fits the record's child slot
    big = n_slots > cap  # trees walked from device memory
    chunk_tree, chunk_global = [0], [bool(big[0])]
    tree_off, used = np.zeros(t, dtype=np.int32), 0
    for k0 in range(0, t, TREES_AT_ONCE):
        group = slice(k0, min(k0 + TREES_AT_ONCE, t))
        if used and not chunk_global[-1] and not big[group].any() \
                and used + int(n_slots[group].sum()) > cap:  # a new chunk for the group
            chunk_tree.append(k0)
            chunk_global.append(False)
            used = 0
        for k in range(group.start, group.stop):
            # a group larger than a chunk is cut inside; large trees share global chunks
            if used and (big[k] != chunk_global[-1] or (not big[k] and used + int(n_slots[k]) > cap)):
                chunk_tree.append(k)
                chunk_global.append(bool(big[k]))
                used = 0
            tree_off[k] = used
            used += int(n_slots[k])
    chunk_tree.append(t)
    glob = np.asarray(chunk_global, dtype=bool)
    chunk_of = np.repeat(np.arange(len(glob)), np.diff(chunk_tree))
    width = np.where(big, 2, 1)  # records a slot takes
    ends = (tree_off + n_slots) * width
    sizes = np.asarray([ends[chunk_tree[c + 1] - 1] for c in range(len(glob))])
    chunk_rec = np.concatenate([[0], np.cumsum(sizes + sizes % 2)]).astype(np.int32)
    start = chunk_rec[chunk_of] + tree_off * width  # each tree's first record in the whole table

    dleft = np.zeros((t, m), dtype=bool) if forest.default_left is None else forest.default_left
    s = slot[ti, ni]
    value = np.where(inner, forest.threshold[ti, ni], forest.value[ti, ni]).astype(np.float32).view(np.int32)
    low = np.where(inner, (dleft[ti, ni].astype(np.int64) << 15) | feat[ti, ni], (1 << 15) | n_features)
    nxt = np.where(inner, first[ti, ni], s)  # a leaf steps onto itself
    wide = big[ti]
    at = start[ti] + s * width[ti]
    records = np.zeros((int(chunk_rec[-1]), 2), dtype=np.int32)
    records[at, 0] = value
    records[at, 1] = np.where(wide, low, (nxt << 16) | low)
    records[at[wide] + 1, 0] = nxt[wide]
    node = np.full(len(records), -1, dtype=np.int32)
    node[at] = ni
    return WideTables(records, tree_off, depth, np.asarray(chunk_tree, dtype=np.int32), chunk_rec, glob, node)


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


def _device_limits(prepare: str, device: torch.device) -> tuple[int, int]:
    """(SM count, opt-in shared memory per block) of ``device``, asked once per
    device and kernel through the kernel's ``prepare`` entry point, which also
    lets the kernel use that shared memory."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if (prepare, index) not in _LIMITS:
        sm_count, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _entry(prepare)(ctypes.byref(sm_count), ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f"{prepare} failed: cudaError_t {err}")
        _LIMITS[prepare, index] = (sm_count.value, smem.value)
    return _LIMITS[prepare, index]


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
        self.records, self.tree_info, self.chunk_tree, self.chunk_rec, self.chunk_global = (
            torch.from_numpy(a).to(self.device) for a in self._table_arrays(self.tables))
        self.device = self.records.device  # with its index
        # the launch's arguments after x and n, fixed for the kernel's life
        self._table_args = (n_features, self.records.data_ptr(), self.tree_info.data_ptr(),
                            self.chunk_tree.data_ptr(), self.chunk_rec.data_ptr(), self.chunk_global.data_ptr(),
                            self.tables.n_chunks, self.tables.chunk_records)

    @staticmethod
    def _table_arrays(tables: WideTables) -> tuple[np.ndarray, ...]:
        """The arrays the kernel reads, as they go to the card: the records,
        (root slot, depth) a tree, the chunks' trees, records and globality."""
        return (tables.records, np.stack([tables.tree_off, tables.depth], axis=1), tables.chunk_tree,
                tables.chunk_rec, tables.chunk_global.astype(np.int32))

    def work(self, n: int) -> dict:
        """:func:`scoring_work` of ``n`` rows through this kernel (a kernel
        made for the CPU builds the tables it would upload, to count them)."""
        tables = self.tables if self.tables is not None else compact_tables(self.forest, self.n_features)
        return scoring_work(n, self.n_features, sum(a.nbytes for a in self._table_arrays(tables)), tables.depth)

    def load(self) -> None:
        """On the card: build and load the kernel's library and ask the
        device's limits, so that a first launch does neither."""
        if self.device.type == "cuda":
            _device_limits("forest_wide_prepare", self.device)

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
        sm_count, smem_optin = _device_limits("forest_wide_prepare", device)
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
        _count_launch("LAUNCHES")
        return out


#: leaves of one pass of the per-tree kernel: 8 tensor-core n-tiles of 8 leaves
PASS_LEAVES = 64
#: internal nodes of one k-block: the depth of an int8 ``mma`` (32)
K_BLOCK = 32
#: bytes of one k-block in the per-tree tables: 32 node entries (8 bytes
#: each) and the ``m2`` fragments of 32 nodes x 64 leaves (int8)
K_BLOCK_BYTES = K_BLOCK * 8 + K_BLOCK * PASS_LEAVES
#: bytes of one pass's leaf table: [c - plen, value bits] per leaf
LEAF_TABLE_BYTES = PASS_LEAVES * 8
#: the most k-blocks a unit of the per-tree tables holds
UNIT_K_BLOCKS = 16
#: bytes of the units the per-tree kernel copies into shared memory at once,
#: at most (a larger unit goes alone): two buffers and a 4-warp block's feature
#: rows leave room for four blocks an SM
STAGE_BYTES = 16 * 1024
#: unit flags (bits of the unit header's second word, above the k-block count)
UNIT_FIRST, UNIT_LAST_PASS, UNIT_LAST_TREE = 1 << 16, 1 << 17, 1 << 18
#: warps a block of the per-tree kernel runs, at most; each scores 32 rows
TREE_STEP_MAX_WARPS = 4


@dataclass
class TreeStepTables:
    """The per-tree kernel's tables, built by :func:`tree_step_tables`.

    ``blob`` int32: the forest cut into *units*, in ascending tree order, that
    the kernel streams through shared memory one after the other. Each tree
    is scored in passes of :data:`PASS_LEAVES` leaves (its leaves in
    ``to_gemm``'s order, padded to a multiple of 64 with leaves that never
    match); a pass's routing ``d @ m2`` runs over the k-blocks (32 internal
    nodes each) whose ``m2`` block under the pass's leaves is not all zero —
    a zero block adds 0 to every int32 sum — and is cut into units of at
    most :data:`UNIT_K_BLOCKS` k-blocks. A unit is its k-blocks, each
    :data:`K_BLOCK_BYTES`: 32 node entries int32 [threshold bits, column]
    in the order of :func:`_bank_order` (a padded node: threshold 0, the
    column of its shared load's first node, and a zero ``m2`` row) and the
    block's int8 ``m2``, its rows in the same order, in the ``mma.m16n8k32``
    B-fragment order (4 pairs of n-tiles x 32
    lanes x 16 bytes: :func:`_b_fragments`); the last unit of a pass ends
    with the pass's leaf table, per leaf int32 [``c - plen``, value bits] (a
    padded leaf: [1, 0]; its sum is 0). A node's column is its feature, plus
    ``n_features`` where its default branch is left: the kernel's feature
    rows hold ``x`` and, after it where the forest has ``default_left``, ``x``
    with NaN read as -inf, so that ``v <= thr`` alone is the reference's
    ``isnan(v) ? dleft : v <= thr``. A decision true is the int8 -1, so a
    pass's sums are ``-(d @ m2)``, hit where they equal ``c - plen``.
    ``units`` int32 (U, 2): per unit [offset in ``blob`` in 16-byte words,
    ``k_blocks | UNIT_FIRST (first unit of a pass) | UNIT_LAST_PASS (last
    unit of a pass: the leaf table follows) | UNIT_LAST_TREE (last unit of
    a tree)``].
    ``stages`` int32 (S, 4): the units cut, in order, into runs of at most
    :data:`STAGE_BYTES` (or one unit where a unit is larger), which the
    kernel copies into shared memory whole: [offset in ``blob`` in 16-byte
    words, 16-byte words, first unit, units]; ``stage_bytes``: the largest,
    one shared-memory buffer. ``columns``: ``n_features``, or twice that
    with ``default_left``.
    """

    blob: np.ndarray
    units: np.ndarray
    stages: np.ndarray
    stage_bytes: int
    columns: int


def _b_fragments(m2t: np.ndarray) -> np.ndarray:
    """(..., 64 leaves, 32 nodes) int8 -> (..., 2048) int8 in the order lane
    ``l`` of a warp reads as 16 bytes at ``(pair * 32 + l) * 16``: the B
    fragments of ``mma.m16n8k32.row.col`` for n-tiles ``2 pair`` and ``2 pair
    + 1``. Lane ``l = 4 g + q`` holds, per n-tile, two 32-bit registers: the
    bytes of leaf ``8 n + g`` at nodes ``4 q .. 4 q + 3`` and ``16 + 4 q ..
    16 + 4 q + 3``."""
    lead = m2t.shape[:-2]
    # (pair, n-tile of the pair, g, half, q, byte) -> (pair, g, q, n-tile of the pair, half, byte)
    six = m2t.reshape(lead + (4, 2, 8, 2, 4, 4))
    k = len(lead)
    order = tuple(range(k)) + tuple(k + a for a in (0, 2, 4, 1, 3, 5))
    return np.ascontiguousarray(six.transpose(order)).reshape(lead + (2048,))


def _bank_order(cols: np.ndarray, real: np.ndarray) -> np.ndarray:
    """Slot -> node of one k-block's 32 node entries (``cols`` their columns,
    ``real`` False for padded nodes), so that the kernel's shared loads of
    feature values meet no bank conflict where the block allows it. Lanes q =
    0..3 of a warp read, in one load, the columns of slots ``s | 4 q`` (s with
    bits 2-3 clear), at a feature-row stride of 8 words modulo the 32 banks:
    the four are conflict-free when their columns are equal or differ modulo
    4. Nodes are placed greedily, the most used columns first, each in a load
    that holds its column already, else in the emptiest load whose columns
    miss its class; padded nodes fill the loads' last lanes."""
    cols, real = cols.tolist(), real.tolist()
    nodes = [k for k in range(K_BLOCK) if real[k]]
    count = Counter(cols[k] for k in nodes)
    loads: list[list[int]] = [[] for _ in range(8)]
    held: list[dict[int, int]] = [{} for _ in range(8)]  # per load: column class -> column
    for k in sorted(nodes, key=lambda k: (-count[cols[k]], cols[k], k)):
        c = cols[k]
        # the fullest load holding c, else the emptiest without c's class, else the emptiest
        j = min((j for j in range(8) if len(loads[j]) < 4),
                key=lambda j: ((0, -len(loads[j])) if held[j].get(c % 4) == c
                               else (1 if c % 4 not in held[j] else 2, len(loads[j])), j))
        loads[j].append(k)
        held[j].setdefault(c % 4, c)
    pads = [k for k in range(K_BLOCK) if not real[k]]
    order = np.empty(K_BLOCK, dtype=np.int64)
    for j, lead in enumerate((0, 1, 2, 3, 16, 17, 18, 19)):  # the slots s with bits 2-3 clear
        order[[lead, lead + 4, lead + 8, lead + 12]] = loads[j] + [pads.pop() for _ in range(4 - len(loads[j]))]
    return order


def tree_step_tables(gf: GemmForest) -> TreeStepTables:
    """The per-tree kernel's int8 tables (:class:`TreeStepTables`), built once
    from a :class:`GemmForest`."""
    t, f, i = gf.a.shape
    l = gf.n_leaves
    n_kb, n_pass = -(-i // K_BLOCK), -(-l // PASS_LEAVES)
    ip, lp = n_kb * K_BLOCK, n_pass * PASS_LEAVES
    nodes = np.zeros((t, ip, 2), dtype=np.int32)
    nodes[:, :i, 0] = gf.thr.astype(np.float32).view(np.int32)
    dleft = np.zeros((t, i), dtype=bool) if gf.dleft is None else gf.dleft > 0.5
    nodes[:, :i, 1] = gf.a.argmax(axis=1).astype(np.int32) + f * dleft
    m2t = np.zeros((t, lp, ip), dtype=np.int8)
    m2t[:, :l, :i] = gf.m2.transpose(0, 2, 1)
    # each k-block's nodes in bank order; a padded node (m2 row 0) reads its load's first column
    real_node, spans = np.arange(ip) < i, [slice(kb * K_BLOCK, (kb + 1) * K_BLOCK) for kb in range(n_kb)]
    order = np.asarray([np.concatenate([ks.start + _bank_order(nodes[ti, ks, 1], real_node[ks]) for ks in spans])
                        for ti in range(t)]).reshape(t, ip)
    nodes = np.take_along_axis(nodes, order[:, :, None], axis=1)
    m2t = np.take_along_axis(m2t, order[:, None, :], axis=2)
    nodes[:, :, 1] = np.where(order < i, nodes[:, :, 1], nodes[:, np.arange(ip) & ~12, 1])
    nodes = nodes.reshape(t, n_kb, K_BLOCK * 2)
    blocks = m2t.reshape(t, n_pass, PASS_LEAVES, n_kb, K_BLOCK).transpose(0, 1, 3, 2, 4)
    live = blocks.any(axis=(3, 4))  # (T, passes, k-blocks)
    frags = _b_fragments(blocks).view(np.int32)  # (T, passes, k-blocks, 512)
    leaves = np.zeros((t, lp, 2), dtype=np.int32)
    leaves[:, :, 0] = 1  # a padded leaf: its sum, 0, is never 1
    leaves[:, :l, 0] = (gf.c - gf.plen).astype(np.int32)
    leaves[:, :l, 1] = gf.value.astype(np.float32).view(np.int32)
    real = np.zeros((t, lp), dtype=bool)
    real[:, :l] = gf.plen >= 0
    real = real.reshape(t, n_pass, PASS_LEAVES).any(axis=2)
    leaves = leaves.reshape(t, n_pass, LEAF_TABLE_BYTES // 4)

    parts, units, at = [], [], 0
    for ti in range(t):
        for pi in np.flatnonzero(real[ti]):  # a pass of padded leaves only cannot hit
            kbs = np.flatnonzero(live[ti, pi])
            cuts = [kbs[lo:lo + UNIT_K_BLOCKS] for lo in range(0, len(kbs), UNIT_K_BLOCKS)] or [kbs]
            for ci, cut in enumerate(cuts):
                words = [np.concatenate([nodes[ti, kb], frags[ti, pi, kb]]) for kb in cut]
                flags = len(cut) | (UNIT_FIRST if ci == 0 else 0)
                if ci == len(cuts) - 1:
                    words.append(leaves[ti, pi])
                    flags |= UNIT_LAST_PASS
                units.append([at // 4, flags])
                parts += words
                at += sum(len(w) for w in words)
        units[-1][1] |= UNIT_LAST_TREE
    units = np.asarray(units, dtype=np.int32).reshape(-1, 2)
    blob = np.concatenate(parts).astype(np.int32)
    words = np.diff(np.append(units[:, 0], at // 4))  # each unit's 16-byte words
    stages, u0 = [], 0
    while u0 < len(units):
        u1 = u0 + 1
        while u1 < len(units) and 16 * int(words[u0:u1 + 1].sum()) <= STAGE_BYTES:
            u1 += 1
        stages.append([units[u0, 0], int(words[u0:u1].sum()), u0, u1 - u0])
        u0 = u1
    stages = np.asarray(stages, dtype=np.int32)
    return TreeStepTables(blob, units, stages, 16 * int(stages[:, 1].max()), f if gf.dleft is None else 2 * f)


def tree_step_plan(n: int, columns: int, stage_bytes: int, smem_optin: int) -> tuple[int, int, int]:
    """(warps a block, blocks, shared memory bytes) of a per-tree launch over
    ``n`` rows: two stage buffers and the block's feature rows, feature-major
    (``columns`` rows of ``32 * warps + 8`` floats), with as many warps (32
    rows each, at most :data:`TREE_STEP_MAX_WARPS`) as fit."""
    warps = TREE_STEP_MAX_WARPS
    while warps:
        smem = 2 * stage_bytes + columns * (32 * warps + 8) * 4
        if smem <= smem_optin:
            return warps, -(-n // (warps * 32)), smem
        warps //= 2
    raise RuntimeError(f"per-tree forest kernel: stages of {stage_bytes} bytes and rows of {columns} columns "
                       f"need more than the device's {smem_optin} bytes of shared memory")


class TreeStepKernel:
    """fn(x) -> (N,) margins for one forest, through the per-tree kernel.

    The tables are built once from ``gf``, on ``device``. A CPU tensor is
    scored by the plain version (:func:`forest.predict_margin_gemm`); a
    CUDA tensor launches the kernel.
    """

    def __init__(self, gf: GemmForest, device: torch.device | str):
        self.gf = gf
        self.n_features = gf.a.shape[1]
        self.tables = tree_step_tables(gf)
        device = torch.device(device)
        self.blob = torch.from_numpy(self.tables.blob).to(device)
        self.units = torch.from_numpy(self.tables.units).to(device)
        self.stages = torch.from_numpy(self.tables.stages).to(device)
        self.device = self.blob.device  # with its index
        #: rows -> (warps a block, blocks, shared memory bytes) of a launch
        self._plans: dict[int, tuple[int, int, int]] = {}
        # the launch's table arguments, fixed for the kernel's life
        self._table_args = (self.n_features, self.tables.columns, self.blob.data_ptr(), self.units.data_ptr(),
                            self.stages.data_ptr(), len(self.tables.stages), self.tables.stage_bytes)

    def work(self, n: int) -> dict:
        """:func:`scoring_work` of ``n`` rows through this kernel."""
        plen = self.gf.plen
        depths = [int(p[p >= 0].max()) for p in plen]
        return scoring_work(n, self.n_features, self.tables.blob.nbytes + self.tables.units.nbytes, depths)

    def load(self) -> None:
        """On the card: build and load the kernel's library and ask the
        device's limits, so that a first launch does neither."""
        if self.device.type == "cuda":
            _device_limits("forest_tree_step_prepare", self.device)

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel's plain version on ``x``, on whatever device ``x`` lives on."""
        return predict_margin_gemm(self.gf, x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return self.plain(x)
        if x.device.type != "cuda":
            raise ValueError(f"per-tree forest kernel: unsupported device {x.device}")
        return self.launch(x)

    def _plan(self, n: int, device: torch.device) -> tuple[int, int, int]:
        """The launch plan over ``n`` rows, worked out at the first launch over ``n`` rows."""
        _, smem_optin = _device_limits("forest_tree_step_prepare", device)
        if len(self._plans) >= 64:
            self._plans.clear()
        self._plans[n] = plan = tree_step_plan(n, self.tables.columns, self.tables.stage_bytes, smem_optin)
        return plan

    def launch(self, x: torch.Tensor) -> torch.Tensor:
        _check_input(x, self.n_features, self.device, "per-tree forest kernel")
        n = x.shape[0]
        out = torch.empty(n, dtype=torch.float32, device=x.device)
        if n == 0:
            return out
        plan = self._plans.get(n) or self._plan(n, x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _entry("forest_tree_step_margin")(x.data_ptr(), n, *self._table_args, *plan, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"forest_tree_step_margin failed: cudaError_t {err}")
        _count_launch("TREE_STEP_LAUNCHES")
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
