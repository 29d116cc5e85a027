"""Decision-forest inference: flat node arrays, GEMM/wide encodings, the gather walk.

Counterpart of ``variantcalling_tpu/models/forest.py``. A trained forest is
a :class:`FlatForest` of dense (trees, nodes) arrays. Three scoring
strategies exist in the port, each named in the run's header with a
``cuda-`` prefix when it runs on the card:

- ``cuda-wide``: the forest walked over compact node records by the
  hand-written wide-block kernel in :mod:`forest_cuda` (counterpart of the
  reference's Pallas wide-block kernel and of its jnp ``wide`` strategy,
  :func:`to_wide`); it serves every forest, ``default_left`` ones included,
  as the reference's ``wide`` does;
- ``cuda-gemm``: the per-tree path-matrix formulation (:func:`to_gemm`,
  :func:`predict_margin_gemm`), scored by the hand-written per-tree kernel
  in :mod:`forest_cuda` (counterpart of the reference's Pallas
  ``_tree_step_kernel``), on an explicit ``gemm`` request;
- ``gather``: the node-gather walk (:func:`predict_margin`) in plain torch,
  which the reference runs on the CPU and for trees beyond
  :data:`GEMM_MAX_LEAVES` leaves.

On the CPU, ``wide`` and ``gemm`` run the kernels' plain versions. The
strategy is requested through ``VCTPU_FOREST_STRATEGY``
(``auto|gather|gemm|wide|pallas``) and resolved once per run
(:func:`resolve_strategy`); the resolution is final — there is no fallback.

Every strategy returns the same bits. Each tree's leaf value is picked out
exactly, the trees are summed in ascending order (:func:`sequential_tree_sum`;
never ``torch.sum``, which reassociates), and the sigmoid or mean runs on
the host in numpy (:func:`finalize_margin`) — the device returns margins,
never scores.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.engine import EngineError

LEAF = -1

#: the VCF header key the filter pipeline records the resolved strategy under
STRATEGY_HEADER_KEY = "vctpu_forest_strategy"
#: the strategy request: auto|gather|gemm|wide|pallas (``pallas`` names the
#: reference's wide-block kernel, whose counterpart here is ``wide``)
FOREST_STRATEGY_ENV = "VCTPU_FOREST_STRATEGY"
FOREST_STRATEGIES = knobs.REGISTRY[FOREST_STRATEGY_ENV].choices  # auto gather gemm wide pallas
#: resolved strategies: the kernels on the card, their plain versions on the CPU, the walk
STRATEGIES = ("cuda-wide", "cuda-gemm", "wide", "gemm", "gather")

# beyond this many leaves per tree the routing contraction costs more than
# the gather walk saves; such forests score through the gather walk
GEMM_MAX_LEAVES = 512


@dataclass
class FlatForest:
    """Dense forest: (n_trees, max_nodes) arrays; leaves self-loop with feature=LEAF."""

    feature: np.ndarray  # int32 (T, M); LEAF for leaf nodes
    threshold: np.ndarray  # float32 (T, M)
    left: np.ndarray  # int32 (T, M)
    right: np.ndarray  # int32 (T, M)
    value: np.ndarray  # float32 (T, M): leaf payload (class-1 prob or margin)
    max_depth: int
    aggregation: str = "mean"  # "mean" (RF proba) | "logit_sum" (GBT margin)
    base_score: float = 0.0  # added before the sigmoid for logit_sum
    feature_names: list[str] = field(default_factory=list)
    pass_threshold: float = 0.5  # TREE_SCORE >= this -> PASS
    # xgboost-style missing-value routing: NaN features take the node's
    # default branch; None = no missing routing (NaN routes right)
    default_left: np.ndarray | None = None  # bool (T, M) or None

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]


def sequential_tree_sum(per_tree: torch.Tensor) -> torch.Tensor:
    """(N, T) per-tree leaf margins -> (N,) sum in ascending tree order.

    An explicit loop ``acc = acc + per_tree[:, t]``: float32 addition in a
    fixed order, which ``torch.sum`` (pairwise and vectorised partials)
    does not give. The CUDA kernel accumulates in the same order.
    """
    n, t = per_tree.shape
    acc = torch.zeros(n, dtype=per_tree.dtype, device=per_tree.device)
    for ti in range(t):
        acc = acc + per_tree[:, ti]
    return acc


def predict_margin(forest: FlatForest, x: torch.Tensor) -> torch.Tensor:
    """Raw per-variant leaf-value sum in ascending tree order: the gather walk.

    ``max_depth`` rounds in which every (variant, tree) pair advances one
    level (leaves self-loop), then one gather of the leaf values.
    """
    t, m = forest.feature.shape
    dev = x.device
    n = x.shape[0]

    def flat(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a).reshape(-1), device=dev).to(dtype)

    feature = flat(forest.feature, torch.int64)
    threshold = flat(forest.threshold, torch.float32)
    left = flat(forest.left, torch.int64)
    right = flat(forest.right, torch.int64)
    value = flat(forest.value, torch.float32)
    dleft = None if forest.default_left is None else flat(forest.default_left, torch.bool)
    toff = (torch.arange(t, device=dev, dtype=torch.int64) * m)[None, :]
    idx = torch.zeros((n, t), dtype=torch.int64, device=dev)
    for _ in range(forest.max_depth):
        node = toff + idx
        f = feature[node]
        xv = torch.gather(x, 1, f.clamp(min=0))
        go_left = xv <= threshold[node]
        if dleft is not None:  # missing (NaN) takes the node's default branch
            go_left = torch.where(torch.isnan(xv), dleft[node], go_left)
        nxt = torch.where(go_left, left[node], right[node])
        idx = torch.where(f == LEAF, idx, nxt)
    return sequential_tree_sum(value[toff + idx])


def finalize_margin(margin: np.ndarray, forest: FlatForest) -> np.ndarray:
    """Host finalization margin -> TREE_SCORE, in numpy (as in the reference).

    ``exp`` is implementation-defined, so the sigmoid runs here on the host
    for every engine; the device only ever returns margins.
    """
    m = np.asarray(margin, dtype=np.float32)
    if forest.aggregation == "mean":
        return m / np.float32(forest.n_trees)
    if forest.aggregation == "logit_sum":
        z = m + np.float32(forest.base_score)
        return (np.float32(1.0) / (np.float32(1.0) + np.exp(-z))).astype(np.float32)
    raise ValueError(f"unknown aggregation {forest.aggregation!r}")


@dataclass
class GemmForest:
    """Path-matrix (GEMM) encoding of a forest.

      XF    = X @ A          (N,F)@(F,I) one-hot feature pick per internal node
      D     = XF <= thr      {0,1} decisions
      match = D @ M2 + c     M2 = 2B - P: +1 where the leaf is in the node's
                             left subtree, -1 in its right; c = right turns
      leaf  = (match == plen) exactly one leaf matches
    """

    a: np.ndarray  # f32 (T, F, I) one-hot feature selectors
    thr: np.ndarray  # f32 (T, I)
    m2: np.ndarray  # f32 (T, I, L)
    c: np.ndarray  # f32 (T, L) right-turn counts
    plen: np.ndarray  # f32 (T, L); -1 for padded leaves
    value: np.ndarray  # f32 (T, L)
    aggregation: str
    base_score: float
    dleft: np.ndarray | None = None  # f32 (T, I) 0/1, or None

    @property
    def n_leaves(self) -> int:
        return self.m2.shape[2]


def to_gemm(forest: FlatForest, n_features: int | None = None) -> GemmForest:
    """Rewrite a FlatForest into path-matrix form (host-side, once)."""
    t = forest.n_trees
    n_features = int(n_features if n_features is not None else max(int(forest.feature.max()) + 1, 1))
    per_tree = []
    max_i, max_l = 1, 1
    for ti in range(t):
        feat, left, right = forest.feature[ti], forest.left[ti], forest.right[ti]
        internals: list[int] = []
        leaves: list[int] = []
        paths: list[list[tuple[int, bool]]] = []
        stack: list[tuple[int, list[tuple[int, bool]]]] = [(0, [])]
        while stack:
            node, path = stack.pop()
            if feat[node] == LEAF:
                leaves.append(node)
                paths.append(path)
            else:
                k = len(internals)
                internals.append(node)
                stack.append((int(right[node]), path + [(k, False)]))
                stack.append((int(left[node]), path + [(k, True)]))
        per_tree.append((internals, leaves, paths))
        max_i = max(max_i, len(internals))
        max_l = max(max_l, len(leaves))
    a = np.zeros((t, n_features, max_i), dtype=np.float32)
    thr = np.zeros((t, max_i), dtype=np.float32)
    m2 = np.zeros((t, max_i, max_l), dtype=np.float32)
    c = np.zeros((t, max_l), dtype=np.float32)
    plen = np.full((t, max_l), -1.0, dtype=np.float32)  # -1: padded leaf never matches
    value = np.zeros((t, max_l), dtype=np.float32)
    dleft = None if forest.default_left is None else np.zeros((t, max_i), dtype=np.float32)
    for ti, (internals, leaves, paths) in enumerate(per_tree):
        for k, node in enumerate(internals):
            a[ti, forest.feature[ti, node], k] = 1.0
            thr[ti, k] = forest.threshold[ti, node]
            if dleft is not None:
                dleft[ti, k] = float(forest.default_left[ti, node])
        for j, (node, path) in enumerate(zip(leaves, paths)):
            value[ti, j] = forest.value[ti, node]
            plen[ti, j] = len(path)
            for k, went_left in path:
                m2[ti, k, j] = 1.0 if went_left else -1.0
                if not went_left:
                    c[ti, j] += 1.0
    return GemmForest(a, thr, m2, c, plen, value, forest.aggregation, forest.base_score,
                      dleft=dleft)


def _device_finalize(margin: torch.Tensor, aggregation: str, n_trees: int,
                     base_score: float) -> torch.Tensor:
    """Margin -> score on the device (a convenience for direct callers; the
    pipeline finalizes on the host with :func:`finalize_margin`, because the
    device sigmoid's ``exp`` is not bit-portable)."""
    if aggregation == "mean":
        return margin / n_trees
    if aggregation == "logit_sum":
        return torch.sigmoid(margin + base_score)
    raise ValueError(f"unknown aggregation {aggregation!r}")


def predict_margin_gemm(gf: GemmForest, x: torch.Tensor) -> torch.Tensor:
    """(N,) margins via the per-tree path-matrix formulation, in plain torch.

    The plain version of the per-tree CUDA kernel. Per tree in ascending
    order: the feature of each internal node picked by index (exact; an
    all-zero padded column of ``a`` picks 0, as the one-hot product does),
    the decision ``x <= thr`` — or, with ``default_left``, the node's
    default where the picked value is NaN (the reference's NaN-mask
    product) — the routing ``d @ m2 + c == plen`` (operands in {-1, 0, 1},
    sums at most the depth: exact in float32 and TF32 alike), and the leaf
    value of the one matching leaf (every other term is zero, so exact in
    any order), added to one accumulator as ``acc = acc + s``.
    """
    dev = x.device
    a = torch.as_tensor(gf.a, device=dev)  # (T, F, I)
    has = a.ne(0).any(dim=1)  # (T, I)
    feat = a.argmax(dim=1)
    thr = torch.as_tensor(gf.thr, device=dev)
    m2 = torch.as_tensor(gf.m2, device=dev)
    c = torch.as_tensor(gf.c, device=dev)
    plen = torch.as_tensor(gf.plen, device=dev)
    value = torch.as_tensor(gf.value, device=dev)
    dleft = None if gf.dleft is None else torch.as_tensor(gf.dleft, device=dev).gt(0.5)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=dev)
    for t in range(a.shape[0]):
        xf = torch.where(has[t], x[:, feat[t]], zero)
        d = xf <= thr[t]
        if dleft is not None:  # missing (NaN) takes the node's default branch
            d = torch.where(torch.isnan(xf), dleft[t], d)
        match = d.to(torch.float32) @ m2[t] + c[t]
        hit = (match == plen[t]).to(torch.float32)
        acc = acc + (hit * value[t]).sum(dim=1)
    return acc


def predict_score_gemm(gf: GemmForest, x: torch.Tensor) -> torch.Tensor:
    """TREE_SCORE via the per-tree formulation, finalized on the device."""
    return _device_finalize(predict_margin_gemm(gf, x), gf.aggregation, gf.m2.shape[0],
                            gf.base_score)


def default_tree_block(n_internal: int) -> int:
    """G such that the routing contraction G*I fills one 128-lane tile."""
    return max(1, 128 // max(n_internal, 1))


def resolved_tree_block(n_internal: int, n_trees: int, tree_block: int | None = None) -> int:
    """The G :func:`to_wide` packs with (argument, else the default; clamped to T)."""
    if tree_block is None:
        tree_block = default_tree_block(n_internal)
    return max(1, min(int(tree_block), n_trees))


@dataclass
class WideGemmForest:
    """Block-packed wide encoding: B blocks of G trees, block-diagonal routing.

    Trees are padded to B*G with never-matching dummies (plen=-1, value=0)
    that never enter the margin.
    """

    a: np.ndarray  # f32 (B, F, G*I) per-block feature selectors
    thr: np.ndarray  # f32 (B, G*I)
    m2: np.ndarray  # f32 (B, G*I, G*L) block-diagonal routing
    c: np.ndarray  # f32 (B, G*L)
    plen: np.ndarray  # f32 (B, G*L); -1 for padded leaves and padded trees
    value: np.ndarray  # f32 (B, G, L)
    dleft: np.ndarray | None  # f32 (B, G*I) or None
    n_trees: int  # real T
    tree_block: int  # G
    aggregation: str
    base_score: float

    @property
    def n_blocks(self) -> int:
        return self.m2.shape[0]


def to_wide(gf: GemmForest, tree_block: int | None = None) -> WideGemmForest:
    """Pack a GemmForest into block-diagonal wide operands (host, once)."""
    t, f, i = gf.a.shape
    l = gf.m2.shape[2]
    g = resolved_tree_block(i, t, tree_block)
    b = -(-t // g)
    tp = b * g

    def pad_trees(arr, fill=0.0):
        if tp == t:
            return arr
        width = [(0, tp - t)] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, width, constant_values=fill)

    a_p = pad_trees(gf.a)
    m2_p = pad_trees(gf.m2).reshape(b, g, i, l)
    a_w = np.ascontiguousarray(a_p.reshape(b, g, f, i).transpose(0, 2, 1, 3).reshape(b, f, g * i))
    m2_w = np.zeros((b, g * i, g * l), dtype=np.float32)
    for gi in range(g):
        m2_w[:, gi * i:(gi + 1) * i, gi * l:(gi + 1) * l] = m2_p[:, gi]
    dleft_w = None if gf.dleft is None else pad_trees(gf.dleft).reshape(b, g * i)
    return WideGemmForest(
        a=a_w, thr=pad_trees(gf.thr).reshape(b, g * i), m2=m2_w,
        c=pad_trees(gf.c).reshape(b, g * l), plen=pad_trees(gf.plen, fill=-1.0).reshape(b, g * l),
        value=pad_trees(gf.value).reshape(b, g, l), dleft=dleft_w,
        n_trees=t, tree_block=g, aggregation=gf.aggregation, base_score=gf.base_score)


def max_tree_leaves(forest: FlatForest) -> int:
    """Reachable leaves of the biggest tree (full binary trees: internal nodes + 1)."""
    return int((forest.feature != LEAF).sum(axis=1).max()) + 1


def requested_strategy() -> str:
    """``VCTPU_FOREST_STRATEGY`` through the knob registry, trimmed and
    lower-cased (unset or empty: ``auto``); a value outside
    :data:`FOREST_STRATEGIES` raises EngineError."""
    return knobs.get_str(FOREST_STRATEGY_ENV)


def validate_strategy_env() -> None:
    """Check the strategy request up front, before any scoring (CLI exit 2)."""
    requested_strategy()


def resolve_strategy(forest: FlatForest, device: torch.device) -> str:
    """The strategy a run scores with, decided once per run and recorded.

    ``auto``: on the CPU the gather walk (as the reference's CPU program);
    on the card the gather walk for trees beyond GEMM_MAX_LEAVES leaves and
    ``cuda-wide`` for every other forest, with or without default_left
    (missing-value) routing, as the reference's ``auto`` resolves to its
    ``wide``. An explicit ``gemm`` is honoured at any tree size, as in the
    reference, and so is an explicit ``wide``, on the card and on the CPU:
    the wide kernel walks trees too large for its shared memory from device
    memory. ``pallas`` names the reference's Pallas wide-block kernel, whose
    counterpart here is ``wide``; like that kernel it refuses default_left
    forests (EngineError).
    """
    req = requested_strategy()
    on_card = device.type == "cuda"
    if req == "gather" or (req == "auto" and (not on_card or max_tree_leaves(forest) > GEMM_MAX_LEAVES)):
        return "gather"
    if req == "pallas" and forest.default_left is not None:
        raise EngineError(
            f"forest strategy 'pallas' was explicitly requested ({FOREST_STRATEGY_ENV}) but the Pallas "
            "wide-block kernel does not implement default_left (missing-value) routing; rerun with "
            f"{FOREST_STRATEGY_ENV}=wide, gemm or auto")
    kind = "gemm" if req == "gemm" else "wide"
    return f"cuda-{kind}" if on_card else kind


def make_margin_predictor(forest: FlatForest, n_features: int, strategy: str,
                          device: torch.device):
    """fn(x: (N, F) float32 tensor on ``device``) -> (N,) float32 margins."""
    if strategy == "gather":
        return lambda x: predict_margin(forest, x)
    if strategy in ("cuda-wide", "wide"):
        from variantcalling_tpu_torch.models.forest_cuda import WideForestKernel

        return WideForestKernel(forest, n_features, device)
    if strategy in ("cuda-gemm", "gemm"):
        from variantcalling_tpu_torch.models.forest_cuda import TreeStepKernel

        return TreeStepKernel(to_gemm(forest, n_features), device)
    raise ValueError(f"unknown forest strategy {strategy!r} (expected one of {STRATEGIES})")


#: rows a :func:`predict_score` margin launch scores at most (the filter pipeline's chunk)
SCORE_CHUNK = 1 << 18


def xla_finalize(margin: torch.Tensor, forest: FlatForest, jit: bool = False) -> np.ndarray:
    """The reference's device finalize of a margin (``_device_finalize``),
    replayed in float32 on the host as XLA's CPU backend computes it:
    ``logit_sum`` through :func:`ops.math.sigmoid_f32` (NumPy's ``exp``, the
    one :func:`finalize_margin` uses, differs from XLA's in the last place on
    about a sixth of float32 inputs); ``mean`` as a true division, or, where
    the reference divides inside ``jax.jit`` (``jit``), as XLA rewrites a
    division by a constant: a product with the float32 reciprocal."""
    from variantcalling_tpu_torch.ops.math import sigmoid_f32

    m = margin.detach().to("cpu", torch.float32)
    if forest.aggregation == "mean":
        n = np.float32(forest.n_trees)
        return (m * float(np.float32(1.0) / n)).numpy() if jit else (m / float(n)).numpy()
    if forest.aggregation == "logit_sum":
        return sigmoid_f32(m + float(np.float32(forest.base_score))).numpy()
    raise ValueError(f"unknown aggregation {forest.aggregation!r}")


def predict_score(forest: FlatForest, x: np.ndarray, device: torch.device, jit: bool = False) -> np.ndarray:
    """Scores of a (N, F) float32 matrix: the reference's ``predict_score``
    (``jit``: its ``jax.jit(make_predictor(...))``) composed from the port's
    parts. The margins come from the strategy :func:`resolve_strategy` picks
    for ``device`` (``cuda-wide`` on the card under ``auto``; on the CPU the
    gather walk), :data:`SCORE_CHUNK` rows a launch; the card returns
    margins and the score is finalized on the host (:func:`xla_finalize`)."""
    fn = make_margin_predictor(forest, x.shape[1], resolve_strategy(forest, device), device)
    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    parts = [fn(xt[lo: lo + SCORE_CHUNK].to(device)).cpu() for lo in range(0, len(xt), SCORE_CHUNK)]
    margin = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.float32)
    return xla_finalize(margin, forest, jit=jit)


def from_sklearn(clf, feature_names: list[str] | None = None, pass_threshold: float = 0.5) -> FlatForest:
    """Flatten a fitted sklearn RandomForestClassifier/DecisionTree ensemble
    (``x[f] <= threshold`` goes left; leaf value = class-1 fraction; mean)."""
    raw = getattr(clf, "estimators_", None)
    if raw is None:
        estimators = [clf]
    elif isinstance(raw, np.ndarray):
        # GradientBoosting: (n_stages, n_classes) regressor trees -> boosted margin
        if raw.ndim == 2 and raw.shape[1] != 1:
            raise ValueError("only binary-class boosted ensembles are supported")
        return _from_sklearn_gbt(clf, raw.ravel().tolist(), feature_names, pass_threshold)
    else:
        estimators = list(raw)
    feature, threshold, left, right = _flatten_sklearn_trees(estimators)
    value = np.zeros(feature.shape, dtype=np.float32)
    for ti, est in enumerate(estimators):
        tr = est.tree_
        nc = tr.node_count
        counts = tr.value[:, 0, :]  # (nc, n_classes) class sample fractions
        if counts.shape[1] == 2:
            denom = counts.sum(axis=1)
            value[ti, :nc] = np.where(denom > 0, counts[:, 1] / np.maximum(denom, 1e-12), 0.0)
        else:  # degenerate single-class fit: every leaf predicts that class
            classes = getattr(est, "classes_", getattr(clf, "classes_", np.array([1])))
            value[ti, :nc] = 1.0 if classes[0] == 1 else 0.0
    return FlatForest(feature=feature, threshold=threshold, left=left, right=right, value=value,
                      max_depth=max(1, max(int(e.tree_.max_depth) for e in estimators)),
                      aggregation="mean", feature_names=feature_names or [],
                      pass_threshold=pass_threshold)


def _flatten_sklearn_trees(estimators: list):
    """(feature, threshold, left, right) arrays of a list of sklearn trees.

    sklearn compares float32-cast x against float64 thresholds; storing the
    largest float32 <= threshold keeps ``x <= thr`` decisions identical.
    """
    m = max(e.tree_.node_count for e in estimators)
    t = len(estimators)
    feature = np.full((t, m), LEAF, dtype=np.int32)
    threshold = np.zeros((t, m), dtype=np.float32)
    left = np.zeros((t, m), dtype=np.int32)
    right = np.zeros((t, m), dtype=np.int32)
    for ti, est in enumerate(estimators):
        tr = est.tree_
        nc = tr.node_count
        is_leaf = tr.children_left == -1
        feature[ti, :nc] = np.where(is_leaf, LEAF, tr.feature.astype(np.int32))
        thr64 = tr.threshold
        thr32 = thr64.astype(np.float32)
        too_big = thr32.astype(np.float64) > thr64
        thr32[too_big] = np.nextafter(thr32[too_big], np.float32(-np.inf))
        threshold[ti, :nc] = thr32
        node_ids = np.arange(nc, dtype=np.int32)
        left[ti, :nc] = np.where(is_leaf, node_ids, tr.children_left)
        right[ti, :nc] = np.where(is_leaf, node_ids, tr.children_right)
    return feature, threshold, left, right


def _from_sklearn_gbt(clf, trees: list, feature_names: list[str] | None,
                      pass_threshold: float) -> FlatForest:
    """Flatten a fitted binary GradientBoostingClassifier:
    score = sigmoid(init_log_odds + lr * sum(tree margins))."""
    lr = float(getattr(clf, "learning_rate", 1.0))
    base = 0.0
    init = getattr(clf, "init_", None)
    if init is not None and hasattr(init, "class_prior_"):
        p1 = float(np.clip(init.class_prior_[-1], 1e-12, 1 - 1e-12))
        base = float(np.log(p1 / (1 - p1)))
    feature, threshold, left, right = _flatten_sklearn_trees(trees)
    value = np.zeros(feature.shape, dtype=np.float32)
    for ti, est in enumerate(trees):
        value[ti, :est.tree_.node_count] = lr * est.tree_.value[:, 0, 0]
    return FlatForest(feature=feature, threshold=threshold, left=left, right=right, value=value,
                      max_depth=max(1, max(int(e.tree_.max_depth) for e in trees)),
                      aggregation="logit_sum", base_score=base,
                      feature_names=feature_names or [], pass_threshold=pass_threshold)


def with_feature_order(forest: FlatForest, feature_names: list[str]) -> FlatForest:
    """Remap node feature indices to a new feature-column order."""
    if not forest.feature_names or forest.feature_names == feature_names:
        return forest
    mapping = np.asarray([feature_names.index(f) for f in forest.feature_names], dtype=np.int32)
    new_feat = np.where(forest.feature == LEAF, LEAF, mapping[np.maximum(forest.feature, 0)])
    return replace(forest, feature=new_feat.astype(np.int32), feature_names=list(feature_names))
