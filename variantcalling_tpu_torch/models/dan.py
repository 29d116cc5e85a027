"""Neural variant-filter model (deep averaging network), scored in torch.

Counterpart of ``variantcalling_tpu/models/dan.py``: an embedding + MLP
scorer over the per-variant features. Motif codes get learned embeddings,
numeric features are normalised, and ``n_layers`` GELU layers lead to one
logit. The field names of :class:`DanConfig` and :class:`DanModel` are the
reference's, so its pickles unpickle into them (``models/registry.py``).

Serving is f32 end to end whatever the model was trained in
(:func:`make_score_predictor`): the products are ``torch.matmul`` (cuBLAS
on the card) in full float32, never TF32, and each call sees the same
shapes (rows in blocks of :data:`ROW_BLOCK`) so that a row's score does not
depend on how the rows were chunked.

Training follows the reference line by line: :func:`init_params` (its
shapes, scales, zero heads and key names, drawn from a seeded
``torch.Generator`` on the CPU, so the card and the CPU start alike),
:func:`forward` in the config's dtype (bf16 products, bias adds and GELUs
by explicit casts, the logit in f32), :func:`loss_fn` (weighted BCE over
``max(sum w, 1)``), AdamW in optax's order (:func:`adamw_init`,
:func:`adamw_update`: the state is ``count``, ``mu`` and ``nu`` as optax's
``ScaleByAdamState`` holds them) and :func:`train_step`. The motif lookup
is ``F.embedding``, whose backward on the card sorts its indices (an
accumulating ``index_put_`` would add in a different order each run).
"""

from __future__ import annotations

import contextlib
import hashlib
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from variantcalling_tpu_torch.engine import EngineError

MOTIF_VOCAB = 5**5  # base-5 packed 5-mers (A,C,G,T,N)

FAMILY_HEADER_KEY = "vctpu_model_family"

#: rows per forward call: the scorer pads the last block, so every product
#: has the same shape and cuBLAS the same kernel whatever the caller's chunks
#: (a quarter of the pipeline's 2^18-row chunk, so full chunks pad nothing)
ROW_BLOCK = 1 << 16


@dataclass(frozen=True)
class DanConfig:
    n_numeric: int  # numeric feature count (feature matrix minus motif columns)
    embed_dim: int = 16
    hidden: int = 256
    n_layers: int = 2
    dtype: str = "bfloat16"
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4


@dataclass
class DanModel:
    """Pickle-able container compatible with the model registry."""

    cfg: DanConfig
    params_np: dict  # numpy copies of params
    feature_names: list[str] = field(default_factory=list)
    numeric_features: list[str] = field(default_factory=list)
    pass_threshold: float = 0.5
    norm_mu: np.ndarray | None = None  # numeric normalization (train_dan)
    norm_sd: np.ndarray | None = None

    @staticmethod
    def from_params(cfg, params, feature_names, numeric_features, pass_threshold=0.5) -> "DanModel":
        return DanModel(
            cfg=cfg,
            params_np={k: np.asarray(v) for k, v in params.items()},
            feature_names=list(feature_names),
            numeric_features=list(numeric_features),
            pass_threshold=pass_threshold,
        )


def weights_digest(model: DanModel) -> str:
    """Content address of a DAN's weights and scoring metadata (the
    reference's digest: the same model gives the same hex in both packages)."""
    h = hashlib.sha256()
    h.update(repr(model.cfg).encode())
    h.update(repr((model.feature_names, model.numeric_features,
                   float(model.pass_threshold))).encode())
    for k in sorted(model.params_np):
        a = np.ascontiguousarray(model.params_np[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    for norm in (model.norm_mu, model.norm_sd):
        if norm is None:
            h.update(b"none")
        else:
            h.update(np.ascontiguousarray(norm, np.float32).tobytes())
    return h.hexdigest()


def _legacy_precision() -> str:
    """``torch.get_float32_matmul_precision()``, or, where a caller has set the
    backends apart through their own settings (the getter then refuses),
    the value the CUDA matmul setting implies."""
    try:
        return torch.get_float32_matmul_precision()
    except RuntimeError:
        return "high" if torch.backends.cuda.matmul.fp32_precision == "tf32" else "highest"


@contextlib.contextmanager
def full_float32():
    """Matrix products in full float32 inside: no TF32 on the card, no bfloat16
    in oneDNN on the CPU, whatever the caller set (``allow_tf32``,
    ``set_float32_matmul_precision``, the per-backend ``fp32_precision``); the
    caller's settings restored exactly after."""
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    saved = _legacy_precision(), [b.fp32_precision for b in backends]
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        for b, precision in zip(backends, saved[1]):
            b.fp32_precision = precision


class DanScorer(nn.Module):
    """TREE_SCORE of a DAN over the run's (N, F) float32 feature matrix.

    Columns are picked by name once (:func:`make_score_predictor`); each
    forward call runs the rows in blocks of :data:`ROW_BLOCK`, the last one
    padded, in full float32.
    """

    def __init__(self, model: DanModel, feature_names: list[str], device: torch.device):
        super().__init__()
        idx = {f: i for i, f in enumerate(feature_names)}
        needed = [*model.numeric_features, "left_motif", "right_motif"]
        missing = [f for f in needed if f not in idx]
        if missing:
            raise EngineError(f"dan model needs feature(s) {missing} absent from the run's "
                              f"feature layout {sorted(idx)}")
        self.n_layers = model.cfg.n_layers

        def buf(name: str, a, dtype=torch.float32) -> None:
            self.register_buffer(name, torch.as_tensor(np.asarray(a), device=device).to(dtype))

        buf("num_idx", [idx[f] for f in model.numeric_features], torch.int64)
        self.left, self.right = idx["left_motif"], idx["right_motif"]
        for k, v in model.params_np.items():
            buf(k, np.asarray(v, dtype=np.float32))
        self.normalize = model.norm_mu is not None
        if self.normalize:
            buf("mu", np.asarray(model.norm_mu, np.float32))
            buf("sd", np.maximum(np.asarray(model.norm_sd, np.float32), 1e-6))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Logit per row of one block; the products at whatever shape ``x`` has."""
        numeric = x.index_select(1, self.num_idx)
        if self.normalize:
            numeric = (numeric - self.mu) / self.sd
        ml = x[:, self.left].to(torch.int32).clamp_(0, MOTIF_VOCAB - 1)
        mr = x[:, self.right].to(torch.int32).clamp_(0, MOTIF_VOCAB - 1)
        h = torch.cat([numeric, self.motif_embed[ml], self.motif_embed[mr]], dim=1)
        h = F.gelu(h @ self.w_in + self.b_in, approximate="tanh")
        for i in range(self.n_layers - 1):
            h = F.gelu(h @ getattr(self, f"w_{i}") + getattr(self, f"b_{i}"), approximate="tanh")
        return (h @ self.w_out + self.b_out)[:, 0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        out = torch.empty(n, dtype=torch.float32, device=x.device)
        with full_float32(), torch.no_grad():
            for lo in range(0, n, ROW_BLOCK):
                block = x.new_zeros((ROW_BLOCK, x.shape[1]))
                block[: min(ROW_BLOCK, n - lo)] = x[lo: lo + ROW_BLOCK]
                out[lo: lo + ROW_BLOCK] = torch.sigmoid(self.logits(block))[: min(ROW_BLOCK, n - lo)]
        return out


def make_score_predictor(model: DanModel, feature_names: list[str], device: torch.device | str) -> DanScorer:
    """The DAN's scorer over the run's feature layout: fn(x: (N, F) float32 on
    ``device``) -> (N,) float32 scores.

    As the reference's: columns by name (a missing one raises
    :class:`EngineError`), ``sd`` clamped at 1e-6, motif codes cast to int
    and clipped to ``[0, 5^5)``, f32 end to end (the training dtype does
    not apply), GELU in its tanh form (``jax.nn.gelu``'s default).
    """
    return DanScorer(model, feature_names, torch.device(device))


# -- training ------------------------------------------------------------------

#: optax.adamw's defaults, which the reference's ``make_optimizer`` keeps
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_COUNT_MAX = (1 << 31) - 1  # optax's safe_increment saturates its int32 count


def param_names(n_layers: int) -> list[str]:
    """The parameters' names of a DAN of ``n_layers`` in the reference's order."""
    return ["motif_embed", "w_in", "b_in", "w_out", "b_out",
            *(f"{p}_{i}" for i in range(n_layers - 1) for p in "wb")]


def init_params(cfg: DanConfig, seed: int, device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """The reference's initial parameters in shape and scale: normal motif
    embeddings times 0.02, normal ``w_in`` and hidden weights over the
    square root of their fan-in, zero biases and a zero output head. Drawn
    in float32 on the CPU from ``torch.Generator().manual_seed(seed)``, then
    moved to ``device``. (``jax.random`` draws other numbers; tests carry the
    reference's weights across with :func:`convert.dan_params_from_reference`.)"""
    g = torch.Generator().manual_seed(int(seed))
    in_dim = cfg.n_numeric + 2 * cfg.embed_dim

    def normal(*shape: int, scale: float) -> torch.Tensor:
        return torch.randn(*shape, generator=g, dtype=torch.float32) * scale

    params = {
        "motif_embed": normal(MOTIF_VOCAB, cfg.embed_dim, scale=0.02),
        "w_in": normal(in_dim, cfg.hidden, scale=float(1.0 / np.sqrt(in_dim))),
        "b_in": torch.zeros(cfg.hidden),
        "w_out": torch.zeros(cfg.hidden, 1),
        "b_out": torch.zeros(1),
    }
    for i in range(cfg.n_layers - 1):
        params[f"w_{i}"] = normal(cfg.hidden, cfg.hidden, scale=float(1.0 / np.sqrt(cfg.hidden)))
        params[f"b_{i}"] = torch.zeros(cfg.hidden)
    return {k: v.to(device) for k, v in params.items()}


def forward(cfg: DanConfig, params: dict, numeric: torch.Tensor, motif_left: torch.Tensor,
            motif_right: torch.Tensor) -> torch.Tensor:
    """Logit per row in the config's dtype, as the reference's ``forward``:
    embeddings and numeric columns concatenated in f32 and cast, each
    product, bias add and tanh-GELU in that dtype, the logit cast to f32.
    A ``float32`` config should run inside :func:`full_float32`."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    emb = params["motif_embed"]
    x = torch.cat([numeric, F.embedding(motif_left, emb), F.embedding(motif_right, emb)], dim=1).to(dtype)
    h = F.gelu(x @ params["w_in"].to(dtype) + params["b_in"].to(dtype), approximate="tanh")
    for i in range(cfg.n_layers - 1):
        h = F.gelu(h @ params[f"w_{i}"].to(dtype) + params[f"b_{i}"].to(dtype), approximate="tanh")
    logit = h @ params["w_out"].to(dtype) + params["b_out"].to(dtype)
    return logit[:, 0].to(torch.float32)


def predict_score(cfg: DanConfig, params: dict, numeric, motif_left, motif_right) -> torch.Tensor:
    return torch.sigmoid(forward(cfg, params, numeric, motif_left, motif_right))


def loss_fn(cfg: DanConfig, params: dict, batch: dict) -> torch.Tensor:
    """Weighted BCE over the batch: ``sum(loss * w) / max(sum(w), 1)``, with
    ``w`` the batch's ``weight`` (ones without one) times its ``valid`` mask."""
    logits = forward(cfg, params, batch["numeric"], batch["motif_left"], batch["motif_right"])
    losses = F.binary_cross_entropy_with_logits(logits, batch["label"], reduction="none")
    w = batch.get("weight")
    if w is None:
        w = torch.ones_like(losses)
    valid = batch.get("valid")
    if valid is not None:
        w = w * valid.to(w.dtype)
    return torch.sum(losses * w) / torch.clamp(torch.sum(w), min=1.0)


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step ``count`` (a 0-d int32 tensor on
    the host), and the first and second moments of each parameter."""

    count: torch.Tensor
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def adamw_init(params: dict[str, torch.Tensor]) -> AdamState:
    return AdamState(torch.zeros((), dtype=torch.int32),
                     {k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()})


def adamw_update(cfg: DanConfig, grads: dict[str, torch.Tensor], state: AdamState,
                 params: dict[str, torch.Tensor]) -> tuple[dict[str, torch.Tensor], AdamState]:
    """One ``optax.adamw(cfg.learning_rate, weight_decay=cfg.weight_decay)``
    step and ``optax.apply_updates``, in optax's order: ``mu = (1-b1) g +
    b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, the count incremented (saturating),
    bias corrections ``1 - b^count`` in float32, ``u = mu_hat / (sqrt(nu_hat)
    + eps) + wd p`` on every parameter (optax's default mask), ``p + (-lr) u``.
    Multi-tensor (``torch._foreach_*``) ops: a few launches for all
    parameters. The count and the corrections are host scalars, so a step
    never waits for the card."""
    keys = list(params)
    g, p = [grads[k] for k in keys], [params[k] for k in keys]
    mu = torch._foreach_add(torch._foreach_mul(g, 1 - ADAM_B1),
                            torch._foreach_mul([state.mu[k] for k in keys], ADAM_B1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - ADAM_B2),
                            torch._foreach_mul([state.nu[k] for k in keys], ADAM_B2))
    count = state.count + 1 if int(state.count) < _COUNT_MAX else state.count.clone()
    c = count.to(torch.float32)
    one = torch.ones((), dtype=torch.float32)
    bc1 = (one - torch.pow(torch.tensor(ADAM_B1, dtype=torch.float32), c)).item()
    bc2 = (one - torch.pow(torch.tensor(ADAM_B2, dtype=torch.float32), c)).item()
    denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(denom, ADAM_EPS)
    upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    torch._foreach_add_(upd, torch._foreach_mul(p, cfg.weight_decay))
    torch._foreach_mul_(upd, -cfg.learning_rate)
    new_p = torch._foreach_add(p, upd)
    return dict(zip(keys, new_p)), AdamState(count, dict(zip(keys, mu)), dict(zip(keys, nu)))


def train_step(cfg: DanConfig, params: dict[str, torch.Tensor], opt_state: AdamState,
               batch: dict) -> tuple[dict[str, torch.Tensor], AdamState, torch.Tensor]:
    """Loss and gradients by ``torch.autograd`` over :func:`loss_fn`, then
    :func:`adamw_update`: the reference's jitted ``train_step``. Products in
    full float32 (no TF32) where the config is ``float32``. The loss comes
    back as a 0-d tensor on the parameters' device (reading it syncs)."""
    with full_float32():
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(cfg, leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            params, opt_state = adamw_update(cfg, dict(zip(leaves, grads)), opt_state, params)
    return params, opt_state, loss.detach()
