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
depend on how the rows were chunked. Training (``init_params``, the
optimiser, ``train_step``) waits for the training slice.
"""

from __future__ import annotations

import contextlib
import hashlib
from dataclasses import dataclass, field

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
