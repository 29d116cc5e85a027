"""Carry a model's weights across from the JAX package's arrays.

Each function builds one of the port's models from the reference model's
numpy arrays and metadata, e.g.::

    ref = <variantcalling_tpu FlatForest>
    arrays = {k: np.asarray(getattr(ref, k)) for k in REFERENCE_ARRAYS}
    forest = forest_from_reference(arrays, max_depth=ref.max_depth,
                                   aggregation=ref.aggregation, ...)

    ref = <variantcalling_tpu DanModel>
    dan = dan_from_reference(ref.params_np, dataclasses.asdict(ref.cfg),
                             feature_names=ref.feature_names, ...)

and a DAN training run's state (numpy in, the port's tensors out)::

    params = dan_params_from_reference({k: np.asarray(v) for k, v in jax_params.items()})
    adam, *_ = jax_opt_state                      # optax.adamw: (ScaleByAdamState, ...)
    state = adam_state_from_reference(np.asarray(adam.count),
                                      {k: np.asarray(v) for k, v in adam.mu.items()},
                                      {k: np.asarray(v) for k, v in adam.nu.items()})
"""

from __future__ import annotations

import numpy as np

import torch

from variantcalling_tpu_torch.models.dan import AdamState, DanConfig, DanModel, param_names
from variantcalling_tpu_torch.models.forest import FlatForest
from variantcalling_tpu_torch.models.threshold import ThresholdModel

REFERENCE_ARRAYS = ("feature", "threshold", "left", "right", "value", "default_left")
_DTYPES = {"feature": np.int32, "threshold": np.float32, "left": np.int32,
           "right": np.int32, "value": np.float32, "default_left": bool}


def forest_from_reference(arrays: dict[str, np.ndarray], **meta) -> FlatForest:
    """``arrays``: feature/threshold/left/right/value (and optional default_left),
    each (T, M); ``meta``: max_depth, aggregation, base_score, feature_names,
    pass_threshold."""
    missing = [k for k in REFERENCE_ARRAYS[:5] if k not in arrays]
    if missing:
        raise KeyError(f"forest arrays missing {missing}")
    unknown = set(arrays) - set(REFERENCE_ARRAYS)
    if unknown:
        raise KeyError(f"unknown forest arrays {sorted(unknown)}")
    cols = {k: None if arrays.get(k) is None else np.array(arrays[k], dtype=_DTYPES[k])
            for k in REFERENCE_ARRAYS}
    shape = cols["feature"].shape
    for k, v in cols.items():
        if v is not None and v.shape != shape:
            raise ValueError(f"forest array {k} has shape {v.shape}, expected {shape}")
    meta = dict(meta)
    meta["max_depth"] = int(meta["max_depth"])
    if "feature_names" in meta:
        meta["feature_names"] = list(meta["feature_names"])
    return FlatForest(**cols, **meta)


def dan_from_reference(params_np: dict[str, np.ndarray], cfg_fields: dict, feature_names: list[str],
                       numeric_features: list[str], pass_threshold: float = 0.5,
                       norm_mu: np.ndarray | None = None, norm_sd: np.ndarray | None = None) -> DanModel:
    """``params_np``: the reference DAN's parameters (motif_embed, w_in, b_in,
    w_i/b_i, w_out, b_out) as numpy; ``cfg_fields``: its DanConfig's fields."""
    cfg = DanConfig(**cfg_fields)
    if set(params_np) != set(param_names(cfg.n_layers)):
        raise KeyError(f"DAN parameters {sorted(params_np)} are not {param_names(cfg.n_layers)}")
    in_dim = cfg.n_numeric + 2 * cfg.embed_dim
    if np.shape(params_np["w_in"]) != (in_dim, cfg.hidden) or len(numeric_features) != cfg.n_numeric:
        raise ValueError(f"w_in {np.shape(params_np['w_in'])} and {len(numeric_features)} numeric features "
                         f"do not fit the config (in_dim {in_dim}, hidden {cfg.hidden})")

    def f32(a):
        return None if a is None else np.array(a, dtype=np.float32)

    return DanModel(cfg=cfg, params_np={k: f32(v) for k, v in params_np.items()},
                    feature_names=list(feature_names), numeric_features=list(numeric_features),
                    pass_threshold=float(pass_threshold), norm_mu=f32(norm_mu), norm_sd=f32(norm_sd))


def dan_params_from_reference(params_np: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The reference DAN's parameters (numpy) as the port's float32 CPU
    tensors, in the reference's order (``init_params``'s)."""
    order = param_names(1 + sum(k.startswith("w_") and k[2:].isdigit() for k in params_np))
    if set(params_np) != set(order):
        raise KeyError(f"DAN parameters {sorted(params_np)} are not the reference's {order}")
    return {k: torch.from_numpy(np.array(params_np[k], dtype=np.float32)) for k in order}


def adam_state_from_reference(count, mu: dict[str, np.ndarray], nu: dict[str, np.ndarray]) -> AdamState:
    """optax's ``ScaleByAdamState`` (count, mu, nu as numpy) as the port's
    :class:`~variantcalling_tpu_torch.models.dan.AdamState`."""
    if set(mu) != set(nu):
        raise KeyError(f"mu {sorted(mu)} and nu {sorted(nu)} name different parameters")
    return AdamState(torch.tensor(int(np.asarray(count)), dtype=torch.int32),
                     dan_params_from_reference(mu), dan_params_from_reference(nu))


def threshold_from_reference(feature_names: list[str], thresholds, signs, scales,
                             pass_threshold: float = 0.5,
                             all_feature_names: list[str] | None = None) -> ThresholdModel:
    """The reference ThresholdModel's fields -> the port's."""
    cols = [np.array(a, dtype=np.float32) for a in (thresholds, signs, scales)]
    if any(c.shape != (len(feature_names),) for c in cols):
        raise ValueError(f"thresholds/signs/scales must each hold {len(feature_names)} values")
    return ThresholdModel(list(feature_names), *cols, pass_threshold=float(pass_threshold),
                          all_feature_names=list(all_feature_names or []))
