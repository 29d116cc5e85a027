"""Model container: named-model pickles ``{model_name: model}``.

Counterpart of ``variantcalling_tpu/models/registry.py``. Pickles written
by the reference name its forest class by module path; the unpickler here
maps that name onto the port's :class:`FlatForest` (a name mapping, not an
import). Threshold and DAN models are not ported yet and raise; a pickle
that holds JAX arrays raises too. Raw sklearn estimators are flattened
with :func:`forest.from_sklearn` on load.
"""

from __future__ import annotations

import os
import pickle

from variantcalling_tpu_torch.models.forest import FlatForest, from_sklearn
from variantcalling_tpu_torch.models.xgb import from_xgboost, from_xgboost_json, looks_like_xgboost

_REFERENCE_PACKAGE = "variantcalling_tpu"
_REFERENCE_CLASSES = {("variantcalling_tpu.models.forest", "FlatForest"): FlatForest}
_NOT_YET_PORTED = {
    "variantcalling_tpu.models.threshold": "threshold models",
    "variantcalling_tpu.models.dan": "DAN models",
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        hit = _REFERENCE_CLASSES.get((module, name))
        if hit is not None:
            return hit
        if module in _NOT_YET_PORTED:
            raise NotImplementedError(f"{_NOT_YET_PORTED[module]} ({module}.{name}) are not yet ported")
        if module == _REFERENCE_PACKAGE or module.startswith(_REFERENCE_PACKAGE + "."):
            raise NotImplementedError(f"{module}.{name} is not yet ported")
        if module == "jax" or module.startswith(("jax.", "jaxlib")):
            raise NotImplementedError(
                f"the pickle holds JAX objects ({module}.{name}); re-save its arrays as numpy")
        try:
            return super().find_class(module, name)
        except ModuleNotFoundError as e:
            if module.split(".")[0] != "xgboost":
                raise
            raise ModuleNotFoundError(
                f"the pickle holds xgboost objects ({module}.{name}), which need the xgboost "
                "package to load; save the model as JSON (Booster.save_model('model.json')) "
                "and pass the .json file") from e


def save_models(path: str, models: dict[str, object]) -> None:
    """Atomic write (tmp + rename) of a ``{name: model}`` pickle."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        pickle.dump(models, fh)
    os.replace(tmp, path)


def load_models(path: str) -> dict[str, object]:
    if path.endswith(".json"):  # a bare xgboost JSON model file (Booster.save_model output)
        return {"model": from_xgboost_json(path)}
    with open(path, "rb") as fh:
        models = _Unpickler(fh).load()
    if not isinstance(models, dict):
        models = {"model": models}
    if isinstance(models.get("learner"), dict) and "gradient_booster" in models["learner"]:
        # the pickle is one parsed xgboost JSON model, not a name -> model map
        return {"model": from_xgboost_json(models)}
    return {k: _coerce(v) for k, v in models.items()}


def load_model(path: str, model_name: str) -> object:
    models = load_models(path)
    if model_name not in models:
        raise KeyError(f"model {model_name!r} not in {sorted(models)} (file: {path})")
    return models[model_name]


def _coerce(model: object) -> object:
    if isinstance(model, FlatForest):
        return model
    if looks_like_xgboost(model):  # XGBClassifier / Booster: its own JSON dump is the exact source
        return from_xgboost(model)
    if isinstance(model, dict) and "learner" in model:
        return from_xgboost_json(model)
    if hasattr(model, "tree_") or hasattr(model, "estimators_"):
        # the fitted column order rides along: the pipeline reorders model
        # features onto its own layout by name
        fni = getattr(model, "feature_names_in_", None)
        return from_sklearn(model, feature_names=None if fni is None else list(fni))
    raise NotImplementedError(f"model type {type(model).__name__} is not yet ported")
