"""Model container: named-model pickles ``{model_name: model}``.

Counterpart of ``variantcalling_tpu/models/registry.py``. The reference's
``train_models_pipeline`` writes one pickle holding {rf, threshold} x
{use_gt, ignore_gt} x {incl, excl hpol runs}; its classes are named by
module path, and the unpickler here maps those names onto the port's
:class:`FlatForest`, :class:`ThresholdModel`, :class:`DanModel` and
:class:`DanConfig` (a name mapping, not an import). A pickle that holds
JAX arrays raises. Raw sklearn estimators are flattened with
:func:`forest.from_sklearn` on load.

The scoring family of a run (``VCTPU_MODEL_FAMILY``, :func:`requested_family`)
is ``auto`` (the loaded model's) or an explicit ``forest`` or ``dan``,
which the loaded model must be of (:func:`resolve_family`).
"""

from __future__ import annotations

import copyreg
import dataclasses
import io
import os
import pickle

from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.engine import EngineError
from variantcalling_tpu_torch.models.dan import DanConfig, DanModel
from variantcalling_tpu_torch.models.forest import FlatForest, from_sklearn
from variantcalling_tpu_torch.models.threshold import ThresholdModel
from variantcalling_tpu_torch.models.xgb import from_xgboost, from_xgboost_json, looks_like_xgboost

MODEL_NAME_PATTERN = "{family}_model_{gt}_{hpol}"  # e.g. rf_model_ignore_gt_incl_hpol_runs

# "forest" covers every tree-shaped scorer (FlatForest and what _coerce
# turns into one); the name prefixes of MODEL_NAME_PATTERN map onto these
FAMILIES = ("forest", "threshold", "dan")
_NAME_PREFIX_FAMILY = {"rf": "forest", "xgb": "forest", "threshold": "threshold", "dan": "dan"}

#: the run's family request: auto|forest|dan (a threshold model is reached through auto)
MODEL_FAMILY_ENV = "VCTPU_MODEL_FAMILY"
FAMILY_REQUESTS = knobs.REGISTRY[MODEL_FAMILY_ENV].choices  # auto forest dan

_REFERENCE_PACKAGE = "variantcalling_tpu"
_REFERENCE_CLASSES = {
    ("variantcalling_tpu.models.forest", "FlatForest"): FlatForest,
    ("variantcalling_tpu.models.threshold", "ThresholdModel"): ThresholdModel,
    ("variantcalling_tpu.models.dan", "DanModel"): DanModel,
    ("variantcalling_tpu.models.dan", "DanConfig"): DanConfig,
}


def family_of(model: object) -> str:
    """The scoring family of a loaded model."""
    if isinstance(model, DanModel):
        return "dan"
    if isinstance(model, ThresholdModel):
        return "threshold"
    return "forest"


def family_of_name(model_name: str) -> str | None:
    """The family a registry model name implies (``rf_model_...`` -> forest),
    or None when the name follows no known pattern."""
    prefix = model_name.split("_model_", 1)[0] if "_model_" in model_name else model_name
    return _NAME_PREFIX_FAMILY.get(prefix)


def standard_model_names(families=("rf", "threshold")) -> list[str]:
    names = []
    for fam in families:
        for gt in ("ignore_gt", "use_gt"):
            for hpol in ("incl_hpol_runs", "excl_hpol_runs"):
                names.append(MODEL_NAME_PATTERN.format(family=fam, gt=gt, hpol=hpol))
    return names


def requested_family() -> str:
    """The validated ``VCTPU_MODEL_FAMILY`` request, through the knob registry
    (unset or empty: auto); a malformed value raises :class:`EngineError`
    (CLI exit 2)."""
    return knobs.get_str(MODEL_FAMILY_ENV)


def resolve_family(model: object, requested: str) -> str:
    """The family that scores the run: the model's own; an explicit request
    for another family raises :class:`EngineError`."""
    fam = family_of(model)
    if requested != "auto" and requested != fam:
        raise EngineError(
            f"{MODEL_FAMILY_ENV}={requested} was explicitly requested but the loaded model is "
            f"family {fam!r} ({type(model).__name__}) — point --model_file/--model_name at a "
            f"{requested} model or rerun with {MODEL_FAMILY_ENV}=auto. See docs/models.md.")
    return fam


#: the port's model classes -> the reference's (module, name) a pickle names them by
_PORT_TO_REFERENCE = {cls: key for key, cls in _REFERENCE_CLASSES.items()}


class _ReferencePickler(pickle._Pickler):
    """A plain pickle whose model classes are the reference's.

    A port model is written as ``copyreg.__newobj__`` of the reference's
    class (``variantcalling_tpu.models.forest.FlatForest``, ...) with the
    dataclass's field dict as its state, which is what the reference's own
    dataclasses pickle to. The standard picklers check a class reference by
    importing its module; the port may not import the reference (and the
    card's machine does not have it), so these four names are written
    without that check. Everything else pickles as ``pickle.dump`` does."""

    def reducer_override(self, obj):
        if type(obj) not in _PORT_TO_REFERENCE:
            return NotImplemented
        state = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
        for name, value in state.items():
            arrays = value.values() if isinstance(value, dict) else (value,)
            if any(type(a).__module__.split(".")[0] == "torch" for a in arrays):
                raise TypeError(f"{type(obj).__name__}.{name} holds a torch object; a model pickle "
                                "holds numpy arrays only")
        return copyreg.__newobj__, (type(obj),), state

    def save_global(self, obj, name=None):
        ref = _PORT_TO_REFERENCE.get(obj) if isinstance(obj, type) else None
        if ref is None:
            return super().save_global(obj, name)
        module, qualname = ref
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def dumps_models(models: dict[str, object]) -> bytes:
    """The pickle bytes of a ``{name: model}`` dict, classes named as the
    reference names them (:class:`_ReferencePickler`)."""
    buf = io.BytesIO()
    _ReferencePickler(buf, protocol=pickle.DEFAULT_PROTOCOL).dump(models)
    return buf.getvalue()


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        hit = _REFERENCE_CLASSES.get((module, name))
        if hit is not None:
            return hit
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
    """Atomic write (tmp + rename) of a ``{name: model}`` pickle that the
    reference's ``load_models`` reads into its own classes (:func:`dumps_models`)."""
    data = dumps_models(models)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(data)
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
        # name the missing family, not just the key
        requested = family_of_name(model_name)
        present = sorted({family_of(m) for m in models.values()})
        hint = ""
        if requested is not None and requested not in present:
            hint = f"; no {requested!r}-family model in this file (families present: {present})"
        raise KeyError(f"model {model_name!r} not in {sorted(models)} (file: {path}){hint}")
    return models[model_name]


def _coerce(model: object) -> object:
    if isinstance(model, (FlatForest, ThresholdModel, DanModel)):
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
