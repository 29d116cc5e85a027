"""Carry a forest's weights across from the JAX package's arrays.

``forest_from_reference`` builds the port's :class:`FlatForest` from the
reference forest's numpy arrays and metadata, e.g.::

    ref = <variantcalling_tpu FlatForest>
    arrays = {k: np.asarray(getattr(ref, k)) for k in REFERENCE_ARRAYS}
    forest = forest_from_reference(arrays, max_depth=ref.max_depth,
                                   aggregation=ref.aggregation, ...)
"""

from __future__ import annotations

import numpy as np

from variantcalling_tpu_torch.models.forest import FlatForest

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
