"""Accuracy metrics and recall/precision curves over a concordance frame.

Counterpart of ``variantcalling_tpu/concordance/concordance_utils.py``:
``category_masks``, ``passes_filter``, ``_classes``,
``calc_accuracy_metrics`` (the per-category [tp, fp, fn, precision, recall,
f1] at the filter's operating point) and ``calc_recall_precision_curve``
(the per-category score sweep and its max-F1 threshold). The frame is a
:class:`~variantcalling_tpu_torch.utils.h5_utils.Frame` (or any mapping of
numpy columns). The tally runs on the device it is given
(:func:`ops.concordance.grouped_confusion`), as the reference's runs on
its own; the categories and the curves are host numpy, as there.
"""

from __future__ import annotations

import numpy as np
import torch

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch.ops.concordance import accuracy_from_counts, grouped_confusion
from variantcalling_tpu_torch.utils.h5_utils import Frame
from variantcalling_tpu_torch.utils.stats_utils import precision_recall_curve

_HMER = "hmer_indel_length"


def default_categories() -> list[tuple[str, callable]]:
    return [
        ("SNP", lambda d: ~_indel(d)),
        ("Non-hmer INDEL", lambda d: _indel(d) & (_hmer(d) == 0)),
        ("HMER indel <= 4", lambda d: _indel(d) & (_hmer(d) > 0) & (_hmer(d) <= 4)),
        ("HMER indel (4:8]", lambda d: _indel(d) & (_hmer(d) > 4) & (_hmer(d) <= 8)),
        ("HMER indel [8:10]", lambda d: _indel(d) & (_hmer(d) > 8) & (_hmer(d) <= 10)),
        ("HMER indel 11:12", lambda d: _indel(d) & (_hmer(d) > 10) & (_hmer(d) <= 12)),
        ("HMER indel > 12", lambda d: _indel(d) & (_hmer(d) > 12)),
        ("INDELS", _indel),
    ]


def _text_len(values) -> np.ndarray:
    """Lengths of the values as text (a missing value: NaN, as pandas' string columns give)."""
    return np.asarray([np.nan if v is None else len(str(v)) for v in values], dtype=float)


def _indel(d: Frame) -> np.ndarray:
    """The ``indel`` column, else REF's length against the first ALT's."""
    if "indel" in d:
        return np.asarray(d["indel"], dtype=bool)
    alt = d["alleles"] if "alleles" in d else d["alt"]
    first = [None if v is None else str(v).split(",")[0] for v in alt]
    return _text_len(d["ref"]) != _text_len(first)


def _hmer(d: Frame) -> np.ndarray:
    if _HMER in d:
        return np.nan_to_num(np.asarray(d[_HMER], dtype=float)).astype(int)
    return np.zeros(len(d), dtype=int)


def category_masks(df: Frame, group_testing_column: str | None = None) -> tuple[list[str], np.ndarray]:
    """(names, (G, N) bool mask matrix) for default or custom grouping."""
    if group_testing_column and group_testing_column in df:
        values = np.asarray([str(v) for v in df[group_testing_column]], dtype=object)
        names = sorted(set(values))
        return names, np.stack([values == name for name in names])
    cats = default_categories()
    return [name for name, _ in cats], np.stack([np.asarray(sel(df), dtype=bool) for _, sel in cats])


def passes_filter(filters: np.ndarray, ignored_filters: list[str] | None) -> np.ndarray:
    """True where FILTER is PASS after dropping ``ignored_filters``: a
    variant filtered only by ignored filters still counts as passing."""
    ignored = set(ignored_filters or [])
    out = np.empty(len(filters), dtype=bool)
    for i, f in enumerate(filters):
        if f in ("PASS", ".", "", None):
            out[i] = True
        else:
            out[i] = not (set(str(f).split(";")) - ignored - {"PASS"})
    return out


def _classes(df: Frame, classify_column: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    cls = np.asarray(df[classify_column], dtype=object)  # None (missing) equals no class
    return cls == "tp", cls == "fp", cls == "fn"


def _obj(values) -> np.ndarray:
    """An object column of ``values`` (strings, or arrays: one a row)."""
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def calc_accuracy_metrics(
    df: Frame,
    classify_column: str,
    ignored_filters: list[str] | None = None,
    group_testing_column: str | None = None,
    device: torch.device | str = "gpu",
) -> Frame:
    """Per-category [tp, fp, fn, precision, recall, f1] at the filter
    operating point, the columns typed as the reference's frame (int64
    counts, float32 accuracy rounded to 5 places). The tally runs on
    ``device`` (a backend name goes through :func:`device.resolve`: the
    card unless ``"cpu"``); the counts come back to the host."""
    dev = device_mod.as_device(device)
    names, masks = category_masks(df, group_testing_column)
    is_tp, is_fp, is_fn = _classes(df, classify_column)
    filters = df["filter"] if "filter" in df else np.array(["PASS"] * len(df))
    pf = passes_filter(np.asarray(filters), ignored_filters)
    tensors = (torch.from_numpy(np.ascontiguousarray(a, dtype=bool)).to(dev) for a in (masks, is_tp, is_fp, is_fn, pf))
    counts = grouped_confusion(*tensors).cpu().numpy()
    acc = accuracy_from_counts(counts)
    return Frame({
        "group": _obj(names),
        "tp": counts[:, 0].astype(np.int64),
        "fp": counts[:, 1].astype(np.int64),
        "fn": counts[:, 2].astype(np.int64),
        "precision": np.round(acc[:, 0], 5),
        "recall": np.round(acc[:, 1], 5),
        "f1": np.round(acc[:, 2], 5),
    })


def calc_recall_precision_curve(
    df: Frame,
    classify_column: str,
    ignored_filters: list[str] | None = None,
    group_testing_column: str | None = None,
) -> Frame:
    """Per-category score sweep and max-F1 threshold: one row a category,
    ragged float64 ``predictions`` (the thresholds), ``precision``,
    ``recall`` and ``f1``, and the float64 ``threshold`` of the largest F1
    (0 where no F1 is finite). The sweep runs over the called variants
    (tp/fp); fns carry no score and enter through the curve's recall
    correction. ``ignored_filters`` is accepted as the reference accepts it
    and, as there, not used."""
    names, masks = category_masks(df, group_testing_column)
    is_tp, is_fp, is_fn = _classes(df, classify_column)
    scores = np.nan_to_num(np.asarray(df["tree_score"], dtype=float)) if "tree_score" in df else np.ones(len(df))
    curves, thresholds = {k: [] for k in ("predictions", "precision", "recall", "f1")}, []
    for m in masks:
        called = m & (is_tp | is_fp)
        prec, rec, f1, thr = precision_recall_curve(is_tp[m].astype(int), np.where(called[m], scores[m], 0.0),
                                                    is_fn[m])
        thresholds.append(float(thr[int(np.nanargmax(f1))]) if len(f1) and np.any(np.isfinite(f1)) else 0.0)
        for key, values in zip(("predictions", "precision", "recall", "f1"), (thr, prec, rec, f1)):
            curves[key].append(values)
    return Frame({"group": _obj(names), **{k: _obj(v) for k, v in curves.items()},
                  "threshold": np.asarray(thresholds, dtype=np.float64)})
