"""Accuracy metrics over a concordance frame, as far as ``train_models_pipeline`` needs them.

Counterpart of ``variantcalling_tpu/concordance/concordance_utils.py``:
``category_masks``, ``passes_filter``, ``_classes`` and
``calc_accuracy_metrics`` (the per-category [tp, fp, fn, precision, recall,
f1] at the filter's operating point). The frame is a
:class:`~variantcalling_tpu_torch.utils.h5_utils.Frame` (or any mapping of
numpy columns) with an ``indel`` column; the counts run on the CPU, a
tally of a few columns. The reference's recall/precision curves, and its
``indel`` from ``ref``/``alt`` columns, are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from variantcalling_tpu_torch.ops.concordance import accuracy_from_counts, grouped_confusion
from variantcalling_tpu_torch.utils.h5_utils import Frame

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


def _indel(d: Frame) -> np.ndarray:
    return np.asarray(d["indel"], dtype=bool)


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


def calc_accuracy_metrics(
    df: Frame,
    classify_column: str,
    ignored_filters: list[str] | None = None,
    group_testing_column: str | None = None,
) -> Frame:
    """Per-category [tp, fp, fn, precision, recall, f1] at the filter
    operating point, the columns typed as the reference's frame (int64
    counts, float32 accuracy rounded to 5 places)."""
    names, masks = category_masks(df, group_testing_column)
    is_tp, is_fp, is_fn = _classes(df, classify_column)
    filters = df["filter"] if "filter" in df else np.array(["PASS"] * len(df))
    pf = passes_filter(np.asarray(filters), ignored_filters)
    counts = grouped_confusion(*(torch.from_numpy(np.asarray(a)) for a in (masks, is_tp, is_fp, is_fn, pf))).numpy()
    acc = accuracy_from_counts(counts)
    group = np.empty(len(names), dtype=object)
    group[:] = names
    return Frame({
        "group": group,
        "tp": counts[:, 0].astype(np.int64),
        "fp": counts[:, 1].astype(np.int64),
        "fn": counts[:, 2].astype(np.int64),
        "precision": np.round(acc[:, 0], 5),
        "recall": np.round(acc[:, 1], 5),
        "f1": np.round(acc[:, 2], 5),
    })
