"""Precision, recall and the precision/recall curve of a scored callset, on the host.

Counterpart of ``variantcalling_tpu/utils/stats_utils.py``'s
``get_precision``, ``get_recall``, ``get_f1`` (``vcfeval_flavors``) and its
curve half (``binary_clf_curve``, ``_precision_recall_points``,
``precision_recall_curve``), and of ``utils/math_utils.safe_divide``: the
same numpy calls in the same order, so the same inputs give the same
float64 arrays bit for bit. The reference's host multinomial helpers are
not ported: the SEC test runs on the device (``ops/stats``).
"""

from __future__ import annotations

import numpy as np


def safe_divide(numerator: float, denominator: float, return_if_denominator_is_0: float = 0):
    """numerator/denominator, or ``return_if_denominator_is_0`` when denominator == 0."""
    if denominator == 0:
        return return_if_denominator_is_0
    return numerator / denominator


def get_precision(false_positives: int, true_positives: int, return_if_denominator_is_0=1) -> float:
    """Precision from fp and tp counts."""
    called = false_positives + true_positives
    return true_positives / called if called else return_if_denominator_is_0


def get_recall(false_negatives: int, true_positives: int, return_if_denominator_is_0=1) -> float:
    """Recall from fn and tp counts."""
    truth = false_negatives + true_positives
    return true_positives / truth if truth else return_if_denominator_is_0


def get_f1(precision: float, recall: float, null_value=np.nan) -> float:
    """Harmonic mean of precision and recall; ``null_value`` where either is it."""
    if {precision, recall} & {null_value}:
        return null_value
    return safe_divide(2 * precision * recall, precision + recall)


def binary_clf_curve(y_true: np.ndarray, y_score: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fps, tps, thresholds) at each distinct score, descending-score order
    (sklearn's ``_binary_clf_curve``)."""
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, dtype=float)
    desc = np.argsort(y_score, kind="stable")[::-1]
    y_score = y_score[desc]
    y_true = y_true[desc]
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps, y_score[threshold_idxs]


def _precision_recall_points(y_true: np.ndarray, y_score: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``sklearn.metrics.precision_recall_curve``: recall decreasing, with the
    (precision 1, recall 0) endpoint appended."""
    fps, tps, thresholds = binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.zeros_like(tps, dtype=float)
    np.divide(tps, ps, out=precision, where=ps != 0)
    if tps[-1] == 0:
        recall = np.ones_like(tps, dtype=float)
    else:
        recall = tps / tps[-1]
    sl = slice(None, None, -1)
    return np.hstack((precision[sl], 1)), np.hstack((recall[sl], 0)), thresholds[sl]


def precision_recall_curve(
    gtr: np.ndarray,
    predictions: np.ndarray,
    fn_mask: np.ndarray,
    pos_label: str | int | None = 1,
    min_class_counts_to_output: int = 20,
) -> tuple:
    """(precision, recall, f1, thresholds) of the score sweep.

    ``fn_mask`` marks false negatives (in the truth, no usable prediction):
    they add no point, but recall is shrunk by ``tp/(tp+fn)``. The synthetic
    endpoint and the lowest-threshold point are dropped, and so is the tail
    of thresholds above the ``min_class_counts_to_output``-th highest score.
    """
    labels = np.asarray(gtr)
    scores = np.asarray(predictions)
    missed = np.asarray(fn_mask, dtype=bool)
    if labels.size == 0:
        return np.array([]), np.array([]), np.array([]), np.array([])
    assert np.unique(labels.astype("U") if labels.dtype == object else labels).size <= 2, \
        "variant labels must be binary"
    assert missed.size == scores.size, "fn_mask must align with predictions"

    scored = ~missed
    truth = labels[scored] == pos_label
    kept_scores = scores[scored]

    if truth.size:
        prec_pts, rec_pts, thr_pts = _precision_recall_points(truth, kept_scores)
    else:  # everything was missed: a degenerate two-point curve
        prec_pts = np.array([0.0, 1.0])
        rec_pts = np.array([1.0, 0.0])
        thr_pts = np.array([kept_scores.min() if kept_scores.size else 0])

    n_tp = truth.sum()
    shrink = safe_divide(n_tp, n_tp + int(missed.sum()))
    prec = prec_pts[1:-1]
    rec = rec_pts[1:-1] * shrink
    thr = thr_pts[1:]
    f1 = 2 * prec * rec / (prec + rec + np.finfo(float).eps)

    if kept_scores.size:
        cutoff = np.sort(kept_scores)[max(0, kept_scores.size - min_class_counts_to_output)]
    else:
        cutoff = 0
    keep = thr <= cutoff
    return prec[keep], rec[keep], f1[keep], thr[keep]
