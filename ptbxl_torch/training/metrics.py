"""Evaluation metrics in numpy alone (port of ``ptbxl_tpu/training/metrics.py``).

The JAX package calls scikit-learn; the GPU machine has numpy and scipy but
no scikit-learn, so this module computes the same numbers itself, edge
cases as scikit-learn 1.9 gives them:

* ``auroc_macro``: the mean over labels of the rank-sum AUROC, tied scores
  counted 1/2 (``roc_auc_score``); a label with one value in ``y_true``
  gives ``nan``, and so does the macro mean.
* ``auprc_macro``: the mean of ``average_precision_score``'s step sum
  ``sum_n (R_n - R_{n-1}) P_n`` over the distinct thresholds; a label with
  no positives scores 0.
* ``f1_macro``: ``f1_score(average='macro', zero_division=0)`` at
  ``threshold``.  For one label (``[N]`` or ``[N, 1]``, scikit-learn's
  binary case) the macro mean runs over the classes 0 and 1 present in
  ``y_true`` or the predictions, as scikit-learn does.
* a NaN or infinite probability anywhere in ``y_prob`` makes both
  ``auroc_macro`` and ``auprc_macro`` ``nan``: scikit-learn raises on it and
  the JAX function turns the raise into ``nan``.

For one label ``roc_auc`` / ``average_precision`` give scikit-learn's
``roc_auc_score`` / ``average_precision_score`` and raise ``ValueError`` on
a non-finite score as they do; ``roc_curve`` and ``precision_recall_curve``
give the arrays of scikit-learn's functions of those names (the figures of
``analysis/figures.py`` draw them).
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

import numpy as np


def _average_ranks(s: np.ndarray) -> np.ndarray:
    """1-based ranks of ``s``, ties given the mean of their ranks."""
    order = np.argsort(s, kind="mergesort")
    sorted_s = s[order]
    starts = np.flatnonzero(np.r_[True, sorted_s[1:] != sorted_s[:-1]])
    ends = np.r_[starts[1:], len(s)]
    mean_rank = (starts + ends + 1) / 2.0  # mean of the 1-based ranks starts+1 .. ends
    ranks = np.empty(len(s), np.float64)
    ranks[order] = np.repeat(mean_rank, ends - starts)
    return ranks


def _auroc(y: np.ndarray, s: np.ndarray) -> float:
    pos = y == 1
    n_pos = int(pos.sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    r = _average_ranks(s)
    return float((r[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _counts_at_thresholds(y: np.ndarray, s: np.ndarray):
    """(fps, tps, thresholds) at each distinct score, scores descending
    (scikit-learn's ``confusion_matrix_at_thresholds``); ``y`` is bool."""
    order = np.argsort(-s, kind="mergesort")
    s_sorted = s[order]
    last = np.r_[np.flatnonzero(np.diff(s_sorted)), len(s) - 1]
    tps = np.cumsum(y[order], dtype=np.float64)[last]
    fps = 1.0 + last - tps
    return fps, tps, s_sorted[last]


def _average_precision(y: np.ndarray, s: np.ndarray) -> float:
    pos = y == 1
    if not pos.any():
        return 0.0
    fps, tps, _ = _counts_at_thresholds(pos, s)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * tps / (tps + fps)))


def _check_finite(s: np.ndarray) -> None:
    """scikit-learn's ``assert_all_finite`` on scores."""
    if np.isnan(s).any():
        raise ValueError("Input contains NaN.")
    if not np.isfinite(s).all():
        raise ValueError(f"Input contains infinity or a value too large for {s.dtype!r}.")


def _binary(y_true, y_score) -> Tuple[np.ndarray, np.ndarray]:
    """One label's (y == 1, scores) as 1-D arrays, the scores finite."""
    y = np.asarray(y_true).reshape(-1) == 1
    s = np.asarray(y_score).reshape(-1)
    if y.shape != s.shape:
        raise ValueError(f"y_true has {y.size} values, y_score {s.size}")
    _check_finite(s)
    return y, s


def roc_auc(y_true, y_score) -> float:
    """``roc_auc_score`` of one label: ``nan`` where ``y_true`` holds one value."""
    y, s = _binary(y_true, y_score)
    return _auroc(y.astype(np.int8), s)


def average_precision(y_true, y_score) -> float:
    """``average_precision_score`` of one label: 0 where it has no positive."""
    y, s = _binary(y_true, y_score)
    return _average_precision(y.astype(np.int8), s)


def roc_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) as ``sklearn.metrics.roc_curve`` gives them
    (``drop_intermediate=True``): collinear points dropped, ``(0, 0)`` at
    threshold ``inf`` in front; a rate with no sample of its class is nan."""
    y, s = _binary(y_true, y_score)
    fps, tps, thr = _counts_at_thresholds(y, s)
    if fps.shape[0] > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps, thr = fps[keep], tps[keep], thr[keep]
    fps, tps = np.r_[0.0, fps], np.r_[0.0, tps]
    thr = np.r_[np.inf, thr.astype(np.float64)]
    rates = []
    for counts, what in ((fps, "negative"), (tps, "positive")):
        if counts[-1] <= 0:
            warnings.warn(f"No {what} samples in y_true: its rate is nan", stacklevel=2)
            rates.append(np.full(counts.shape, np.nan))
        else:
            rates.append(counts / counts[-1])
    return rates[0], rates[1], thr


def precision_recall_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(precision, recall, thresholds) as ``sklearn.metrics.precision_recall_curve``
    gives them: thresholds ascending, precision ending in 1 and recall in 0;
    with no positive the recall is 1 at every threshold."""
    y, s = _binary(y_true, y_score)
    fps, tps, thr = _counts_at_thresholds(y, s)
    precision = tps / (tps + fps)  # every threshold holds a sample
    if tps[-1] == 0:
        warnings.warn("No positive class found in y_true, recall is set to one for all "
                      "thresholds.", stacklevel=2)
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thr[::-1]


def _f1(t: np.ndarray, p: np.ndarray) -> float:
    tp = float(np.sum(t & p))
    denom = 2.0 * tp + float(np.sum(~t & p)) + float(np.sum(t & ~p))
    return 2.0 * tp / denom if denom > 0 else 0.0


def f1_macro(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """``f1_score(y_true, y_pred, average='macro', zero_division=0)`` of 0/1
    labels and predictions of shape [N, L] (or [N])."""
    t = np.asarray(y_true) == 1
    p = np.asarray(y_pred).astype(bool)
    if t.ndim == 1:
        t, p = t[:, None], p[:, None]
    if t.shape[1] == 1:  # scikit-learn's binary case: macro over the classes present
        t, p = t[:, 0], p[:, 0]
        classes = [c for c in (False, True) if (t == c).any() or (p == c).any()]
        return float(np.mean([_f1(t == c, p == c) for c in classes]))
    return float(np.mean([_f1(t[:, j], p[:, j]) for j in range(t.shape[1])]))


def compute_metrics(y_true: np.ndarray, y_prob: np.ndarray, threshold: float = 0.5
                    ) -> Dict[str, float]:
    """Macro AUROC / AUPRC / F1 for ``y_true``, ``y_prob`` of shape [N, L] (or [N])."""
    y_true = np.asarray(y_true)
    y_prob = np.asarray(y_prob)
    if y_true.ndim == 1:
        y_true, y_prob = y_true[:, None], y_prob[:, None]
    cols = range(y_true.shape[1])
    if np.isfinite(y_prob).all():
        metrics = {
            "auroc_macro": float(np.mean([_auroc(y_true[:, j], y_prob[:, j]) for j in cols])),
            "auprc_macro": float(np.mean([_average_precision(y_true[:, j], y_prob[:, j])
                                          for j in cols])),
        }
    else:  # scikit-learn raises on a non-finite score; the JAX function gives nan
        metrics = {"auroc_macro": float("nan"), "auprc_macro": float("nan")}
    metrics["f1_macro"] = f1_macro(y_true, y_prob >= threshold)
    return metrics
