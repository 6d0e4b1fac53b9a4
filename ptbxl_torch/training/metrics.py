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
"""

from __future__ import annotations

from typing import Dict

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


def _average_precision(y: np.ndarray, s: np.ndarray) -> float:
    pos = y == 1
    if not pos.any():
        return 0.0
    order = np.argsort(-s, kind="mergesort")
    s_sorted, hits = s[order], pos[order].astype(np.float64)
    last = np.r_[np.flatnonzero(s_sorted[1:] != s_sorted[:-1]), len(s) - 1]  # a threshold each
    tps = np.cumsum(hits)[last]
    precision = tps / (last + 1.0)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def _f1(t: np.ndarray, p: np.ndarray) -> float:
    tp = float(np.sum(t & p))
    denom = 2.0 * tp + float(np.sum(~t & p)) + float(np.sum(t & ~p))
    return 2.0 * tp / denom if denom > 0 else 0.0


def compute_metrics(y_true: np.ndarray, y_prob: np.ndarray, threshold: float = 0.5
                    ) -> Dict[str, float]:
    """Macro AUROC / AUPRC / F1 for ``y_true``, ``y_prob`` of shape [N, L] (or [N])."""
    y_true = np.asarray(y_true)
    y_prob = np.asarray(y_prob)
    if y_true.ndim == 1:
        y_true, y_prob = y_true[:, None], y_prob[:, None]
    y_pred = y_prob >= threshold
    cols = range(y_true.shape[1])
    metrics = {
        "auroc_macro": float(np.mean([_auroc(y_true[:, j], y_prob[:, j]) for j in cols])),
        "auprc_macro": float(np.mean([_average_precision(y_true[:, j], y_prob[:, j])
                                      for j in cols])),
    }
    t = y_true == 1
    if y_true.shape[1] == 1:  # scikit-learn's binary case: macro over the classes present
        t, p = t[:, 0], y_pred[:, 0]
        classes = [c for c in (False, True) if (t == c).any() or (p == c).any()]
        metrics["f1_macro"] = float(np.mean([_f1(t == c, p == c) for c in classes]))
    else:
        metrics["f1_macro"] = float(np.mean([_f1(t[:, j], y_pred[:, j]) for j in cols]))
    return metrics
