"""Per-class decision-threshold search (port of ``ptbxl_tpu/training/thresholds.py:18-99``).

The reference declares ``metrics.thresholds: "search_per_class"`` but never
implements it (the threshold is 0.5 everywhere); the eval CLIs offer it as an
opt-in ``--thresholds search_per_class``.  The JAX module scores candidates
with scikit-learn's ``f1_score``; the GPU machine has no scikit-learn, so the
port takes the binary F1 from ``training/metrics.py`` (``2tp / (2tp + fp +
fn)``, 0 when that is 0/0, scikit-learn's ``zero_division=0``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ptbxl_torch.training.metrics import _f1, compute_metrics


def quantile_candidates(probs: np.ndarray, positives: Optional[np.ndarray] = None,
                        n: int = 199) -> np.ndarray:
    """Candidate thresholds for one class: quantiles of ``probs``, 0.5 and
    (when given) every positive sample's probability, which keeps the search
    exact for rare classes whose positives sit between quantiles."""
    parts = [np.quantile(probs, np.linspace(0.005, 0.995, n)), [0.5]]
    if positives is not None and positives.size:
        parts.append(positives)
    return np.unique(np.concatenate(parts))


def search_thresholds_per_class(y_true: np.ndarray, y_prob: np.ndarray,
                                grid: Optional[np.ndarray] = None) -> np.ndarray:
    """The F1-maximizing threshold per class ([N, C] labels and probs -> [C]);
    the first best candidate in ascending order wins; a class with no
    positives (or no negatives) keeps 0.5.  ``grid`` replaces the quantile
    candidates.  Fit on validation probabilities, apply to test."""
    n_classes = y_true.shape[1]
    out = np.full(n_classes, 0.5, dtype=np.float64)
    for c in range(n_classes):
        yt = y_true[:, c]
        if yt.sum() == 0 or yt.sum() == len(yt):
            continue
        if grid is None:
            cand = quantile_candidates(y_prob[:, c], positives=y_prob[yt > 0.5, c])
        else:
            cand = np.asarray(grid, dtype=np.float64)
        best_f1, best_t = -1.0, 0.5
        pos = yt == 1
        for t in cand:
            f1 = _f1(pos, y_prob[:, c] >= t)
            if f1 > best_f1:
                best_f1, best_t = f1, float(t)
        out[c] = best_t
    return out


def apply_thresholds(y_prob: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """[N, C] probs, [C] thresholds -> [N, C] int predictions."""
    return (y_prob >= np.asarray(thresholds)[None, :]).astype(int)


def fit_on_val_report(y_true_val: np.ndarray, y_prob_val: np.ndarray,
                      y_true_test: np.ndarray, y_prob_test: np.ndarray):
    """Fit per-class F1 thresholds on validation predictions and apply them to
    test: ``(thresholds [C], the test metrics at them)``."""
    thr = search_thresholds_per_class(y_true_val, y_prob_val)
    return thr, compute_metrics(y_true_test, y_prob_test, threshold=thr)
