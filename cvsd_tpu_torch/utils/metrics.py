"""The ROC curve, AUC-ROC and video-level score aggregators (the port's copy of
``roc_curve``, ``compute_auc_roc`` and ``_AGGREGATORS`` from
``cvsd_tpu/utils/metrics.py``; pure numpy)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

AGGREGATORS = {
    "max": lambda v: float(np.max(v)),
    "mean": lambda v: float(np.mean(v)),
    "percentile_95": lambda v: float(np.percentile(v, 95)),
}


def _as1d(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64).reshape(-1)


def roc_curve(labels, scores) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ROC curve (fpr, tpr, thresholds), thresholds descending: one point per
    distinct score plus the (0, 0) anchor, as sklearn gives it."""
    y = _as1d(labels).astype(np.int64)
    s = _as1d(scores)
    order = np.argsort(-s, kind="stable")
    y, s = y[order], s[order]
    # indices where the score changes (the last of each tie group)
    distinct = np.where(np.diff(s))[0]
    idx = np.r_[distinct, y.size - 1]
    tps = np.cumsum(y)[idx].astype(np.float64)
    fps = (idx + 1) - tps
    P = float(y.sum())
    N = float(y.size - y.sum())
    tpr = tps / P if P > 0 else np.zeros_like(tps)
    fpr = fps / N if N > 0 else np.zeros_like(fps)
    fpr = np.r_[0.0, fpr]
    tpr = np.r_[0.0, tpr]
    thresholds = np.r_[np.inf, s[idx]]
    return fpr, tpr, thresholds


def compute_auc_roc(labels, scores) -> Tuple[float, np.ndarray, np.ndarray]:
    """AUC-ROC + (fpr, tpr); 0.5 on degenerate single-class labels. The
    trapezoid rule is written out as ``np.trapezoid`` computes it (numpy < 2
    lacks that name)."""
    y = _as1d(labels)
    if y.size == 0 or len(np.unique(y)) < 2:
        return 0.5, np.array([0.0, 1.0]), np.array([0.0, 1.0])
    fpr, tpr, _ = roc_curve(labels, scores)
    auc = np.add.reduce(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0)
    return float(auc), fpr, tpr
