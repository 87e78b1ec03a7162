"""Evaluation metrics, pure numpy (the port's copy of
``cvsd_tpu/utils/metrics.py``): the ROC and PR curves, AUC-ROC and AUC-PR
(0.5 and 0.0 on single-class labels), the Youden / max-F1 threshold,
thresholded accuracy/precision/recall/F1, and video-level aggregation by
max / mean / percentile_95."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

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


def pr_curve(labels, scores) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Precision-recall curve (precision, recall, thresholds); recall descending
    ordering matches sklearn.precision_recall_curve."""
    y = _as1d(labels).astype(np.int64)
    s = _as1d(scores)
    order = np.argsort(-s, kind="stable")
    y, s = y[order], s[order]
    distinct = np.where(np.diff(s))[0]
    idx = np.r_[distinct, y.size - 1]
    tps = np.cumsum(y)[idx].astype(np.float64)
    fps = (idx + 1) - tps
    P = float(y.sum())
    precision = np.where(tps + fps > 0, tps / np.maximum(tps + fps, 1e-300), 0.0)
    recall = tps / P if P > 0 else np.zeros_like(tps)
    # sklearn returns reversed with a final (p=1, r=0) anchor
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    thresholds = s[idx][::-1]
    return precision, recall, thresholds


def compute_auc_pr(labels, scores) -> Tuple[float, np.ndarray, np.ndarray]:
    """Average-precision-style AUC-PR + curve; 0.0 on degenerate single-class
    labels, matching the reference's exception fallback
    (reference: shopformer_2/utils/metrics.py:62-63)."""
    y = _as1d(labels)
    if y.size == 0 or len(np.unique(y)) < 2:
        return 0.0, np.array([1.0, 0.0]), np.array([0.0, 1.0])
    precision, recall, _ = pr_curve(labels, scores)
    # step-wise integral (sklearn average_precision): sum (r_i - r_{i+1}) * p_i
    ap = float(-np.sum(np.diff(recall) * precision[:-1]))
    return ap, precision, recall


def find_optimal_threshold(labels, scores, method: str = "youden") -> float:
    """Optimal score threshold by Youden's J (tpr - fpr) or max-F1
    (reference: shopformer_2/utils/metrics.py:66-98)."""
    y = _as1d(labels)
    s = _as1d(scores)
    if len(np.unique(y)) < 2:
        return float(np.median(s)) if s.size else 0.5
    if method == "youden":
        fpr, tpr, thr = roc_curve(y, s)
        j = tpr - fpr
        best = int(np.argmax(j))
        t = thr[best]
        return float(t if np.isfinite(t) else thr[1])
    elif method == "f1":
        precision, recall, thr = pr_curve(y, s)
        f1 = 2 * precision[:-1] * recall[:-1] / np.maximum(precision[:-1] + recall[:-1], 1e-12)
        best = int(np.argmax(f1))
        return float(thr[min(best, thr.size - 1)])
    raise ValueError(f"unknown threshold method {method!r}")


def compute_metrics(labels, scores, threshold: Optional[float] = None, threshold_method: str = "youden") -> Dict[str, float]:
    """Full metric dict: AUC-ROC, AUC-PR, and thresholded accuracy/precision/
    recall/F1 at the given or optimal threshold
    (reference: shopformer/utils/metrics.py:37-77; shopformer_2 .../metrics.py:101-145)."""
    y = _as1d(labels).astype(np.int64)
    s = _as1d(scores)
    auc_roc, _, _ = compute_auc_roc(y, s)
    auc_pr, _, _ = compute_auc_pr(y, s)
    if threshold is None:
        threshold = find_optimal_threshold(y, s, threshold_method)
    pred = (s >= threshold).astype(np.int64)
    tp = float(np.sum((pred == 1) & (y == 1)))
    fp = float(np.sum((pred == 1) & (y == 0)))
    fn = float(np.sum((pred == 0) & (y == 1)))
    tn = float(np.sum((pred == 0) & (y == 0)))
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    accuracy = (tp + tn) / max(y.size, 1)
    return {
        "auc_roc": float(auc_roc),
        "auc_pr": float(auc_pr),
        "accuracy": float(accuracy),
        "precision": float(precision),
        "recall": float(recall),
        "f1": float(f1),
        "threshold": float(threshold),
    }


def compute_video_level_metrics(
    labels,
    scores,
    video_ids: Sequence,
    aggregations: Iterable[str] = ("max", "mean", "percentile_95"),
) -> Dict[str, Dict[str, float]]:
    """Aggregate per-window scores to one score per video (max/mean/p95) and compute
    metrics per aggregation; a video is anomalous if any window is
    (reference: shopformer_2/utils/metrics.py:148-188)."""
    y = _as1d(labels)
    s = _as1d(scores)
    vids = np.asarray(video_ids)
    out: Dict[str, Dict[str, float]] = {}
    uniq = list(dict.fromkeys(vids.tolist()))  # stable order
    groups: List[np.ndarray] = [np.where(vids == v)[0] for v in uniq]
    video_labels = np.array([float(y[g].max()) for g in groups])
    for agg in aggregations:
        fn = AGGREGATORS[agg]
        video_scores = np.array([fn(s[g]) for g in groups])
        out[agg] = compute_metrics(video_labels, video_scores)
    return out


def print_metrics(metrics: Dict[str, float], prefix: str = "") -> None:
    """Pretty-print a metric dict (reference: shopformer_2/utils/metrics.py:191-205)."""
    for k, v in metrics.items():
        print(f"{prefix}{k}: {v:.4f}" if isinstance(v, float) else f"{prefix}{k}: {v}")
