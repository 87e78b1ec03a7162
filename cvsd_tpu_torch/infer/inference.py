"""Batch inference over pose sequences (PyTorch port of
``cvsd_tpu/infer/inference.py``): ``predict_poses`` returns per-sample
scores, binary predictions and summary statistics; ``run_inference`` scores
a checkpoint's test split, with a fixed or an optimal threshold, and can
write the result as JSON.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from cvsd_tpu_torch.data.datamodule import PoseLiftDataModule
from cvsd_tpu_torch.eval.evaluate import ShopformerScorer, load_model
from cvsd_tpu_torch.utils.device import DeviceLike
from cvsd_tpu_torch.utils.metrics import compute_metrics, find_optimal_threshold


def predict_poses(
    scorer: ShopformerScorer,
    poses: np.ndarray,
    threshold: float = 0.5,
    batch_size: Optional[int] = None,
) -> Dict[str, Any]:
    """Score a batch of (N, T, V, C) sequences; returns scores, predictions and
    summary stats."""
    scores = scorer.score(poses, batch_size=batch_size)
    preds = (scores >= threshold).astype(np.int32)
    return {
        "scores": scores,
        "predictions": preds,
        "threshold": float(threshold),
        "num_anomalies": int(preds.sum()),
        "summary": {
            "mean": float(scores.mean()) if scores.size else 0.0,
            "std": float(scores.std()) if scores.size else 0.0,
            "min": float(scores.min()) if scores.size else 0.0,
            "max": float(scores.max()) if scores.size else 0.0,
            "median": float(np.median(scores)) if scores.size else 0.0,
        },
    }


def run_inference(
    checkpoint_path: str,
    config: Optional[Dict[str, Any]] = None,
    threshold: Optional[float] = None,
    output_path: Optional[str] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """CLI-level driver over the test split (``device``: the default is the
    CUDA card, raising without one)."""
    scorer = load_model(checkpoint_path, config, device=device)
    dm = PoseLiftDataModule(scorer.config, verbose=False).setup()
    ds = dm.test_dataset
    scores = scorer.score(ds.poses)
    if threshold is None:
        threshold = find_optimal_threshold(ds.labels, scores) if len(np.unique(ds.labels)) > 1 else 0.5
    result = {
        "checkpoint": checkpoint_path,
        "threshold": float(threshold),
        "num_sequences": int(len(ds)),
        "metrics": compute_metrics(ds.labels, scores, threshold=threshold),
        "predictions": [
            {"video_id": v, "score": float(s), "prediction": int(s >= threshold), "label": int(l)}
            for v, s, l in zip(ds.video_ids, scores, ds.labels)
        ],
    }
    if output_path:
        os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(result, f, indent=2, default=float)
    return result
