"""Evaluation: checkpoint loading, batched frame/video-level scoring, plots
and the results artifact (PyTorch port of ``cvsd_tpu/eval/evaluate.py``).

``load_model`` reads the msgpack checkpoints of either package through
``utils/checkpoint.py``; ``evaluate_checkpoint`` writes
``<output_dir>/metrics.json`` with the JAX artifact's keys (frame- and
video-level metrics, score statistics, the ROC and PR curves, the training
history mined from the sibling checkpoints) and, where matplotlib is
installed, the ROC / PR / score-distribution plots.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from cvsd_tpu_torch.config import Config, get_default_config, merge_configs
from cvsd_tpu_torch.data.datamodule import PoseLiftDataModule, batch_iterator
from cvsd_tpu_torch.models.shopformer import Shopformer, build_shopformer
from cvsd_tpu_torch.utils.checkpoint import load_checkpoint
from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device, use_float32_math
from cvsd_tpu_torch.utils.metrics import (
    compute_auc_pr,
    compute_auc_roc,
    compute_metrics,
    compute_video_level_metrics,
)
from cvsd_tpu_torch.utils.weights import load_flax_variables


class ShopformerScorer:
    """A Shopformer on one device + fixed-shape batched scoring."""

    def __init__(self, model: Shopformer, config: Dict[str, Any], device: DeviceLike = None):
        self.device = resolve_device(device)
        use_float32_math()  # the Shopformer scores in float32
        self.model = model.to(self.device).eval()
        self.config = Config(config)

    def score(self, poses: np.ndarray, batch_size: Optional[int] = None) -> np.ndarray:
        """Score (N, T, V, C) pose sequences -> (N,) anomaly scores, in batches
        of one static shape (pad-and-mask)."""
        bs = int(batch_size or self.config["data"].get("batch_size", 32))
        out = []
        for batch in batch_iterator(np.asarray(poses, np.float32), batch_size=bs):
            s = self.fetch_scores(self.score_async(batch["poses"]))
            out.append(s[batch["mask"].astype(bool)])
        return np.concatenate(out) if out else np.zeros(0)

    def score_async(self, poses: np.ndarray) -> torch.Tensor:
        """Enqueue one (B, T, V, C) batch and return the device tensor without
        waiting for it; ``fetch_scores`` brings it to the host later."""
        x = torch.from_numpy(np.ascontiguousarray(poses, np.float32)).to(self.device)
        return self.model.compute_anomaly_score(x)

    @staticmethod
    def fetch_scores(device_scores: torch.Tensor) -> np.ndarray:
        return device_scores.cpu().numpy()


def load_model(checkpoint_path: str, config: Optional[Dict[str, Any]] = None,
               device: DeviceLike = None) -> ShopformerScorer:
    """Rebuild the Shopformer from the checkpoint's embedded config (or an
    explicit one, or a sibling ``config.json``), merged over the defaults,
    and fill it from the checkpoint's flax variables on ``device`` (default:
    the CUDA card, raising without one), every variable used."""
    dev = resolve_device(device)
    use_float32_math()
    state, meta = load_checkpoint(checkpoint_path)
    if config is None:
        config = meta.get("config")
        if config is None:
            sidecar = os.path.join(os.path.dirname(checkpoint_path), "config.json")
            if os.path.exists(sidecar):
                with open(sidecar) as f:
                    config = json.load(f)
    config = merge_configs(get_default_config(), config or {})
    model = build_shopformer(config, device="cpu")
    variables = {"params": state["params"], "batch_stats": state.get("batch_stats", {})}
    load_flax_variables(model, variables)
    return ShopformerScorer(model, config, device=dev)


def evaluate_frame_level(
    scorer: ShopformerScorer, poses: np.ndarray, labels: np.ndarray,
    threshold: Optional[float] = None, threshold_method: str = "youden",
) -> Tuple[Dict[str, float], np.ndarray]:
    scores = scorer.score(poses)
    return compute_metrics(labels, scores, threshold, threshold_method), scores


def evaluate_video_level(
    labels: np.ndarray, scores: np.ndarray, video_ids, aggregations=("max", "mean", "percentile_95")
) -> Dict[str, Dict[str, float]]:
    return compute_video_level_metrics(labels, scores, video_ids, aggregations)


def _save_plots(out_dir: str, labels: np.ndarray, scores: np.ndarray, threshold: float) -> None:
    """ROC / PR / score-distribution plots (reference: shopformer_2/evaluate.py:121-192)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    os.makedirs(out_dir, exist_ok=True)
    auc, fpr, tpr = compute_auc_roc(labels, scores)
    fig, ax = plt.subplots()
    ax.plot(fpr, tpr, label=f"AUC-ROC = {auc:.4f}")
    ax.plot([0, 1], [0, 1], "--", alpha=0.4)
    ax.set_xlabel("FPR"); ax.set_ylabel("TPR"); ax.legend(); ax.set_title("ROC")
    fig.savefig(os.path.join(out_dir, "roc_curve.png"), dpi=120); plt.close(fig)

    ap, precision, recall = compute_auc_pr(labels, scores)
    fig, ax = plt.subplots()
    ax.plot(recall, precision, label=f"AUC-PR = {ap:.4f}")
    ax.set_xlabel("Recall"); ax.set_ylabel("Precision"); ax.legend(); ax.set_title("PR")
    fig.savefig(os.path.join(out_dir, "pr_curve.png"), dpi=120); plt.close(fig)

    fig, ax = plt.subplots()
    labels = np.asarray(labels)
    ax.hist(scores[labels == 0], bins=40, alpha=0.6, label="normal", density=True)
    ax.hist(scores[labels == 1], bins=40, alpha=0.6, label="anomaly", density=True)
    ax.axvline(threshold, color="k", linestyle="--", label=f"threshold={threshold:.4f}")
    ax.set_xlabel("anomaly score"); ax.legend(); ax.set_title("Score distribution")
    fig.savefig(os.path.join(out_dir, "score_distribution.png"), dpi=120); plt.close(fig)


def mine_training_history(checkpoint_path: str) -> Dict[str, Any]:
    """Reconstruct the training history by mining ALL sibling stage
    checkpoints, not just the one being evaluated — the v1 evaluator
    assembles stage-1 losses from gcae_checkpoint.pt, the per-epoch stage-2
    history from final_model.pt, and the best epoch/metrics from
    best_model.pt (reference: shopformer/evaluate.py:107-141). Here the
    sibling taxonomy is stage{1,2}_{best,final}.msgpack."""
    directory = os.path.dirname(os.path.abspath(checkpoint_path))
    merged: Dict[str, Any] = {"stage1": [], "stage2": []}
    sources: Dict[str, str] = {}
    names = ["stage1_final", "stage1_best", "stage2_final", "stage2_best"]
    base = os.path.splitext(os.path.basename(checkpoint_path))[0]
    if base not in names:
        names.append(base)
    for name in names:
        p = os.path.join(directory, f"{name}.msgpack")
        if not os.path.exists(p):
            continue
        try:
            _, meta = load_checkpoint(p)
        except (OSError, ValueError, KeyError):  # unreadable or not a checkpoint
            continue
        hist = meta.get("history") or {}
        for stage_key in ("stage1", "stage2"):
            records = hist.get(stage_key) or []
            if len(records) > len(merged[stage_key]):
                merged[stage_key] = records
                sources[stage_key] = name
        if name.endswith("_best") and name.startswith("stage2"):
            if meta.get("epoch") is not None:
                merged["best_epoch"] = meta["epoch"]
            if meta.get("metrics"):
                merged["best_metrics"] = meta["metrics"]
    merged["sources"] = sources
    return merged


def evaluate_checkpoint(
    checkpoint_path: str,
    config: Optional[Dict[str, Any]] = None,
    output_dir: Optional[str] = None,
    save_scores: bool = False,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Full evaluation driver producing the reference-shaped results artifact
    (``device``: the default is the CUDA card, raising without one)."""
    scorer = load_model(checkpoint_path, config, device=device)
    cfg = scorer.config
    dm = PoseLiftDataModule(cfg, verbose=False).setup()
    ds = dm.test_dataset
    ev = cfg.get("eval", {})

    metrics, scores = evaluate_frame_level(
        scorer, ds.poses, ds.labels,
        threshold=ev.get("threshold"), threshold_method=ev.get("threshold_method", "youden"),
    )
    video_metrics = evaluate_video_level(
        ds.labels, scores, ds.video_ids, ev.get("video_aggregations", ("max", "mean", "percentile_95"))
    )

    # full ROC/PR curve arrays, as in the reference's results artifact
    # (shopformer/training_results.json ROC fpr/tpr arrays)
    _auc, fpr, tpr = compute_auc_roc(ds.labels, scores)
    _ap, precision, recall = compute_auc_pr(ds.labels, scores)

    _, ckpt_meta = load_checkpoint(checkpoint_path)
    recorded = (ckpt_meta.get("metrics") or {}).get("auc_roc")
    mined = mine_training_history(checkpoint_path)
    history = ckpt_meta.get("history") or {}
    # prefer the most complete per-stage records mined from sibling checkpoints
    if len(mined.get("stage1", [])) > len(history.get("stage1", []) or []):
        history = {**history, "stage1": mined["stage1"]}
    if len(mined.get("stage2", [])) > len(history.get("stage2", []) or []):
        history = {**history, "stage2": mined["stage2"]}
    result: Dict[str, Any] = {
        "checkpoint": checkpoint_path,
        "config": Config(cfg).to_dict(),
        "history": history,
        "history_sources": mined.get("sources"),
        "best_epoch": mined.get("best_epoch"),
        "test_metrics": metrics,
        "video_metrics": video_metrics,
        "score_stats": {
            "mean": float(scores.mean()), "std": float(scores.std()),
            "min": float(scores.min()), "max": float(scores.max()),
            "median": float(np.median(scores)),
        },
        "num_sequences": int(len(ds)),
        "roc_curve": {"fpr": fpr.tolist(), "tpr": tpr.tolist()},
        "pr_curve": {"precision": precision.tolist(), "recall": recall.tolist()},
    }
    if recorded is not None:
        result["recorded_auc_roc"] = float(recorded)
        result["auc_delta_vs_recorded"] = float(metrics["auc_roc"] - recorded)
    if save_scores:
        result["per_sample"] = [
            {"score": float(s), "label": int(l), "video_id": v}
            for s, l, v in zip(scores, ds.labels, ds.video_ids)
        ]

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "metrics.json"), "w") as f:
            json.dump(result, f, indent=2, default=float)
        if ev.get("save_plots", True):
            thr = metrics["threshold"]
            _save_plots(output_dir, ds.labels, scores, thr)
    return result
