"""Pipeline A end to end on the PyTorch port: videos -> preprocess CSVs ->
XceptionTime -> AUC; the counterpart of ``examples/end_to_end_pipeline_a.py``.

1. Render a dataset directory in the reference's on-disk layout:
   ``Shoplifting/*.mp4`` (anomalous pose motion) and ``Shopping/*.mp4``
   (normal), listed in Anomaly_Train.txt; the same for a held-out test list.
2. Train the detector briefly on rendered scenes (or load a checkpoint).
3. ``preprocess_ucf_crime``: multiplexed decode -> detect -> track -> the
   reference's two CSVs, for the train and the test split.
4. Train ``XceptionTimeClassifier`` on the train CSVs' windows.
5. Score the held-out windows; report the window AUC and the video AUC
   (mean and max of a video's window probabilities).

Each stage is a function; ``main`` chains them and writes ``--artifact``
with the JAX example's keys. Needs cv2 (OpenCV) to write and read the
videos.

Run: python examples_torch/end_to_end_pipeline_a.py   (default device: the CUDA card)
CPU smoke: python examples_torch/end_to_end_pipeline_a.py --device cpu \\
    --videos-per-class 6 --test-per-class 3 --det-steps 40 --epochs 5 --img 64
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, Optional, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from cvsd_tpu_torch.config import get_default_config
from cvsd_tpu_torch.data.render import render_pose_video, rendered_detection_batch
from cvsd_tpu_torch.data.synthetic import SyntheticPoseLiftDataset
from cvsd_tpu_torch.data.ucf_crime import ANOMALY_CSV, NORMAL_CSV
from cvsd_tpu_torch.models.detector import PersonDetector, load_detector_checkpoint
from cvsd_tpu_torch.models.xception_time import XceptionTimeClassifier, windows_from_bbox_csv
from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline, preprocess_ucf_crime
from cvsd_tpu_torch.train.detector_train import DetectorTrainer
from cvsd_tpu_torch.utils.device import resolve_device
from cvsd_tpu_torch.utils.metrics import compute_auc_roc


def require_cv2() -> None:
    """Refuse to start without cv2: the dataset is mp4 files."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        raise SystemExit("this example writes and reads mp4 videos with cv2 (OpenCV), "
                         "which is not installed") from None


def build_dataset_dir(out: str, tag: str, n_per_class: int, frames: int, seed0: int) -> str:
    """Render Shoplifting/ + Shopping/ videos and write Anomaly_Train.txt."""
    root = os.path.join(out, tag)
    lines = []
    for label, anomaly_ratio, seed in (("Shoplifting", 1.0, seed0), ("Shopping", 0.0, seed0 + 1)):
        ds = SyntheticPoseLiftDataset(n_per_class, seq_len=frames, anomaly_ratio=anomaly_ratio,
                                      seed=seed)
        os.makedirs(os.path.join(root, label), exist_ok=True)
        for i in range(n_per_class):
            name = f"{label}{i:03d}_x264.mp4"
            p = os.path.join(root, label, name)
            if not os.path.exists(p):
                render_pose_video(p, ds.poses[i], seed=seed * 1000 + i)
            lines.append(f"{label}/{name}")
    with open(os.path.join(root, "Anomaly_Train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return root


def train_detector(img: int, steps: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The test-size detector on rendered skeletons (chunks of 200 steps of
    batch 8); returns its EMA weights as a state dict."""
    model = PersonDetector(img_size=img, width_mult=0.25, depth_mult=0.34, dtype=torch.float32)
    trainer = DetectorTrainer(model, lr=2e-3, total_steps=steps,
                              warmup_steps=min(100, steps // 5), ema_decay=0.998, device=device)
    rng = np.random.default_rng(0)
    done = 0
    while done < steps:
        n = min(200, steps - done)
        data = [rendered_detection_batch(rng, 8, img) for _ in range(n)]
        res = trainer.train_steps_scan(np.stack([d[0] for d in data]),
                                       np.stack([d[1] for d in data]),
                                       np.stack([d[2] for d in data]))
        done += n
        print(f"  det {done}/{steps}: {res['losses'][-1]:.2f}", flush=True)
    return trainer.eval_model(use_ema=True).state_dict()


def detection_config(img: int) -> Dict[str, Any]:
    cfg = get_default_config()
    cfg["detector"].update(img_size=img, width_mult=0.25, depth_mult=0.34, batch_size=16,
                           conf_threshold=0.3, max_detections=4, dtype="float32",
                           host_letterbox="content")
    return cfg


def preprocess_splits(cfg: Dict[str, Any], pipeline: DetectionPipeline,
                      splits: Dict[str, str], max_streams: int) -> Dict[str, Dict[str, Any]]:
    """Each split's videos through ``preprocess_ucf_crime`` into its two
    CSVs (anomaly and normal), which are removed first: the writer appends,
    as the reference's does, so a rerun over one directory would double them."""
    stats = {}
    for split, d in splits.items():
        for csv_name in (ANOMALY_CSV, NORMAL_CSV):
            p = os.path.join(d, csv_name)
            if os.path.exists(p):
                os.remove(p)
        t0 = time.time()
        s = preprocess_ucf_crime(cfg, d, pipeline=pipeline, verbose=False,
                                 max_streams=max_streams)
        stats[split] = {"videos": s["videos"], "frames": s["frames"], "rows": s["rows"],
                        "seconds": round(time.time() - t0, 1)}
        print(f"preprocess[{split}]: {json.dumps(stats[split])}", flush=True)
    return stats


def csv_paths(root: str) -> Sequence[str]:
    return [os.path.join(root, ANOMALY_CSV), os.path.join(root, NORMAL_CSV)]


def train_classifier(train_dir: str, seq_len: int, stride: int, epochs: int, nf: int,
                     device: torch.device) -> Tuple[XceptionTimeClassifier, int]:
    """XceptionTime on the train CSVs' windows; returns it and the window count."""
    X, y = windows_from_bbox_csv(csv_paths(train_dir), seq_len=seq_len, stride=stride)
    print(f"train windows: {X.shape}, anomalous {int(y.sum())}/{len(y)}", flush=True)
    clf = XceptionTimeClassifier(seq_len=seq_len, num_channels=X.shape[-1], nf=nf, device=device)
    hist = clf.train(X, y, epochs=epochs, verbose=False)
    print(f"final train epoch: {hist['history'][-1]}", flush=True)
    return clf, int(len(y))


def evaluate_classifier(clf: XceptionTimeClassifier, test_dir: str, seq_len: int,
                        stride: int) -> Tuple[Dict[str, Any], np.ndarray]:
    """The held-out windows' anomaly probabilities, their window AUC and the
    video AUC under mean and max aggregation. Returns (metrics, probabilities)."""
    Xt, yt, clips = windows_from_bbox_csv(csv_paths(test_dir), seq_len=seq_len, stride=stride,
                                          return_clips=True)
    probs = clf.predict_proba(Xt)[:, 1]
    window_auc, _, _ = compute_auc_roc(yt, probs)
    vids: Dict[int, Dict[str, Any]] = {}
    for c, p, lab in zip(clips, probs, yt):
        vids.setdefault(int(c), {"probs": [], "label": int(lab)})["probs"].append(float(p))
    vlabels = [v["label"] for v in vids.values()]
    video_auc_mean, _, _ = compute_auc_roc(vlabels, [float(np.mean(v["probs"]))
                                                     for v in vids.values()])
    video_auc_max, _, _ = compute_auc_roc(vlabels, [float(np.max(v["probs"]))
                                                    for v in vids.values()])
    return {"window_auc": round(float(window_auc), 4),
            "video_auc_mean_agg": round(float(video_auc_mean), 4),
            "video_auc_max_agg": round(float(video_auc_max), 4),
            "test_windows": int(len(yt)), "test_videos": len(vids)}, probs


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--videos-per-class", type=int, default=64)
    ap.add_argument("--test-per-class", type=int, default=16)
    ap.add_argument("--frames", type=int, default=72)
    ap.add_argument("--img", type=int, default=128, help="detector canvas")
    ap.add_argument("--det-steps", type=int, default=1500)
    ap.add_argument("--detector-checkpoint", default=None,
                    help="skip detector training; load this checkpoint")
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--stride", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--nf", type=int, default=16)
    ap.add_argument("--max-streams", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "e2e_pipeline_a"))
    ap.add_argument("--artifact",
                    default=os.path.join(tempfile.gettempdir(), "pipeline_a_results.json"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising without one)")
    args = ap.parse_args(argv)
    require_cv2()
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    print(f"device={device}", flush=True)
    seconds: Dict[str, float] = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        seconds[name] = now - t0
        t0 = now

    train_dir = build_dataset_dir(args.out, "train", args.videos_per_class, args.frames, seed0=40)
    test_dir = build_dataset_dir(args.out, "test", args.test_per_class, args.frames, seed0=60)
    lap("render")
    if args.detector_checkpoint:
        det_state = load_detector_checkpoint(args.detector_checkpoint, device)[0].state_dict()
    else:
        det_state = train_detector(args.img, args.det_steps, device)
    lap("train_detector")
    cfg = detection_config(args.img)
    pipeline = DetectionPipeline(cfg, state_dict=det_state, device=device)
    stats = preprocess_splits(cfg, pipeline, {"train": train_dir, "test": test_dir},
                              args.max_streams)
    lap("preprocess")
    clf, n_train = train_classifier(train_dir, args.seq_len, args.stride, args.epochs, args.nf,
                                    device)
    lap("train_classifier")
    metrics, _probs = evaluate_classifier(clf, test_dir, args.seq_len, args.stride)
    lap("evaluate")
    results = {
        **metrics,
        "train_windows": n_train, "preprocess": stats,
        "config": {"videos_per_class": args.videos_per_class, "seq_len": args.seq_len,
                   "stride": args.stride, "epochs": args.epochs, "det_steps": args.det_steps},
    }
    print(json.dumps(results), flush=True)
    with open(args.artifact, "w") as f:
        json.dump(results, f, indent=2)
    print("stage_seconds " + json.dumps(seconds), flush=True)
    return results


if __name__ == "__main__":
    main()
