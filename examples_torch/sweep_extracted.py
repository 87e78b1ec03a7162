"""Sweep the Shopformer over a FIXED extracted-pose dataset with seed repeats,
on the PyTorch port; the counterpart of ``examples/sweep_extracted.py``,
which the reference wrote to show how much of the end-to-end window AUC is
fit noise.

Phase A (cached): train the detector and the top-down pose net on rendered
skeletons, render the train and test videos, and extract a PoseLift dataset
with the trained nets through ``DetectionPipeline`` (the protocol of
``end_to_end_synthetic.py``'s steps 1-2). The nets are cached in ``--out``
(``phaseA_det.msgpack``, ``phaseA_pose.msgpack``) and reused at any
``--train-videos``; the dataset is cached by a marker file.
Phase B: for each config and seed, train the Shopformer on the SAME
extracted dataset (``scan_epoch``, ``cosine_warmup``, seed ``1000 + s``) and
record the window and video AUCs. Reports mean +/- std per config and
writes ``<out>/sweep_extracted.json``.

    python examples_torch/sweep_extracted.py --train-videos 256 --seeds 3 \\
        [--configs tok4 base_h32_e100] [--device cpu]

Default device: the CUDA card, raising without one. Needs cv2 to write and
read the videos.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import end_to_end_synthetic as example  # noqa: E402
from cvsd_tpu_torch.config import get_default_config  # noqa: E402
from cvsd_tpu_torch.data.render import render_pose_video  # noqa: E402
from cvsd_tpu_torch.data.synthetic import SyntheticPoseLiftDataset  # noqa: E402
from cvsd_tpu_torch.data.ucf_crime import TemporalAnnotation  # noqa: E402
from cvsd_tpu_torch.models.detector import load_detector_checkpoint  # noqa: E402
from cvsd_tpu_torch.models.pose_topdown import load_pose_topdown_checkpoint  # noqa: E402
from cvsd_tpu_torch.pipeline.pose_export import export_poselift_dataset  # noqa: E402
from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline  # noqa: E402
from cvsd_tpu_torch.train.loop import Trainer  # noqa: E402
from cvsd_tpu_torch.utils.device import resolve_device  # noqa: E402

T_VID = 72  # frames per rendered video

# config axes swept in phase B (name, dotted overrides): the reference's list
CONFIGS = [
    ("base_h32_e100", {"model.hidden_channels": 32, "training.stage1_epochs": 100,
                       "training.stage2_epochs": 100, "training.lr": 1e-3}),
    ("h64", {"model.hidden_channels": 64, "training.stage1_epochs": 100,
             "training.stage2_epochs": 100, "training.lr": 1e-3}),
    ("lr3e-4", {"model.hidden_channels": 32, "training.stage1_epochs": 100,
                "training.stage2_epochs": 100, "training.lr": 3e-4}),
    ("tok4", {"model.hidden_channels": 32, "model.num_tokens": 4,
              "training.stage1_epochs": 100, "training.stage2_epochs": 100,
              "training.lr": 1e-3}),
    ("e200", {"model.hidden_channels": 32, "training.stage1_epochs": 200,
              "training.stage2_epochs": 200, "training.lr": 1e-3}),
    ("h32_drop02", {"model.hidden_channels": 32, "model.dropout": 0.2,
                    "training.stage1_epochs": 100, "training.stage2_epochs": 100,
                    "training.lr": 1e-3}),
    # do the two winning axes (tok4, h64) compose?
    ("tok4_h64", {"model.hidden_channels": 64, "model.num_tokens": 4,
                  "training.stage1_epochs": 100, "training.stage2_epochs": 100,
                  "training.lr": 1e-3}),
]


def build_dataset(out: str, img_size: int, steps: int, pose_steps: int, n_train: int,
                  n_test: int, device: torch.device) -> str:
    """Phase A: detector and pose-net training, render, extract; cached.
    Returns the PoseLift directory."""
    poselift_dir = os.path.join(out, f"PoseLift_{n_train}")
    marker = os.path.join(poselift_dir, ".complete")
    if os.path.exists(marker):
        print(f"phase A cached: {poselift_dir}")
        return poselift_dir
    print(f"== phase A: detector ({steps}) + pose ({pose_steps}) + extract {n_train}+{n_test} ==")
    # the nets do not depend on the dataset's size: cached in `out`, so a
    # --train-videos 512 follow-up reuses the nets trained for 256
    det_ckpt = os.path.join(out, "phaseA_det.msgpack")
    pose_ckpt = os.path.join(out, "phaseA_pose.msgpack")
    if not (os.path.exists(det_ckpt) and os.path.exists(pose_ckpt)):
        rng = np.random.default_rng(0)
        nets = os.path.join(out, "phaseA_nets")
        os.makedirs(nets, exist_ok=True)
        example.train_detector(img_size, steps, rng, nets, device)  # saves the EMA weights
        example.train_pose_net(pose_steps, rng, nets, device)
        os.replace(os.path.join(nets, "detector.msgpack"), det_ckpt)
        os.replace(os.path.join(nets, "pose_topdown.msgpack"), pose_ckpt)
    else:
        print(f"phase A nets cached: {det_ckpt}, {pose_ckpt}")
    detector, _variables, _meta = load_detector_checkpoint(det_ckpt, device)
    pose_model = load_pose_topdown_checkpoint(pose_ckpt, device).eval()
    return extract(out, poselift_dir, marker, detector.state_dict(), pose_model, img_size,
                   n_train, n_test, device)


def extract(out: str, poselift_dir: str, marker: str, detector_state: Dict[str, Any],
            pose_model, img_size: int, n_train: int, n_test: int,
            device: torch.device) -> str:
    """Render the train and test videos (cached by file) and extract the
    PoseLift dataset with the trained detector and top-down pose net."""
    cfg = get_default_config()
    cfg["detector"].update(img_size=img_size, width_mult=0.25, depth_mult=0.34,
                           batch_size=16, conf_threshold=0.3, max_detections=4,
                           dtype="float32", pose_mode="topdown")
    pipeline = DetectionPipeline(cfg, state_dict=detector_state, device=device,
                                 pose_model=pose_model)
    n_half = n_test // 2
    vid_dir = os.path.join(out, "videos")
    os.makedirs(vid_dir, exist_ok=True)
    train_videos = []
    train_ds = SyntheticPoseLiftDataset(n_train, seq_len=T_VID, anomaly_ratio=0.0, seed=20)
    for i in range(n_train):
        p = os.path.join(vid_dir, f"train_{i}.mp4")
        if not os.path.exists(p):
            render_pose_video(p, train_ds.poses[i], seed=200 + i)
        train_videos.append(p)
    test_videos, annotations = [], {}
    norm = SyntheticPoseLiftDataset(n_half, seq_len=T_VID, anomaly_ratio=0.0, seed=30)
    anom = SyntheticPoseLiftDataset(n_half, seq_len=T_VID, anomaly_ratio=1.0, seed=31)
    for kind, ds in (("normal", norm), ("anomalous", anom)):
        for i in range(n_half):
            name = f"test_{kind}_{i}"
            p = os.path.join(vid_dir, f"{name}.mp4")
            if not os.path.exists(p):
                render_pose_video(p, ds.poses[i], seed=300 + i)
            test_videos.append(p)
            annotations[name] = TemporalAnnotation(
                name, kind, [(1, T_VID)] if kind == "anomalous" else [])
    export_poselift_dataset(pipeline, train_videos, poselift_dir, "Train", verbose=False)
    export_poselift_dataset(pipeline, test_videos, poselift_dir, "Test",
                            annotations=annotations, verbose=False)
    with open(marker, "w") as f:
        f.write("ok")
    return poselift_dir


def fit_one(name: str, overrides: Dict[str, Any], seed: int, poselift_dir: str, out: str,
            device: str) -> Tuple[float, Optional[float]]:
    """Phase B's unit: one Shopformer fit of one config and seed on the
    extracted dataset; returns (window AUC, mean-aggregated video AUC)."""
    cfg = get_default_config()
    cfg["data"].update(dataset="poselift", data_dir=poselift_dir, batch_size=64, stride=6)
    cfg["training"].update(scan_epoch=True, scheduler="cosine_warmup")
    cfg["experiment"].update(seed=1000 + seed,
                             checkpoint_dir=os.path.join(out, f"run_{name}_s{seed}"))
    for k, v in overrides.items():
        node = cfg
        ks = k.split(".")
        for kk in ks[:-1]:
            node = node[kk]
        node[ks[-1]] = v
    t0 = time.time()
    artifact = Trainer(cfg, verbose=False, device=device).setup().fit()
    auc = artifact["test_metrics"]["auc_roc"]
    vm = artifact.get("video_metrics") or {}
    vauc = vm.get("mean", {}).get("auc_roc")
    print(f"  {name} seed{seed}: window AUC {auc:.4f} "
          f"video(mean) {vauc if vauc is None else round(vauc, 4)} "
          f"({time.time() - t0:.0f}s)", flush=True)
    return auc, vauc


def config_row(name: str, overrides: Dict[str, Any],
               fits: Sequence[Tuple[float, Optional[float]]]) -> Dict[str, Any]:
    """One config's row from its fits, seed by seed."""
    aucs = [a for a, _v in fits]
    vid_aucs = [v for _a, v in fits]
    present = [v for v in vid_aucs if v is not None]
    return {"config": name, "overrides": overrides,
            "window_auc_mean": float(np.mean(aucs)),
            "window_auc_std": float(np.std(aucs)),
            "window_aucs": aucs,
            "video_auc_mean": float(np.mean(present)) if present else None,
            "video_aucs": vid_aucs}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train-videos", type=int, default=256)
    ap.add_argument("--test-videos", type=int, default=32)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--pose-steps", type=int, default=3000)
    ap.add_argument("--img-size", type=int, default=128)
    ap.add_argument("--configs", nargs="*", default=None,
                    help="subset of config names to run")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "sweep_extracted"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising without one)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    args = parser().parse_args(argv)
    example.require_cv2()
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    poselift_dir = build_dataset(args.out, args.img_size, args.steps, args.pose_steps,
                                 args.train_videos, args.test_videos, device)
    print(f"phase A: {time.time() - t0:.1f} s", flush=True)
    results = []
    todo = [(n, o) for n, o in CONFIGS if not args.configs or n in args.configs]
    t1 = time.time()
    for name, overrides in todo:
        fits = [fit_one(name, overrides, seed, poselift_dir, args.out, str(device))
                for seed in range(args.seeds)]
        row = config_row(name, overrides, fits)
        results.append(row)
        print(json.dumps({k: row[k] for k in
                          ("config", "window_auc_mean", "window_auc_std")}), flush=True)
        with open(os.path.join(args.out, "sweep_extracted.json"), "w") as f:
            json.dump({"train_videos": args.train_videos, "seeds": args.seeds,
                       "results": results}, f, indent=2)
    ranked = sorted(results, key=lambda r: r["window_auc_mean"], reverse=True)
    print(f"phase B: {time.time() - t1:.1f} s", flush=True)
    print("== ranked ==")
    for r in ranked:
        print(f"  {r['config']}: {r['window_auc_mean']:.4f} +/- {r['window_auc_std']:.4f}")
    return results


if __name__ == "__main__":
    main()
