"""Run the synthetic end-to-end chain at several training-set sizes and read
what feeds its AUCs: the example detector's AP on held-out rendered scenes
and the tracked windows the stream scores per held-out video.

The reference's own rows (``RESULTS.md``, round-2 progression) move with
the count of Shopformer training videos: 64 videos / 60 epochs 0.818,
128 / 80 0.851, 256 / 100 0.935, 512 / 100 0.878 (window AUC). This script
runs ``examples_torch/end_to_end_synthetic.py`` unchanged at the rows
asked for, each into its own directory, and prints one JSON line per row.

    python examples_torch/synthetic_auc_probe.py --out DIR --rows 64:60 128:80

Each row retrains the detector and the pose net from the example's seed, so
the detector rows say whether those stages repeat. With ``--weights-from
DIR`` the rows skip both trainings and run the example's later stages
(render, extract, train the Shopformer, stream) on the ``detector.msgpack``
and ``pose_topdown.msgpack`` in DIR, as either package's example saves
them: a JAX run's weights through the port's stages.

    python examples_torch/synthetic_auc_probe.py --out DIR --rows 64:60 \
        --weights-from JAX_EXAMPLE_OUT --device cpu

``--det-seed S`` draws the detector trainer's init from seed S (the
example's is 0) and changes nothing else: the data, the pose net and the
later stages stay the example's, so rows of several seeds measure the
spread that the detector's init alone makes.

A ``--weights-from`` directory of a JAX detector takes the example's pose
net from a port row run on the same card: each row writes it to
``OUT/train64_ep60/pose_topdown.msgpack``.

Each row carries the md5 of the detector and pose-net files it ran, the
card's ``nvidia-smi`` name and power limit, and the top-down keypoint error
on the held-out scenes through the detector's own boxes (the pose the
Shopformer is fed), beside the detector's AP and recall, and the motion
reading of ``fault1_motion.py`` on the row's extracted test poses.

Default device: the CUDA card. Needs cv2, as the example does.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from collections import Counter
from typing import Any, Dict, List

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import functools  # noqa: E402

import end_to_end_synthetic as example  # noqa: E402
import fault1_motion  # noqa: E402
from cvsd_tpu_torch.data.render import rendered_detection_batch  # noqa: E402
from cvsd_tpu_torch.eval.detection import evaluate_detector  # noqa: E402
from cvsd_tpu_torch.models.detector import load_detector_checkpoint, make_detect_fn  # noqa: E402
from cvsd_tpu_torch.models.pose_topdown import (  # noqa: E402
    load_pose_topdown_checkpoint, pose_from_boxes)
from cvsd_tpu_torch.utils.device import resolve_device  # noqa: E402

HELD_OUT_SCENES = 256
HELD_OUT_SEED = 4242


def md5(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def detector_readings(path: str, pose_path: str, img_size: int, device) -> Dict[str, Any]:
    """AP50, mAP50-95 and recall of a saved example detector on held-out
    rendered scenes (one person each), at a low threshold for AP and at the
    example's streaming threshold (conf 0.3, 4 detections) for recall; at
    the streaming threshold also the top-down pose net's keypoint error on
    the detector's own boxes (matched detections; ``keypoints``)."""
    model, _variables, _meta = load_detector_checkpoint(path, device)
    pose_model = load_pose_topdown_checkpoint(pose_path, device).eval()
    images, boxes, valid, kpts = rendered_detection_batch(
        np.random.default_rng(HELD_OUT_SEED), HELD_OUT_SCENES, img_size)
    out = {}
    for name, conf, max_det in (("ap", 0.01, 32), ("stream", 0.3, 4)):
        detect = make_detect_fn(model, conf, 0.45, max_det)

        def topdown(frames, detect=detect):
            det = detect(frames)
            return (*det[:3], pose_from_boxes(pose_model, frames, det[0])[0])

        res = evaluate_detector(topdown, images, boxes, valid, gt_kpts=kpts, coco_map=True,
                                device=device)
        recall = np.asarray(res["recall"])
        out[name] = {"ap50": float(res["ap"]), "map50_95": float(res["map50_95"]),
                     "recall": float(recall[-1]) if recall.size else 0.0,
                     "detections": int(res["num_pred"]), "people": int(res["num_gt"]),
                     "keypoints": res.get("keypoints"),
                     "pose_map50_95": res.get("pose_map50_95")}
    return out


def later_stages(weights_dir: str, n_videos: int, epochs: int, out: str,
                 device) -> Dict[str, Any]:
    """The example's stages 2-4 (its ``main`` after the two trainings, at
    the default flags otherwise) on saved detector and pose-net weights."""
    os.makedirs(out, exist_ok=True)
    detector, _variables, _meta = load_detector_checkpoint(
        os.path.join(weights_dir, "detector.msgpack"), device)
    pose_model = load_pose_topdown_checkpoint(
        os.path.join(weights_dir, "pose_topdown.msgpack"), device).eval()
    detector_state = detector.state_dict()
    cfg = example.detection_config(128)
    train_videos, test_videos, annotations, truth = example.render_videos(out, n_videos, 32)
    poselift_dir = example.extract_poses(cfg, detector_state, pose_model, train_videos,
                                         test_videos, annotations, out, device)
    trainer, artifact = example.train_scorer(cfg, poselift_dir, epochs, out, device)
    stream = example.stream_and_evaluate(cfg, trainer.scorer, detector_state, pose_model,
                                         test_videos, annotations, truth, [1], device)
    return {"videos": stream["videos"],
            "extracted_pose_auc": artifact["test_metrics"]["auc_roc"],
            "video_metrics": {k: v["auc_roc"] for k, v in
                              (artifact["video_metrics"] or {}).items()},
            "streaming": stream["streaming"]}


def main(argv=None) -> List[Dict[str, Any]]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--rows", nargs="+", default=["64:60", "128:80"],
                   help="train-videos:epochs pairs, one chain run each")
    p.add_argument("--device", default=None)
    p.add_argument("--weights-from", default=None,
                   help="a directory with detector.msgpack and pose_topdown.msgpack: skip "
                        "the two trainings and run the later stages on these weights")
    p.add_argument("--det-seed", type=int, default=0,
                   help="the detector trainer's init seed (the example's is 0); the data "
                        "and every other stage stay the example's")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    rows = []
    for row in args.rows:
        n_videos, epochs = (int(x) for x in row.split(":"))
        out = os.path.join(args.out, f"train{n_videos}_ep{epochs}")
        captured: Dict[str, Any] = {}
        stream_and_evaluate = example.stream_and_evaluate

        def capture(*a, **k):
            r = stream_and_evaluate(*a, **k)
            captured["events"] = r["events"]
            return r

        example.stream_and_evaluate = capture
        trainer_cls = example.DetectorTrainer
        example.DetectorTrainer = functools.partial(trainer_cls, seed=args.det_seed)
        try:
            if args.weights_from:
                results = later_stages(args.weights_from, n_videos, epochs, out, device)
            else:
                flags = ["--train-videos", str(n_videos), "--epochs", str(epochs), "--out", out]
                if args.device:
                    flags += ["--device", args.device]
                results = example.main(flags)
        finally:
            example.stream_and_evaluate = stream_and_evaluate
            example.DetectorTrainer = trainer_cls
        per_video = Counter(e.video for e in captured["events"])
        counts = [per_video.get(name, 0) for name in sorted(results["videos"])]
        weights = args.weights_from or out
        det_path = os.path.join(weights, "detector.msgpack")
        pose_path = os.path.join(weights, "pose_topdown.msgpack")
        record = {
            "train_videos": n_videos, "epochs": epochs,
            "window_auc": results["extracted_pose_auc"],
            "video_auc_offline": results["video_metrics"],
            "streaming_video_auc": {k: v["video_auc"] for k, v in results["streaming"].items()},
            "event_auc": results["streaming"]["max"]["event_auc"],
            "windows": int(sum(counts)), "windows_per_video": counts,
            "detector": detector_readings(det_path, pose_path, 128, device),
            "motion": fault1_motion.poselift_reading(os.path.join(out, "PoseLift")),
            "weights_from": args.weights_from, "det_seed": args.det_seed,
            "detector_md5": md5(det_path), "pose_md5": md5(pose_path),
            "card": card_line(),
        }
        rows.append(record)
        print("probe_row " + json.dumps(record), flush=True)
    return rows


if __name__ == "__main__":
    main()
