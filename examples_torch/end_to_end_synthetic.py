"""Full synthetic end-to-end demonstration on the PyTorch port — no real
dataset required; the counterpart of ``examples/end_to_end_synthetic.py``.

1. Train the detector on rendered skeleton frames, then the top-down pose
   net on rendered crops.
2. Render normal and anomalous pose sequences as mp4 videos and extract a
   PoseLift dataset from them with the trained detector and pose net.
3. Train the Shopformer on the extracted poses (stage 1, then stage 2).
4. Stream the held-out videos through decode -> detect -> pose -> track ->
   window -> Shopformer scoring and report the streaming AUCs.

Each stage is a function; ``main`` chains them and writes
``<out>/e2e_results.json`` with the JAX example's keys. Needs cv2 (OpenCV)
to write and read the videos.

Run: python examples_torch/end_to_end_synthetic.py [--steps 150] [--out DIR]
     [--device cpu]   (default device: the CUDA card)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from cvsd_tpu_torch.config import get_default_config
from cvsd_tpu_torch.data.render import (render_pose_video, rendered_detection_batch,
                                        rendered_pose_crop_batch)
from cvsd_tpu_torch.data.synthetic import SyntheticPoseLiftDataset
from cvsd_tpu_torch.data.ucf_crime import TemporalAnnotation
from cvsd_tpu_torch.eval.evaluate import ShopformerScorer
from cvsd_tpu_torch.eval.streaming_eval import evaluate_streaming
from cvsd_tpu_torch.models.detector import PersonDetector
from cvsd_tpu_torch.models.pose_topdown import TopDownPoseNet, pose_from_boxes
from cvsd_tpu_torch.pipeline.pose_export import export_poselift_dataset
from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline
from cvsd_tpu_torch.pipeline.streaming import StreamingPipeline
from cvsd_tpu_torch.train.detector_train import DetectorTrainer
from cvsd_tpu_torch.train.loop import Trainer
from cvsd_tpu_torch.train.pose_topdown_train import TopDownPoseTrainer
from cvsd_tpu_torch.utils.device import resolve_device

T_VID = 72  # frames per rendered video


def require_cv2() -> None:
    """Refuse to start without cv2: every stage after training reads or
    writes mp4 files."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        raise SystemExit("this example writes and reads mp4 videos with cv2 (OpenCV), "
                         "which is not installed") from None


def train_detector(img_size: int, steps: int, rng: np.random.Generator, out: str,
                   device: torch.device) -> DetectorTrainer:
    """The box detector on rendered skeletons, in chunks of 200 steps of
    batch 8; saves ``detector.msgpack`` (the EMA weights)."""
    print(f"== training box detector on rendered skeletons ({steps} steps) ==")
    model = PersonDetector(img_size=img_size, width_mult=0.25, depth_mult=0.34,
                           dtype=torch.float32)
    trainer = DetectorTrainer(model, lr=2e-3, total_steps=steps, warmup_steps=100,
                              ema_decay=0.998, device=device)
    done = 0
    while done < steps:
        n = min(200, steps - done)
        data = [rendered_detection_batch(rng, 8, img_size) for _ in range(n)]
        res = trainer.train_steps_scan(np.stack([d[0] for d in data]),
                                       np.stack([d[1] for d in data]),
                                       np.stack([d[2] for d in data]))
        done += n
        print(f"  steps {done}: loss {res['losses'][0]:.2f} -> {res['losses'][-1]:.2f}",
              flush=True)
    trainer.save(os.path.join(out, "detector.msgpack"), steps=steps)
    return trainer


def train_pose_net(pose_steps: int, rng: np.random.Generator, out: str,
                   device: torch.device) -> Tuple[TopDownPoseTrainer, float, float]:
    """The top-down pose net on rendered crops (chunks of 250 steps of batch
    32); saves ``pose_topdown.msgpack``. Returns the trainer and the held-out
    keypoint RMS in frame pixels and box-normalized."""
    print(f"== training top-down pose net ({pose_steps} steps) ==")
    model = TopDownPoseNet(num_keypoints=17, width=32, crop_size=64)
    trainer = TopDownPoseTrainer(model, lr=1e-3, total_steps=pose_steps, device=device)
    done = 0
    while done < pose_steps:
        n = min(250, pose_steps - done)
        data = [rendered_pose_crop_batch(rng, 32) for _ in range(n)]
        res = trainer.train_steps_scan(np.stack([d[0] for d in data]),
                                       np.stack([d[1] for d in data]),
                                       np.stack([d[2] for d in data]))
        done += n
        print(f"  pose steps {done}: loss {res['losses'][-1]:.5f}", flush=True)
    trainer.save(os.path.join(out, "pose_topdown.msgpack"), steps=pose_steps)

    # the number that bounds the anomaly scores' separability downstream
    ev_f, ev_b, ev_k = rendered_pose_crop_batch(np.random.default_rng(9999), 128,
                                                joint_jitter=0.0)
    kp, _ = pose_from_boxes(trainer.model.eval(), torch.from_numpy(ev_f).to(device),
                            torch.from_numpy(ev_b).to(device)[:, None, :])
    err = np.linalg.norm(kp.cpu().numpy()[:, 0, :, :2] - ev_k, axis=-1)
    bw = np.clip(ev_b[:, 2] - ev_b[:, 0], 1, None)[:, None]
    rms, rms_box = float(np.sqrt((err ** 2).mean())), float(np.sqrt(((err / bw) ** 2).mean()))
    print(f"  held-out pose RMS: {rms:.2f} px ({rms_box:.3f} box-normalized)", flush=True)
    return trainer, rms, rms_box


def detection_config(img_size: int) -> Dict[str, Any]:
    """The example's detector settings: the trained test-size detector in
    float32 with the top-down pose net."""
    cfg = get_default_config()
    cfg["detector"].update(img_size=img_size, width_mult=0.25, depth_mult=0.34,
                           batch_size=16, conf_threshold=0.3, max_detections=4,
                           dtype="float32", pose_mode="topdown")
    return cfg


def render_videos(out: str, n_train: int, n_test: int
                  ) -> Tuple[List[str], List[str], Dict[str, TemporalAnnotation], Dict[str, int]]:
    """Normal training videos and held-out videos, half normal and half
    anomalous (the anomaly spans the whole video). Returns (train videos,
    test videos, annotations by name, label by name)."""
    train_videos = []
    train_ds = SyntheticPoseLiftDataset(n_train, seq_len=T_VID, anomaly_ratio=0.0, seed=20)
    for i in range(n_train):
        p = os.path.join(out, f"train_{i}.mp4")
        render_pose_video(p, train_ds.poses[i], seed=200 + i)
        train_videos.append(p)
    test_videos, annotations, truth = [], {}, {}
    for name, kind, poses, seed in held_out_specs(n_test):
        p = os.path.join(out, f"{name}.mp4")
        render_pose_video(p, poses, seed=seed)
        test_videos.append(p)
        truth[name] = int(kind == "anomalous")
        ranges = [(1, T_VID)] if kind == "anomalous" else []
        annotations[name] = TemporalAnnotation(name, kind, ranges)
    return train_videos, test_videos, annotations, truth


def held_out_specs(n_test: int) -> List[Tuple[str, str, np.ndarray, int]]:
    """The held-out videos as (name, kind, canonical poses (T_VID, 17, 2),
    render seed): half normal from ``SyntheticPoseLiftDataset`` seed 30,
    half anomalous from seed 31, rendered with seeds 300 + i."""
    n_half = n_test // 2
    norm = SyntheticPoseLiftDataset(n_half, seq_len=T_VID, anomaly_ratio=0.0, seed=30)
    anom = SyntheticPoseLiftDataset(n_half, seq_len=T_VID, anomaly_ratio=1.0, seed=31)
    return [(f"test_{kind}_{i}", kind, ds.poses[i], 300 + i)
            for kind, ds in (("normal", norm), ("anomalous", anom)) for i in range(n_half)]


def extract_poses(cfg: Dict[str, Any], detector_state: Dict[str, torch.Tensor],
                  pose_model: TopDownPoseNet, train_videos: Sequence[str],
                  test_videos: Sequence[str], annotations: Dict[str, TemporalAnnotation],
                  out: str, device: torch.device) -> str:
    """A PoseLift dataset extracted with the trained detector and pose net,
    so the Shopformer trains on the poses it will see when streaming.
    Returns its directory."""
    print("== extracting PoseLift dataset ==")
    pipeline = DetectionPipeline(cfg, state_dict=detector_state, device=device,
                                 pose_model=pose_model)
    poselift_dir = os.path.join(out, "PoseLift")
    export_poselift_dataset(pipeline, train_videos, poselift_dir, "Train", verbose=False)
    export_poselift_dataset(pipeline, test_videos, poselift_dir, "Test",
                            annotations=annotations, verbose=False)
    return poselift_dir


def train_scorer(cfg: Dict[str, Any], poselift_dir: str, epochs: int, out: str,
                 device: torch.device) -> Tuple[Trainer, Dict[str, Any]]:
    """The Shopformer on the extracted poses, both stages, at the
    sweep-winning recipe (num_tokens 4 at hidden 32). Returns the trainer
    (its model holds the best stage-2 weights) and the fit's artifact."""
    print("== training shopformer on extracted pose sequences ==")
    cfg["data"].update(dataset="poselift", data_dir=poselift_dir, batch_size=64, stride=6)
    cfg["model"].update(hidden_channels=32, num_tokens=4)
    cfg["training"].update(stage1_epochs=epochs, stage2_epochs=epochs, lr=1e-3,
                           scan_epoch=True, scheduler="cosine_warmup")
    cfg["experiment"]["checkpoint_dir"] = os.path.join(out, "shopformer")
    trainer = Trainer(cfg, verbose=False, device=device).setup()
    artifact = trainer.fit()
    print(f"  END-TO-END extracted-pose test AUC: {artifact['test_metrics']['auc_roc']:.4f}")
    video = {k: round(v["auc_roc"], 4) for k, v in (artifact["video_metrics"] or {}).items()}
    print(f"  video-level: {video}")
    return trainer, artifact


def stream_and_evaluate(cfg: Dict[str, Any], scorer: ShopformerScorer,
                        detector_state: Dict[str, torch.Tensor], pose_model: TopDownPoseNet,
                        test_videos: Sequence[str], annotations: Dict[str, TemporalAnnotation],
                        truth: Dict[str, int], strides: Sequence[int],
                        device: torch.device) -> Dict[str, Any]:
    """Stream the held-out videos (8 at a time) and evaluate the events
    against the annotations under max and mean aggregation; then, per frame
    stride, a warm pass and a measured one (videos/h and AUC: the trade of
    ``detector.frame_stride``). Returns the results JSON's stream keys."""
    print("== streaming decode -> detect -> pose -> shopformer ==")
    pipe = StreamingPipeline(cfg, scorer, detector_state_dict=detector_state, device=device,
                             pose_model=pose_model)
    out = pipe.stream_videos_concurrent(test_videos, max_streams=8)
    agg = pipe.aggregate_events(out["events"])

    stride_table = {}
    for s in strides:
        scfg = {**cfg, "detector": {**cfg["detector"], "frame_stride": s}}
        sp = StreamingPipeline(scfg, scorer, detector_state_dict=detector_state, device=device,
                               pose_model=pose_model)
        sp.stream_videos_concurrent(test_videos, max_streams=8)  # warm pass
        so = sp.stream_videos_concurrent(test_videos, max_streams=8)
        sres = evaluate_streaming(so["events"], list(annotations.values()),
                                  include_eventless_videos=test_videos)
        stride_table[s] = {
            "videos_per_hour": so["videos_per_hour"], "fps": so["fps"],
            "video_auc": sres.video_auc, "video_auc_ci": list(sres.video_auc_ci),
            "event_auc": sres.event_auc, "n_events": sres.n_events,
            "stage_seconds": so["stage_seconds"],
        }
        print(f"  frame_stride={s}: {so['videos_per_hour']:.0f} videos/h "
              f"({so['fps']:.1f} fps) video AUC {sres.video_auc:.4f} "
              f"[{sres.video_auc_ci[0]:.3f},{sres.video_auc_ci[1]:.3f}] "
              f"event AUC {sres.event_auc:.4f} ({sres.n_events} windows)", flush=True)
    videos = {}
    for path in test_videos:
        name = os.path.basename(path)
        videos[name] = {"label": truth[os.path.splitext(name)[0]], **agg.get(name, {})}

    streaming = {}
    for how in ("max", "mean"):
        res = evaluate_streaming(out["events"], list(annotations.values()),
                                 include_eventless_videos=test_videos, aggregation=how)
        streaming[how] = res.as_dict()
        print(f"  streaming video AUC ({how} agg): {res.video_auc:.4f} "
              f"[95% CI {res.video_auc_ci[0]:.4f}, {res.video_auc_ci[1]:.4f}] "
              f"over {res.n_videos} videos")
    print(f"  streaming event (window) AUC: {res.event_auc:.4f} over {res.n_events} windows")
    print(f"  {out['frames']} frames at {out['fps']:.1f} fps, {len(out['events'])} scored windows")
    return {"videos": videos, "frames": out["frames"], "fps": out["fps"],
            "streaming": streaming, "frame_stride": stride_table, "events": out["events"]}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=2000, help="detector training steps")
    p.add_argument("--pose-steps", type=int, default=3000, help="top-down pose net steps")
    p.add_argument("--out", type=str, default=os.path.join(tempfile.gettempdir(), "e2e_synthetic"))
    p.add_argument("--img_size", type=int, default=128)
    p.add_argument("--test-videos", type=int, default=32,
                   help="held-out videos (half normal, half anomalous)")
    p.add_argument("--train-videos", type=int, default=256,
                   help="normal videos for Shopformer training")
    p.add_argument("--epochs", type=int, default=100, help="shopformer epochs/stage")
    p.add_argument("--frame-strides", default="1",
                   help="comma list; streams the test videos once per stride and reports "
                        "videos/hour + AUC for each")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card, raising without one)")
    args = p.parse_args(argv)
    require_cv2()
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(0)
    seconds: Dict[str, float] = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        r = fn(*a)
        seconds[name] = time.perf_counter() - t0
        return r

    det_trainer = timed("train_detector", train_detector, args.img_size, args.steps, rng,
                        args.out, device)
    pose_trainer, _rms, _rms_box = timed("train_pose_net", train_pose_net, args.pose_steps, rng,
                                         args.out, device)
    detector_state = det_trainer.eval_model(use_ema=True).state_dict()
    pose_model = pose_trainer.model.eval()
    cfg = detection_config(args.img_size)
    train_videos, test_videos, annotations, truth = timed(
        "render", render_videos, args.out, args.train_videos, args.test_videos)
    poselift_dir = timed("extract", extract_poses, cfg, detector_state, pose_model, train_videos,
                         test_videos, annotations, args.out, device)
    trainer, artifact = timed("train_scorer", train_scorer, cfg, poselift_dir, args.epochs,
                              args.out, device)
    strides = [int(s) for s in str(args.frame_strides).split(",") if s.strip()]
    stream = timed("stream_and_evaluate", stream_and_evaluate, cfg, trainer.scorer,
                   detector_state, pose_model, test_videos, annotations, truth, strides, device)
    results = {"videos": stream["videos"], "frames": stream["frames"], "fps": stream["fps"],
               "extracted_pose_auc": artifact["test_metrics"]["auc_roc"],
               "video_metrics": {k: v["auc_roc"] for k, v in
                                 (artifact["video_metrics"] or {}).items()},
               "streaming": stream["streaming"],
               "frame_stride": stream["frame_stride"]}
    with open(os.path.join(args.out, "e2e_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print("stage_seconds " + json.dumps(seconds), flush=True)
    return results


if __name__ == "__main__":
    main()
