"""Train the synthetic example's detector and top-down pose net in both
packages from ONE initialisation on ONE batch sequence, and print where
their trajectories part.

The port's synthetic chain reads window AUCs below the reference's rows
(ROADMAP.md, fault 1). This probe asks whether the port's trainers are the
cause: the example's detector (img 128, width 0.25, depth 0.34, float32)
starts from the JAX ``DetectorTrainer``'s own flax init, carried into the
port's ``DetectorTrainer`` through ``utils/weights.py``; both get the
example's exact batches (``np.random.default_rng(0)``, chunks of
``rendered_detection_batch(rng, 8, 128)``) with its recipe (lr 2e-3, 2000
total steps, 100 warm-up, EMA 0.998). The same for the top-down pose net
(``rendered_pose_crop_batch(rng, 32)``, lr 1e-3, 3000 total steps), whose
rng continues after the detector's 2000 steps of draws, as in the example.

Per chunk it prints one ``trajectory {...}`` JSON line per trainer:
  - the chunk's first and last loss in each package;
  - the largest relative parameter gap (max |port - jax| / max |jax| over
    each parameter tensor, the largest over tensors, with its name) and the
    relative L2 gap over all parameters, and the same for the EMA weights
    (detector);
  - recall at the stream's conf 0.3 and 4 detections on the 256 held-out
    scenes of ``synthetic_auc_probe.py``, for each package's EMA weights,
    both evaluated by the port's ``evaluate_detector``; for the pose net,
    the held-out keypoint RMS (the example's 128 crops of seed 9999).
Float32 drift between equal trainers stays small and unbiased; a gap that
grows steadily, or a recall or RMS that trails in one package, names the
stage.

This is a CPU probe beside the JAX package (it imports jax and cvsd_tpu
inside ``main``); nothing of the port depends on it.

    JAX_PLATFORMS=cpu python examples_torch/trainer_trajectory_probe.py \\
        --det-steps 400 --pose-steps 300
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

IMG = 128
DET_TOTAL, DET_CHUNK = 2000, 200
POSE_TOTAL, POSE_CHUNK = 3000, 250


def tree_gap(port: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, Any]:
    """Two flax trees' gap: the largest relative gap of one leaf (max |port -
    jax| / max |jax| over the leaf) with its name, and the relative L2 gap
    over all leaves together (||port - jax|| / ||jax||). A leaf that starts
    at 0 (a bias) and whose gradient is rounding noise reads large on the
    first; the second weighs each parameter by its size."""
    import jax

    def leaves(tree):
        return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    a, b = leaves(port), leaves(ref)
    if set(a) != set(b):
        raise ValueError(f"the trees differ in their leaves: {sorted(set(a) ^ set(b))[:4]}")
    per = {k: float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-12)) for k in b}
    worst = max(per, key=per.get)
    diff = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    norm = sum(float((b[k] ** 2).sum()) for k in b)
    return {"max": per[worst], "leaf": worst, "l2": (diff / max(norm, 1e-30)) ** 0.5}


def detector_recall(variables: Dict[str, Any]) -> Dict[str, float]:
    """Recall (and AP50) at the stream's conf 0.3 / 4 detections of a
    detector with these flax variables, by the port's evaluator."""
    from synthetic_auc_probe import HELD_OUT_SCENES, HELD_OUT_SEED

    from cvsd_tpu_torch.data.render import rendered_detection_batch
    from cvsd_tpu_torch.eval.detection import evaluate_detector
    from cvsd_tpu_torch.models.detector import PersonDetector, make_detect_fn
    from cvsd_tpu_torch.utils.weights import load_flax_variables

    model = load_flax_variables(
        PersonDetector(img_size=IMG, width_mult=0.25, depth_mult=0.34, dtype=torch.float32),
        variables).eval()
    images, boxes, valid, _k = rendered_detection_batch(
        np.random.default_rng(HELD_OUT_SEED), HELD_OUT_SCENES, IMG)
    res = evaluate_detector(make_detect_fn(model, 0.3, 0.45, 4), images, boxes, valid,
                            device="cpu")
    recall = np.asarray(res["recall"])
    return {"recall": float(recall[-1]) if recall.size else 0.0, "ap50": float(res["ap"])}


def pose_rms(model) -> float:
    """Held-out keypoint RMS in frame pixels (the example's pose gate)."""
    from cvsd_tpu_torch.data.render import rendered_pose_crop_batch
    from cvsd_tpu_torch.models.pose_topdown import pose_from_boxes

    ev_f, ev_b, ev_k = rendered_pose_crop_batch(np.random.default_rng(9999), 128,
                                                joint_jitter=0.0)
    with torch.no_grad():
        kp, _ = pose_from_boxes(model.eval(), torch.from_numpy(ev_f),
                                torch.from_numpy(ev_b)[:, None, :])
    err = np.linalg.norm(kp.numpy()[:, 0, :, :2] - ev_k, axis=-1)
    return float(np.sqrt((err ** 2).mean()))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--det-steps", type=int, default=400)
    p.add_argument("--pose-steps", type=int, default=300)
    p.add_argument("--pose-chunk", type=int, default=100)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
    from cvsd_tpu.models.pose_topdown import TopDownPoseNet as TopDownPoseNetJax
    from cvsd_tpu.models.pose_topdown import pose_from_boxes as pose_from_boxes_jax
    from cvsd_tpu.train.detector_train import DetectorTrainer as DetectorTrainerJax
    from cvsd_tpu.train.pose_topdown_train import TopDownPoseTrainer as TopDownPoseTrainerJax
    from cvsd_tpu_torch.data.render import rendered_detection_batch, rendered_pose_crop_batch
    from cvsd_tpu_torch.models.detector import PersonDetector
    from cvsd_tpu_torch.models.pose_topdown import TopDownPoseNet
    from cvsd_tpu_torch.train.detector_train import DetectorTrainer
    from cvsd_tpu_torch.train.pose_topdown_train import TopDownPoseTrainer
    from cvsd_tpu_torch.utils.weights import load_flax_variables

    rng = np.random.default_rng(0)
    jdet = DetectorTrainerJax(
        PersonDetectorJax(img_size=IMG, width_mult=0.25, depth_mult=0.34, dtype=jnp.float32),
        lr=2e-3, total_steps=DET_TOTAL, warmup_steps=100, ema_decay=0.998)
    tdet = DetectorTrainer(
        PersonDetector(img_size=IMG, width_mult=0.25, depth_mult=0.34, dtype=torch.float32),
        lr=2e-3, total_steps=DET_TOTAL, warmup_steps=100, ema_decay=0.998,
        variables=jax.device_get(jdet.variables), device="cpu")
    print("trajectory " + json.dumps({"net": "detector", "steps": 0,
                                      "param_gap": tree_gap(tdet.variables, jdet.variables)}),
          flush=True)
    done = 0
    while done < args.det_steps:
        n = min(DET_CHUNK, args.det_steps - done)
        data = [rendered_detection_batch(rng, 8, IMG) for _ in range(n)]
        batch = [np.stack([d[i] for d in data]) for i in range(3)]
        lj = np.asarray(jdet.train_steps_scan(*batch)["losses"])
        lt = np.asarray(tdet.train_steps_scan(*batch)["losses"])
        done += n
        jema = jax.device_get(jdet.ema_variables)
        print("trajectory " + json.dumps({
            "net": "detector", "steps": done,
            "loss_jax": [float(lj[0]), float(lj[-1])], "loss_port": [float(lt[0]), float(lt[-1])],
            "loss_gap_max": float(np.abs(lj - lt).max()),
            "param_gap": tree_gap(tdet.variables, jax.device_get(jdet.variables)),
            "ema_gap": tree_gap(tdet.ema_variables, jema),
            "jax_ema": detector_recall(jema), "port_ema": detector_recall(tdet.ema_variables),
        }), flush=True)
    # the example's pose rng continues after the detector's full 2000 steps
    for _ in range(DET_TOTAL - done):
        rendered_detection_batch(rng, 8, IMG)

    jpose_model = TopDownPoseNetJax(num_keypoints=17, width=32, crop_size=64)
    jpose = TopDownPoseTrainerJax(jpose_model, lr=1e-3, total_steps=POSE_TOTAL)
    tpose = TopDownPoseTrainer(TopDownPoseNet(num_keypoints=17, width=32, crop_size=64),
                               lr=1e-3, total_steps=POSE_TOTAL,
                               variables=jax.device_get(jpose.variables), device="cpu")
    ev_f, ev_b, ev_k = rendered_pose_crop_batch(np.random.default_rng(9999), 128,
                                                joint_jitter=0.0)

    def jax_rms() -> float:
        kp, _ = pose_from_boxes_jax(jpose_model, jpose.variables, jnp.asarray(ev_f),
                                    jnp.asarray(ev_b)[:, None, :])
        err = np.linalg.norm(np.asarray(kp)[:, 0, :, :2] - ev_k, axis=-1)
        return float(np.sqrt((err ** 2).mean()))

    done = 0
    while done < args.pose_steps:
        n = min(args.pose_chunk, args.pose_steps - done)
        data = [rendered_pose_crop_batch(rng, 32) for _ in range(n)]
        batch = [np.stack([d[i] for d in data]) for i in range(3)]
        lj = np.asarray(jpose.train_steps_scan(*batch)["losses"])
        lt = np.asarray(tpose.train_steps_scan(*batch)["losses"])
        done += n
        port_model = load_flax_variables(TopDownPoseNet(17, 32, 64), tpose.variables)
        print("trajectory " + json.dumps({
            "net": "pose", "steps": done,
            "loss_jax": [float(lj[0]), float(lj[-1])], "loss_port": [float(lt[0]), float(lt[-1])],
            "loss_gap_max": float(np.abs(lj - lt).max()),
            "param_gap": tree_gap(tpose.variables, jax.device_get(jpose.variables)),
            "rms_jax": jax_rms(), "rms_port": pose_rms(port_model),
        }), flush=True)


if __name__ == "__main__":
    main()
