"""Accuracy cost of int8 PTQ on a trained detector, on the PyTorch port: AP@50,
mAP50-95 and keypoint RMS, float against quantized, on the held-out hard
scenes of ``train_detector_hard.py``; the counterpart of
``examples/eval_int8_accuracy.py``.

Calibration uses fresh training-distribution scenes (``seed + 5000``); the
held-out scenes are ``train_detector_hard.py``'s (``seed + 1000``). With
``--qat-steps`` a fake-quant fine-tune (``train/qat.py``, scenes from
``seed + 9000``, chunks of 25 steps) runs before a third evaluation, the
path that recovers what PTQ loses.

    python examples_torch/train_detector_hard.py --save-checkpoint det.msgpack
    python examples_torch/eval_int8_accuracy.py --checkpoint det.msgpack [--device cpu]

Default device: the CUDA card, raising without one. On the card the int8
convolutions run ``torch._int_mm``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from cvsd_tpu_torch.data.render import rendered_scene_batch  # noqa: E402
from cvsd_tpu_torch.eval.detection import evaluate_detector  # noqa: E402
from cvsd_tpu_torch.models.detector import load_detector_checkpoint, make_detect_fn  # noqa: E402
from cvsd_tpu_torch.models.detector_int8 import (finalize_qat, prepare_qat,  # noqa: E402
                                                 quantize_detector)
from cvsd_tpu_torch.train.qat import QATFineTuner  # noqa: E402
from cvsd_tpu_torch.utils.device import resolve_device  # noqa: E402
from cvsd_tpu_torch.utils.weights import load_flax_variables  # noqa: E402
from train_detector_hard import held_out_scenes, scene_source  # noqa: E402

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "int8_accuracy_results.json")
QAT_CHUNK = 25


def calibration_batches(seed: int, n: int, batch: int, img: int, max_persons: int,
                        seq_source: np.ndarray):
    """``n`` batches of training-distribution scenes from a fresh stream
    (``default_rng(seed + 5000)``): the images only."""
    rng = np.random.default_rng(seed + 5000)
    return [rendered_scene_batch(rng, batch, img, max_persons, seq_source)[0]
            for _ in range(n)]


def row(res: Dict[str, Any]) -> Dict[str, Any]:
    """One model's row of the results."""
    return {"ap50": float(res["ap"]), "map50_95": res.get("map50_95"),
            "pose_map50_95": res.get("pose_map50_95"),
            "num_pred": int(res["num_pred"]), "keypoints": res.get("keypoints")}


def evaluate(model, held_out, device) -> Dict[str, Any]:
    detect = make_detect_fn(model, conf_thresh=0.25, iou_thresh=0.45, max_detections=16)
    return evaluate_detector(detect, *held_out, coco_map=True, device=device)


def qat_serving_variables(model, variables, calib, args, img, seq_source, device):
    """Fine-tune the fake-quant mirror for ``--qat-steps`` and return the
    serving int8 variables (``finalize_qat``)."""
    qat_model, qat_vars = prepare_qat(model, variables, calib, margin=args.margin)
    tuner = QATFineTuner(qat_model, qat_vars, lr=args.qat_lr, total_steps=args.qat_steps,
                         warmup_steps=args.qat_steps // 10, device=device)
    ft_rng = np.random.default_rng(args.seed + 9000)
    done = 0
    while done < args.qat_steps:
        n = min(QAT_CHUNK, args.qat_steps - done)
        batches = [rendered_scene_batch(ft_rng, args.qat_batch, img, args.max_persons,
                                        seq_source) for _ in range(n)]
        out = tuner.train_steps_scan(
            np.stack([b[0] for b in batches]), np.stack([b[1] for b in batches]),
            np.stack([b[2] for b in batches]),
            np.stack([b[3] for b in batches]) if model.num_keypoints else None)
        done += n
        print(f"  qat {done}/{args.qat_steps} loss {out['losses'][-1]:.3f}", flush=True)
    return finalize_qat(tuner.variables)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True,
                    help="detector checkpoint from train_detector_hard.py --save-checkpoint")
    ap.add_argument("--eval-size", type=int, default=128)
    ap.add_argument("--max-persons", type=int, default=4)
    ap.add_argument("--calib-batches", type=int, default=8)
    ap.add_argument("--calib-batch", type=int, default=16)
    ap.add_argument("--margin", type=float, default=1.0)
    ap.add_argument("--qat-steps", type=int, default=0,
                    help="optional fake-quant fine-tune steps (train/qat.py) "
                         "before re-evaluating: the PTQ-loss recovery path")
    ap.add_argument("--qat-lr", type=float, default=1e-4)
    ap.add_argument("--qat-batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0, help="must match the training run")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising without one)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    model, variables, _meta = load_detector_checkpoint(args.checkpoint, device)
    img = model.img_size
    seq_source = scene_source()
    calib = calibration_batches(args.seed, args.calib_batches, args.calib_batch, img,
                                args.max_persons, seq_source)
    qmodel, qvars = quantize_detector(model, variables, calib, margin=args.margin)
    held_out = held_out_scenes(args.seed, args.eval_size, img, args.max_persons, seq_source)

    results: Dict[str, Any] = {}
    for name, m in (("float", model), ("int8", qmodel)):
        res = evaluate(m, held_out, device)
        results[name] = row(res)
        print(f"{name}: AP@50 {res['ap']:.4f}  mAP50-95 {res.get('map50_95', 0):.4f}"
              f"  preds {res['num_pred']}", flush=True)

    if args.qat_steps:
        serving_vars = qat_serving_variables(model, variables, calib, args, img, seq_source,
                                             device)
        load_flax_variables(qmodel, serving_vars)
        res = evaluate(qmodel, held_out, device)
        results["int8_qat"] = {**row(res), "steps": args.qat_steps}
        print(f"int8+qat: AP@50 {res['ap']:.4f}  preds {res['num_pred']}", flush=True)

    results["ap50_delta"] = results["int8"]["ap50"] - results["float"]["ap50"]
    results["eval_scenes"] = args.eval_size
    results["calib_frames"] = args.calib_batches * args.calib_batch
    results["margin"] = args.margin
    print(json.dumps(results, default=float))
    with open(args.out, "w") as f:
        json.dump(results, f, default=float)
    return results


if __name__ == "__main__":
    main()
