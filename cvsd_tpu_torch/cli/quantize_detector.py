"""Quantize a trained detector checkpoint to int8 for serving (the port's
``cvsd_tpu/cli/quantize_detector.py``).

Post-training quantization (``models/detector_int8.py``): fold BatchNorm,
compute per-output-channel int8 weight scales, calibrate per-tensor
activation scales on representative frames, optionally fine-tune with
fake quantization (``--qat_steps``), and save a checkpoint with
``detector.quantized=true``. Every detector consumer loads it: the
``--detector_checkpoint`` of cli.stream, cli.preprocess, cli.serve,
cli.pose_export and cli.annotate, ``load_detector_checkpoint`` and
``DetectionPipeline``, in either package.

    python -m cvsd_tpu_torch.cli.quantize_detector \
        --detector_checkpoint ckpt.msgpack --output ckpt_int8.msgpack \
        --calib_video a.mp4 --calib_video b.mp4 [--device cpu]
"""

from __future__ import annotations

import argparse


def _letterboxed_batches(videos, size: int, batch: int, max_frames: int):
    """Decode calibration videos and host-letterbox to (B, size, size, 3)
    float32 in [0, 1]: the serving path's input distribution."""
    import numpy as np

    from cvsd_tpu_torch.data.video import VideoBatcher, _cv2
    from cvsd_tpu_torch.ops.letterbox import PAD_VALUE, letterbox_params

    cv2 = _cv2()  # raises naming cv2 where it is missing
    frames, total = [], 0
    for path in videos:
        for fb in VideoBatcher(path, batch_size=batch):
            for frame in fb.frames[fb.mask]:
                H, W = frame.shape[:2]
                _scale, px, py, nw, nh = letterbox_params(H, W, size)
                canvas = np.full((size, size, 3), PAD_VALUE, np.uint8)
                canvas[py:py + nh, px:px + nw] = cv2.resize(
                    frame, (nw, nh), interpolation=cv2.INTER_LINEAR)
                frames.append(canvas)
                total += 1
                if total >= max_frames:
                    break
            if total >= max_frames:
                break
        if total >= max_frames:
            break
    if not frames:
        raise SystemExit("no calibration frames decoded")
    arr = np.stack(frames).astype(np.float32) / 255.0
    return [arr[i:i + batch] for i in range(0, len(arr), batch)]


def _synthetic_batches(size: int, batch: int, n_batches: int):
    import numpy as np

    from cvsd_tpu_torch.train.detector_train import synthetic_detection_batch

    rng = np.random.default_rng(0)
    return [synthetic_detection_batch(rng, batch, size)[0] for _ in range(n_batches)]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--detector_checkpoint", required=True, help="float checkpoint (.msgpack)")
    p.add_argument("--output", required=True, help="output int8 checkpoint path")
    p.add_argument("--calib_video", action="append", default=[],
                   help="calibration video (repeatable); default: synthetic frames")
    p.add_argument("--calib_frames", type=int, default=256,
                   help="max calibration frames")
    p.add_argument("--calib_batch", type=int, default=16)
    p.add_argument("--calib_size", type=int, default=0,
                   help="letterbox canvas for calibration (0 = model img_size; "
                        "set to your serving auto_size canvas for best match)")
    p.add_argument("--margin", type=float, default=1.0,
                   help="activation range margin (scale = absmax*margin/127)")
    p.add_argument("--qat_steps", type=int, default=0,
                   help="fake-quant fine-tune steps (train/qat.py) on rendered "
                        "skeleton scenes before emitting the int8 checkpoint: "
                        "the PTQ-loss recovery path")
    p.add_argument("--qat_lr", type=float, default=1e-4)
    p.add_argument("--qat_batch", type=int, default=16)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card, an error without one; "
                        "'cpu' runs on the host)")
    args = p.parse_args(argv)

    from cvsd_tpu_torch.models.detector import load_detector_checkpoint
    from cvsd_tpu_torch.models.detector_int8 import quantize_detector
    from cvsd_tpu_torch.utils.checkpoint import save_checkpoint
    from cvsd_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)  # a missing card is reported before any file is read
    model, variables, meta = load_detector_checkpoint(args.detector_checkpoint, dev)
    det_cfg = dict(((meta or {}).get("config") or {}).get("detector") or {})
    if det_cfg.get("quantized"):
        raise SystemExit(f"{args.detector_checkpoint} is already quantized")
    size = args.calib_size or model.img_size
    if args.calib_video:
        batches = _letterboxed_batches(args.calib_video, size,
                                       args.calib_batch, args.calib_frames)
    else:
        n = max(1, args.calib_frames // args.calib_batch)
        batches = _synthetic_batches(size, args.calib_batch, n)
    _qmodel, qvars = quantize_detector(model, variables, batches, margin=args.margin)
    if args.qat_steps:
        import numpy as np

        from cvsd_tpu_torch.data.render import rendered_detection_batch
        from cvsd_tpu_torch.models.detector_int8 import finalize_qat, prepare_qat
        from cvsd_tpu_torch.train.qat import QATFineTuner

        qat_model, qat_vars = prepare_qat(model, variables, batches, margin=args.margin)
        tuner = QATFineTuner(qat_model, qat_vars, lr=args.qat_lr,
                             total_steps=args.qat_steps,
                             warmup_steps=args.qat_steps // 10, device=dev)
        rng = np.random.default_rng(0)
        done = 0
        while done < args.qat_steps:
            n = min(25, args.qat_steps - done)
            data = [rendered_detection_batch(rng, args.qat_batch, model.img_size)
                    for _ in range(n)]
            out = tuner.train_steps_scan(
                np.stack([d[0] for d in data]), np.stack([d[1] for d in data]),
                np.stack([d[2] for d in data]),
                np.stack([d[3] for d in data]) if model.num_keypoints else None)
            done += n
            print(f"  qat {done}/{args.qat_steps} loss {out['losses'][-1]:.3f}",
                  flush=True)
        qvars = finalize_qat(tuner.variables)
    det_cfg.update({
        "img_size": model.img_size, "width_mult": model.width_mult,
        "depth_mult": model.depth_mult, "pose_head": bool(model.num_keypoints),
        "num_keypoints": model.num_keypoints, "head_variant": model.head_variant,
        "num_classes": model.num_classes, "reg_max": model.reg_max,
        "quantized": True,
    })
    n_calib = sum(b.shape[0] for b in batches)
    save_checkpoint(args.output, qvars,
                    config={**((meta or {}).get("config") or {}), "detector": det_cfg},
                    source=args.detector_checkpoint, calib_frames=n_calib,
                    calib_margin=args.margin)
    print(f"quantized {args.detector_checkpoint} -> {args.output} "
          f"(calibrated on {n_calib} frames @ {size})")


if __name__ == "__main__":
    main()
