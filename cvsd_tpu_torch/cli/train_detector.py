"""Train or fine-tune the person detector on a YOLO-format dataset.

    python -m cvsd_tpu_torch.cli.train_detector --data data.yaml \\
        --steps 1200 --img 320 --save-checkpoint detector.msgpack
    python -m cvsd_tpu_torch.cli.train_detector --images ds/images/train --steps 8 --device cpu

The ultralytics ``yolo train data=data.yaml`` workflow (the port's copy of
``cvsd_tpu/cli/train_detector.py``, every flag of it, plus ``--device``):
loads the YOLO layout (images/ + labels/ txt, optional pose keypoints; cv2
reads the images), runs ``DetectorTrainer`` in chunks of ``--scan-chunk``
steps (warmup + cosine, optional EMA), evaluates AP and mAP50-95 on a
held-out fraction (optionally every ``--eval-every`` steps, keeping the best
at ``<save-checkpoint>.best.msgpack``), prints a summary JSON and saves a
checkpoint that either package's ``--detector_checkpoint`` reads. From the
same seed and ``--init-checkpoint`` it draws the same split and batches as
the reference. ``--device`` unset means the CUDA card, an error without one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from cvsd_tpu_torch.cli.common import add_config_args
from cvsd_tpu_torch.utils.device import resolve_device


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_config_args(p)
    p.add_argument("--data", type=str, default=None, help="ultralytics data.yaml")
    p.add_argument("--split", type=str, default="train", help="data.yaml split key")
    p.add_argument("--images", type=str, default=None, help="images dir (alternative to --data)")
    p.add_argument("--labels", type=str, default=None,
                   help="labels dir (default: images dir with 'images'->'labels')")
    p.add_argument("--init-checkpoint", type=str, default=None,
                   help="starting weights (a DetectorTrainer.save file of either package)")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--img", type=int, default=320)
    p.add_argument("--width", type=float, default=0.375)
    p.add_argument("--depth", type=float, default=0.34)
    p.add_argument("--kpts", type=int, default=None,
                   help="keypoints per object (default: from the init "
                        "checkpoint, else data.yaml kpt_shape, else 0)")
    p.add_argument("--max-persons", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ema", type=float, default=0.0, help="EMA decay (0 = off)")
    p.add_argument("--scan-chunk", type=int, default=25,
                   help="steps per host-to-device copy of their batches")
    p.add_argument("--eval-frac", type=float, default=0.1,
                   help="held-out fraction for AP eval (0 = skip)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="steps between held-out evals; keeps the best-mAP "
                        "checkpoint at <save-checkpoint>.best.msgpack "
                        "(ultralytics best.pt/last.pt pattern)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-checkpoint", type=str, default="detector.msgpack")
    p.add_argument("--output", type=str, default=None, help="summary JSON")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # a missing card is reported before any file

    from cvsd_tpu_torch.data.yolo_dataset import YOLODetectionDataset
    from cvsd_tpu_torch.eval.detection import evaluate_detector
    from cvsd_tpu_torch.models.detector import (PersonDetector, load_detector_checkpoint,
                                                make_detect_fn)
    from cvsd_tpu_torch.train.detector_train import DetectorTrainer

    kpts = args.kpts
    variables = None
    if args.init_checkpoint:
        model, variables, _meta = load_detector_checkpoint(args.init_checkpoint, device=device)
        if model.img_size != args.img:
            print(f"note: checkpoint img_size {model.img_size} overrides --img")
        if kpts is not None and kpts != model.num_keypoints:
            print(f"note: checkpoint num_keypoints {model.num_keypoints} "
                  f"overrides --kpts {kpts}")
        # the checkpoint's pose head dictates kpts: training a pose head
        # against the zero-filled default targets would regress every
        # keypoint to the canvas origin
        kpts = model.num_keypoints
    else:
        if kpts is None and args.data:
            import yaml

            with open(args.data) as f:
                spec = yaml.safe_load(f) or {}
            if spec.get("kpt_shape"):
                kpts = int(spec["kpt_shape"][0])
                print(f"note: data.yaml kpt_shape -> {kpts} keypoints")
        kpts = kpts or 0
        model = PersonDetector(img_size=args.img, width_mult=args.width,
                               depth_mult=args.depth, num_keypoints=kpts)
    args.kpts = kpts

    # the dataset letterboxes to the MODEL's canvas (an init checkpoint's
    # img_size wins over --img)
    kw = dict(img_size=model.img_size, max_persons=args.max_persons, num_keypoints=kpts)
    if args.data:
        ds = YOLODetectionDataset.from_data_yaml(args.data, split=args.split, **kw)
    elif args.images:
        ds = YOLODetectionDataset(args.images, labels_dir=args.labels, **kw)
    else:
        p.error("one of --data / --images is required")
    print(f"dataset: {len(ds)} images from {ds.images_dir}")

    rng = np.random.default_rng(args.seed)
    n_eval = int(len(ds) * args.eval_frac)
    order = rng.permutation(len(ds))
    eval_idx, train_idx = order[:n_eval], order[n_eval:]
    trainer = DetectorTrainer(model, lr=args.lr, seed=args.seed, total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 1), ema_decay=args.ema,
                              variables=variables, device=device)

    def sample_batch():
        idxs = rng.choice(train_idx, size=args.batch, replace=len(train_idx) < args.batch)
        S, P, K = model.img_size, args.max_persons, max(args.kpts, 0)
        imgs = np.zeros((args.batch, S, S, 3), np.float32)
        boxes = np.zeros((args.batch, P, 4), np.float32)
        valid = np.zeros((args.batch, P), bool)
        kpts = np.zeros((args.batch, P, K, 2), np.float32) if K else None
        for j, i in enumerate(idxs):
            im, bx, vl, kp = ds.load(int(i))
            imgs[j], boxes[j], valid[j] = im, bx, vl
            if K:
                kpts[j] = kp
        return imgs, boxes, valid, kpts

    # held-out arrays built once (also reused by periodic eval)
    ev_imgs = ev_b = ev_v = ev_k = None
    if n_eval:
        S, P, K = model.img_size, args.max_persons, max(kpts, 1)
        ev_imgs = np.zeros((n_eval, S, S, 3), np.float32)
        ev_b = np.zeros((n_eval, P, 4), np.float32)
        ev_v = np.zeros((n_eval, P), bool)
        ev_k = np.zeros((n_eval, P, K, 2), np.float32)
        for j, i in enumerate(eval_idx):
            ev_imgs[j], ev_b[j], ev_v[j], kp = ds.load(int(i))
            if kpts:
                ev_k[j] = kp

    def run_eval():
        detect = make_detect_fn(trainer.eval_model(use_ema=bool(args.ema)), conf_thresh=0.25,
                                iou_thresh=0.45, max_detections=args.max_persons)
        return evaluate_detector(detect, ev_imgs, ev_b, ev_v, ev_k if kpts else None,
                                 coco_map=True, device=device)

    t0 = time.time()
    losses: list = []
    done = 0
    best_map = -1.0
    next_eval = args.eval_every or None
    last_eval = None  # (step, result): the final eval is not run twice
    while done < args.steps:
        n = min(args.scan_chunk, args.steps - done)
        batches = [sample_batch() for _ in range(n)]
        out = trainer.train_steps_scan(
            np.stack([b[0] for b in batches]),
            np.stack([b[1] for b in batches]),
            np.stack([b[2] for b in batches]),
            np.stack([b[3] for b in batches]) if kpts else None)
        losses.extend(np.asarray(out["losses"]).tolist())
        done += n
        print(f"step {done}/{args.steps} loss {np.mean(out['losses']):.4f} "
              f"({time.time()-t0:.0f}s)", flush=True)
        if next_eval is not None and done >= next_eval and n_eval:
            res = run_eval()
            last_eval = (done, res)
            m = float(res["map50_95"] if res.get("map50_95") is not None else res["ap"])
            print(f"  eval@{done}: AP@50 {res['ap']:.4f} "
                  f"mAP50-95 {res.get('map50_95', 0):.4f}", flush=True)
            if m > best_map:
                best_map = m
                trainer.save(args.save_checkpoint + ".best.msgpack",
                             use_ema=bool(args.ema), step=done,
                             map50_95=m, ap50=float(res["ap"]))
                print(f"  new best ({m:.4f}) -> "
                      f"{args.save_checkpoint}.best.msgpack", flush=True)
            next_eval = done + args.eval_every

    summary = {
        "images": len(ds), "steps": args.steps,
        "train_loss_first": float(np.mean(losses[: args.scan_chunk])),
        "train_loss_last": float(np.mean(losses[-args.scan_chunk:])),
        "seconds": round(time.time() - t0, 1),
    }
    if n_eval:
        res = (last_eval[1] if last_eval is not None and last_eval[0] == done
               else run_eval())
        summary.update(ap50=res["ap"], map50_95=res.get("map50_95"),
                       pose_map50_95=res.get("pose_map50_95"),
                       eval_images=n_eval, best_map50_95=best_map if best_map >= 0 else None)
        print(f"eval: AP@50 {res['ap']:.4f} mAP50-95 {res.get('map50_95', 0):.4f}")
    trainer.save(args.save_checkpoint, use_ema=bool(args.ema))
    print(f"saved checkpoint -> {args.save_checkpoint}")
    print(json.dumps(summary))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(summary, f)


if __name__ == "__main__":
    main()
