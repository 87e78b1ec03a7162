"""Train and evaluate the detector with its pose head on HARD synthetic
scenes, on the PyTorch port; the counterpart of
``examples/train_detector_hard.py``.

The scenes are textured, multi-person, with scale variation, real occlusion,
clutter distractors and foreground occluders (``data/render.py::render_scene``).
The run reports the detection PR curve (AP@0.5), COCO mAP50-95 and the
keypoint RMS on held-out scenes, and writes them as JSON.

Each chunk of ``--scan-chunk`` steps draws its scenes from
``np.random.default_rng([seed, done])``, so a resumed run draws the scenes it
would have drawn; the chunks render in spawned processes ahead of the
training (one process a chunk, leaving the host two cores). After every chunk the trainer's state (weights, BatchNorm
statistics, Adam's moments and step count, the EMA and its step) is written
atomically beside ``--out`` (``<out>.partial.msgpack`` and
``<out>.partial.json``); a run that finds them resumes from them, and a
finished run removes them.

    python examples_torch/train_detector_hard.py [--steps 1200] [--img 320]
        [--save-checkpoint det.msgpack] [--device cpu]

Default device: the CUDA card, raising without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cvsd_tpu_torch.data.render import rendered_scene_batch  # noqa: E402
from cvsd_tpu_torch.data.synthetic import SyntheticPoseLiftDataset  # noqa: E402
from cvsd_tpu_torch.eval.detection import evaluate_detector  # noqa: E402
from cvsd_tpu_torch.models.detector import PersonDetector, make_detect_fn  # noqa: E402
from cvsd_tpu_torch.train.detector_train import DetectorTrainer  # noqa: E402
from cvsd_tpu_torch.utils import flax_msgpack  # noqa: E402
from cvsd_tpu_torch.utils.device import resolve_device  # noqa: E402

DTYPE = torch.bfloat16  # the detector's compute dtype, the reference's
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "detector_hard_results.json")


def scene_source() -> np.ndarray:
    """The pose sequences the scenes' people are drawn from (the reference's
    ``SyntheticPoseLiftDataset(64, 8, 0.5, seed=7)``), as (N, 17, 2)."""
    ds = SyntheticPoseLiftDataset(num_samples=64, seq_len=8, anomaly_ratio=0.5, seed=7)
    return ds.poses.reshape(-1, 17, 2)


def scene_chunk(seed: int, done: int, n: int, batch: int, img: int, max_persons: int,
                seq_source: np.ndarray) -> Tuple[np.ndarray, ...]:
    """The chunk of ``n`` training batches that starts at step ``done``:
    (images (n, B, S, S, 3), boxes (n, B, P, 4), valid (n, B, P), keypoints
    (n, B, P, 17, 2)), drawn from ``default_rng([seed, done])``."""
    rng = np.random.default_rng([seed, done])
    imgs = np.empty((n, batch, img, img, 3), np.float32)
    gb = np.empty((n, batch, max_persons, 4), np.float32)
    gv = np.empty((n, batch, max_persons), bool)
    gk = np.empty((n, batch, max_persons, 17, 2), np.float32)
    for i in range(n):
        imgs[i], gb[i], gv[i], gk[i] = rendered_scene_batch(rng, batch, img, max_persons,
                                                            seq_source)
    return imgs, gb, gv, gk


def held_out_scenes(seed: int, eval_size: int, img: int, max_persons: int,
                    seq_source: np.ndarray) -> Tuple[np.ndarray, ...]:
    """The held-out scenes, from ``default_rng(seed + 1000)`` (the reference's
    protocol, which ``eval_int8_accuracy.py`` shares)."""
    return rendered_scene_batch(np.random.default_rng(seed + 1000), eval_size, img,
                                max_persons, seq_source)


def build_trainer(args: argparse.Namespace, device: torch.device,
                  variables: Optional[Dict[str, Any]] = None) -> DetectorTrainer:
    """The reference's detector (pose head, ``DTYPE`` compute over float32
    master weights) and trainer (keypoint weight 0.1; warm-up + cosine over
    ``--steps`` with ``--cosine``; EMA ``--ema``)."""
    model = PersonDetector(img_size=args.img, width_mult=args.width, depth_mult=args.depth,
                           num_keypoints=17, dtype=DTYPE)
    return DetectorTrainer(model, lr=args.lr, kpt_weight=0.1,
                           total_steps=args.steps if args.cosine else 0,
                           warmup_steps=args.warmup_steps, ema_decay=args.ema,
                           variables=variables, device=device)


# -- the resume files -------------------------------------------------------------


def partial_paths(out: str) -> Tuple[str, str]:
    base = out + ".partial"
    return base + ".msgpack", base + ".json"


def _replace(path: str, data, mode: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, mode) as f:
        f.write(data)
    os.replace(tmp, path)


def trainer_state(trainer: DetectorTrainer) -> Dict[str, Any]:
    """Everything a step reads, as numpy: the module's state dict, Adam's
    per-parameter state and the EMA parameters."""
    adam = trainer.opt.inner.state_dict()["state"]
    state: Dict[str, Any] = {
        "model": {k: v.detach().cpu().numpy() for k, v in trainer.model.state_dict().items()},
        "adam": {str(i): {k: v.detach().cpu().numpy() for k, v in s.items()}
                 for i, s in adam.items()},
    }
    if trainer.ema_params is not None:
        state["ema"] = {str(i): e.detach().cpu().numpy() for i, e in enumerate(trainer.ema_params)}
    return state


def save_partial(out: str, trainer: DetectorTrainer, done: int, losses: Sequence[float]) -> None:
    """Write the mid-train state and the progress, each file atomically."""
    mp, js = partial_paths(out)
    _replace(mp, flax_msgpack.serialize(trainer_state(trainer)), "wb")
    _replace(js, json.dumps({"done": done, "ema_t": trainer._ema_t,
                             "opt_count": trainer.opt.count,
                             "losses": [float(x) for x in losses]}), "w")


@torch.no_grad()
def load_partial(out: str, trainer: DetectorTrainer) -> Tuple[int, List[float]]:
    """Restore the mid-train state where both files exist; returns (steps
    done, the losses so far)."""
    mp, js = partial_paths(out)
    if not (os.path.exists(mp) and os.path.exists(js)):
        return 0, []
    with open(js) as f:
        meta = json.load(f)
    with open(mp, "rb") as f:
        state = flax_msgpack.restore(f.read())
    trainer.model.load_state_dict({k: torch.as_tensor(v) for k, v in state["model"].items()})
    inner = trainer.opt.inner
    inner.load_state_dict({
        "state": {int(i): {k: torch.as_tensor(v) for k, v in s.items()}
                  for i, s in state["adam"].items()},
        "param_groups": inner.state_dict()["param_groups"]})
    trainer.opt.count = int(meta["opt_count"])
    if trainer.ema_params is not None:
        for i, e in enumerate(trainer.ema_params):
            e.copy_(torch.as_tensor(state["ema"][str(i)]))
    trainer._ema_t = int(meta["ema_t"])
    print(f"resumed from {mp} at step {meta['done']}", flush=True)
    return int(meta["done"]), list(meta["losses"])


def render_workers(chunks: int) -> int:
    """The processes that render the scenes: one a chunk, leaving two of the
    host's cores to the training process."""
    return max(1, min(chunks, (os.cpu_count() or 1) - 2))


def chunks(args: argparse.Namespace, seq_source: np.ndarray, start: int, end: int
           ) -> Iterator[Tuple[int, Tuple[np.ndarray, ...]]]:
    """(first step, scene chunk) for the chunks from ``start`` to ``end``.
    The chunks render in spawned processes from the moment this is called,
    ``render_workers`` chunks ahead of the one the caller takes; each chunk
    has its own seed, so they are the same bytes, in the same order, as
    ``scene_chunk`` gives in this process."""
    starts = list(range(start, end, args.scan_chunk))
    if not starts:
        return iter(())
    spec = [(args.seed, s, min(args.scan_chunk, end - s), args.batch, args.img,
             args.max_persons, seq_source) for s in starts]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    workers = render_workers(len(spec))
    pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
    ahead = [pool.submit(scene_chunk, *a) for a in spec[:workers]]

    def take() -> Iterator[Tuple[int, Tuple[np.ndarray, ...]]]:
        try:
            for i, s in enumerate(starts):
                if i + workers < len(spec):
                    ahead.append(pool.submit(scene_chunk, *spec[i + workers]))
                yield s, ahead[i].result()
                ahead[i] = None  # the chunk is the caller's now
        finally:
            pool.shutdown(cancel_futures=True)

    return take()


def train(trainer: DetectorTrainer, args: argparse.Namespace, seq_source: np.ndarray,
          stop_at: Optional[int] = None,
          scenes: Optional[Iterable[Tuple[int, Tuple[np.ndarray, ...]]]] = None) -> List[float]:
    """Resume where the partial files say, then train chunk by chunk up to
    ``--steps`` (or ``stop_at``), saving the partial files after each chunk.
    ``scenes`` holds (first step, chunk) pairs that ``chunks`` gave before,
    for a caller that trains on them again; without it the chunks render
    here. Returns every step's loss."""
    done, losses = load_partial(args.out, trainer)
    end = args.steps if stop_at is None else min(stop_at, args.steps)
    if scenes is None:
        scenes = chunks(args, seq_source, done, end)
    t0 = time.time()
    for start, chunk in scenes:
        if start < done:
            continue
        if start >= end:
            break
        res = trainer.train_steps_scan(*chunk)
        losses.extend(res["losses"].tolist())
        done += len(res["losses"])
        save_partial(args.out, trainer, done, losses)
        print(f"step {done}/{args.steps} loss {np.mean(res['losses']):.4f} "
              f"({time.time() - t0:.0f}s)", flush=True)
    return losses


def evaluate(trainer: DetectorTrainer, args: argparse.Namespace, seq_source: np.ndarray,
             device: torch.device) -> Dict[str, Any]:
    """``evaluate_detector`` (coco_map) on the held-out scenes through
    ``make_detect_fn`` at conf 0.25, IoU 0.45, 16 detections, with the EMA
    weights where EMA is on."""
    ev_imgs, ev_b, ev_v, ev_k = held_out_scenes(args.seed, args.eval_size, args.img,
                                                args.max_persons, seq_source)
    model = trainer.eval_model(use_ema=bool(args.ema))
    detect = make_detect_fn(model, conf_thresh=0.25, iou_thresh=0.45, max_detections=16)
    return evaluate_detector(detect, ev_imgs, ev_b, ev_v, ev_k, coco_map=True, device=device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--img", type=int, default=320)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--scan-chunk", type=int, default=50,
                    help="steps per chunk (one host-to-device copy, one resume point)")
    ap.add_argument("--eval-size", type=int, default=128, help="held-out scenes")
    ap.add_argument("--max-persons", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--width", type=float, default=0.375)
    ap.add_argument("--depth", type=float, default=0.34)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--save-checkpoint", default=None,
                    help="also save the trained detector (.msgpack) for reuse "
                         "(e.g. examples_torch/eval_int8_accuracy.py)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cosine", action="store_true",
                    help="warmup + cosine-decay LR over --steps")
    ap.add_argument("--warmup-steps", type=int, default=200)
    ap.add_argument("--ema", type=float, default=0.0,
                    help="EMA decay for eval/export params (0 = off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising without one)")
    return ap


def _jsonable(x):
    return x.tolist() if isinstance(x, np.ndarray) else float(x)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    print(f"device={device}", flush=True)
    seq_source = scene_source()
    trainer = build_trainer(args, device)
    t0 = time.time()
    losses = train(trainer, args, seq_source)
    res = evaluate(trainer, args, seq_source, device)
    summary = {
        "steps": args.steps, "img": args.img, "batch": args.batch,
        "width_mult": args.width, "depth_mult": args.depth,
        "train_loss_first50": float(np.mean(losses[:50])),
        "train_loss_last50": float(np.mean(losses[-50:])),
        "eval_scenes": args.eval_size,
        "ap50": float(res["ap"]), "num_gt": int(res["num_gt"]), "num_pred": int(res["num_pred"]),
        "map50_95": res.get("map50_95"), "map75": res.get("map75"),
        "pose_map50_95": res.get("pose_map50_95"),
        "keypoints": res.get("keypoints"),
        "seconds": round(time.time() - t0, 1),
    }
    summary["cosine"] = args.cosine
    summary["ema"] = args.ema
    if args.save_checkpoint:
        trainer.save(args.save_checkpoint, use_ema=bool(args.ema))
        print(f"saved checkpoint -> {args.save_checkpoint}")
    print(json.dumps(summary, indent=2, default=_jsonable))
    precision, recall = np.asarray(res["precision"]), np.asarray(res["recall"])
    with open(args.out, "w") as f:
        json.dump({**summary,
                   "precision": precision.tolist()[::max(len(precision) // 200, 1)],
                   "recall": recall.tolist()[::max(len(recall) // 200, 1)]}, f,
                  default=_jsonable)
    for p in partial_paths(args.out):
        if os.path.exists(p):
            os.remove(p)
    return summary


if __name__ == "__main__":
    main()
