"""Write annotated videos: boxes, track IDs, skeletons, anomaly scores (the
port's ``cvsd_tpu/cli/annotate.py``).

    python -m cvsd_tpu_torch.cli.annotate --checkpoint ckpt/stage2_best.msgpack \
        --videos a.mp4 b.mp4 --out-dir annotated/ [--device cpu]
    python -m cvsd_tpu_torch.cli.annotate --detector_checkpoint det.msgpack \
        --videos a.mp4          # detector only: boxes and track IDs
"""

from __future__ import annotations

import argparse
import json
import os

from cvsd_tpu_torch.cli.common import add_config_args


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_config_args(p)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Shopformer checkpoint (omit for detector-only "
                        "annotation: boxes + track IDs, no anomaly scores)")
    p.add_argument("--detector_checkpoint", type=str, default=None)
    p.add_argument("--videos", nargs="+", required=True)
    p.add_argument("--out-dir", type=str, default="annotated")
    p.add_argument("--threshold", type=float, default=0.5,
                   help="anomaly threshold for the red/green box coloring")
    p.add_argument("--fourcc", type=str, default="mp4v")
    p.add_argument("--output", type=str, default=None, help="summary JSON path")
    args = p.parse_args(argv)
    if not args.checkpoint and not args.detector_checkpoint:
        p.error("one of --checkpoint / --detector_checkpoint is required")

    from cvsd_tpu_torch.cli.common import load_detector_cli, resolve_config
    from cvsd_tpu_torch.config import apply_overrides
    from cvsd_tpu_torch.viz.annotate import annotate_video, annotate_video_detections

    detector_state_dict = None
    if args.checkpoint:
        from cvsd_tpu_torch.eval.evaluate import load_model
        from cvsd_tpu_torch.pipeline.streaming import StreamingPipeline

        scorer = load_model(args.checkpoint, device=args.device)
        cfg = apply_overrides(scorer.config, args.overrides)
        if args.detector_checkpoint:
            detector_state_dict, cfg = load_detector_cli(args.detector_checkpoint, cfg,
                                                         args.overrides)
        scorer.config = cfg
        pipe = StreamingPipeline(cfg, scorer, detector_state_dict=detector_state_dict,
                                 device=args.device)
        run = lambda v, out: annotate_video(pipe, v, out,  # noqa: E731
                                            threshold=args.threshold, fourcc=args.fourcc)
    else:  # detector only
        from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline
        from cvsd_tpu_torch.utils.device import resolve_device

        device = resolve_device(args.device)  # before the checkpoint is read
        detector_state_dict, cfg = load_detector_cli(args.detector_checkpoint,
                                                     resolve_config(args), args.overrides)
        detection = DetectionPipeline(cfg, state_dict=detector_state_dict, device=device)
        run = lambda v, out: annotate_video_detections(  # noqa: E731
            detection, v, out, fourcc=args.fourcc)

    os.makedirs(args.out_dir, exist_ok=True)
    summary = {}
    for v in args.videos:
        base = os.path.splitext(os.path.basename(v))[0]
        out_path = os.path.join(args.out_dir, f"{base}_annotated.mp4")
        res = run(v, out_path)
        if "events" in res:
            print(f"{v}: {res['frames']} frames, {len(res['events'])} scored "
                  f"windows, max anomaly {res['max_score']:.3f} -> {out_path}")
            summary[v] = {k: res[k] for k in ("frames", "out_path", "max_score")}
            summary[v]["num_events"] = len(res["events"])
        else:
            print(f"{v}: {res['frames']} frames, {res['detections']} tracked "
                  f"detections -> {out_path}")
            summary[v] = res
    if args.output:
        with open(args.output, "w") as f:
            json.dump(summary, f, indent=2)


if __name__ == "__main__":
    main()
