"""Streaming end-to-end inference over videos: decode -> detect(+pose) ->
track -> Shopformer anomaly scores.

    python -m cvsd_tpu_torch.cli.stream --checkpoint ckpt/stage2_best.msgpack \
        --videos a.mp4 b.mp4 --concurrent --output events.json [--device cpu]

Launched as several ranks (``torchrun --nproc_per_node N -m
cvsd_tpu_torch.cli.stream ...``), the frame batches shard over the ranks'
data mesh (``cli/common.py::maybe_mesh``) unless ``--no_mesh`` is given;
rank 0 alone writes ``--output`` and ``--events_jsonl``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from cvsd_tpu_torch.cli.common import add_config_args, maybe_mesh, resolve_config
from cvsd_tpu_torch.utils.device import use_float32_math


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_config_args(p)
    p.add_argument("--checkpoint", type=str, required=True, help="Shopformer checkpoint")
    p.add_argument("--detector_checkpoint", type=str, default=None)
    p.add_argument("--videos", nargs="+", required=True)
    p.add_argument("--concurrent", action="store_true",
                   help="multiplex videos into shared detector batches")
    p.add_argument("--max_streams", type=int, default=8)
    p.add_argument("--threshold", type=float, default=None, help="flag events >= threshold")
    p.add_argument("--annotations", type=str, default=None,
                   help="temporal GT file (Temporal_Anomaly_Annotation_for_"
                        "Testing_Videos.txt format): joins live scores against "
                        "labels and prints video/event AUC with bootstrap CI")
    p.add_argument("--aggregation", type=str, default="max",
                   choices=["max", "mean", "percentile_95"])
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--events_jsonl", type=str, default=None,
                   help="write each scored window as a JSON line AS IT IS "
                        "SCORED (live sink; requires --concurrent)")
    p.add_argument("--no_mesh", action="store_true",
                   help="single-device even when launched as several ranks "
                        "(default: shard frame batches over the data mesh axis)")
    args = p.parse_args(argv)
    use_float32_math()
    if args.events_jsonl and not args.concurrent:
        p.error("--events_jsonl requires --concurrent")

    from cvsd_tpu_torch.config import apply_overrides
    from cvsd_tpu_torch.eval.evaluate import load_model
    from cvsd_tpu_torch.parallel.mesh import writes
    from cvsd_tpu_torch.pipeline.streaming import StreamingPipeline

    # --config takes the place of the checkpoint's embedded config, as
    # load_model's explicit config does; --set applies over either
    scorer = load_model(args.checkpoint, config=resolve_config(args) if args.config else None,
                        device=args.device)
    # the session config + CLI dotted overrides (--set a.b=c), so
    # detector options (pose_mode, stream_depth, tta_flip, ...) are reachable
    cfg = apply_overrides(scorer.config, args.overrides)
    detector_state_dict = None
    if args.detector_checkpoint:
        from cvsd_tpu_torch.cli.common import load_detector_cli

        detector_state_dict, cfg = load_detector_cli(args.detector_checkpoint, cfg,
                                                     args.overrides)
    scorer.config = cfg
    # multi-rank streaming: shard multiplexed frame batches over the mesh's
    # data axis when launched as several ranks (disable with --no_mesh)
    mesh_config = None if args.no_mesh else maybe_mesh(cfg, args.device)
    writer = writes(mesh_config)
    pipe = StreamingPipeline(cfg, scorer, detector_state_dict=detector_state_dict,
                             device=args.device, mesh_config=mesh_config)
    if args.concurrent:
        sink = open(args.events_jsonl, "w") if args.events_jsonl and writer else None
        try:
            on_event = None
            if sink is not None:
                def on_event(e):
                    sink.write(json.dumps(dataclasses.asdict(e)) + "\n")
                    sink.flush()
            out = pipe.stream_videos_concurrent(args.videos,
                                                max_streams=args.max_streams,
                                                on_event=on_event)
        finally:
            if sink is not None:
                sink.close()
    else:
        out = pipe.stream_videos(args.videos)

    events = [dataclasses.asdict(e) for e in out["events"]]
    if args.threshold is not None:
        for e in events:
            e["anomalous"] = e["score"] >= args.threshold
    result = {k: v for k, v in out.items() if k != "events"}
    result["events"] = events
    print(f"{out['videos']} videos, {out['frames']} frames, "
          f"{out['fps']:.1f} fps, {out['videos_per_hour']:.1f} videos/hour, "
          f"{len(events)} scored windows")
    if args.annotations:
        from cvsd_tpu_torch.data.ucf_crime import read_temporal_annotations
        from cvsd_tpu_torch.eval.streaming_eval import evaluate_streaming

        res = evaluate_streaming(out["events"], read_temporal_annotations(args.annotations),
                                 aggregation=args.aggregation,
                                 include_eventless_videos=args.videos)
        print(f"video AUC ({args.aggregation}): {res.video_auc:.4f} "
              f"[95% CI {res.video_auc_ci[0]:.4f}, {res.video_auc_ci[1]:.4f}] "
              f"over {res.n_videos} videos; event AUC: {res.event_auc:.4f} "
              f"({res.n_events} windows)")
        if res.unmatched_videos:
            print(f"  unmatched (no GT): {res.unmatched_videos}")
        result["streaming_eval"] = res.as_dict()
    if args.output and writer:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2, default=float)


if __name__ == "__main__":
    main()
