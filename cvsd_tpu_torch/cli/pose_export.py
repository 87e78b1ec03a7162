"""Extract PoseLift-format pose datasets from videos with the detector's
pose head (the port's ``cvsd_tpu/cli/pose_export.py``).

    python -m cvsd_tpu_torch.cli.pose_export --videos dataset/Shoplifting/*.mp4 \
        --output data/PoseLift --split Train [--device cpu]
    python -m cvsd_tpu_torch.cli.pose_export --videos test/*.mp4 --split Test \
        --annotations dataset/Temporal_Anomaly_Annotation_for_Testing_Videos.txt
"""

from __future__ import annotations

import argparse
import json

from cvsd_tpu_torch.cli.common import add_config_args, resolve_config


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_config_args(p)
    p.add_argument("--videos", nargs="+", required=True)
    p.add_argument("--output", type=str, required=True, help="PoseLift root dir")
    p.add_argument("--split", choices=("Train", "Test"), default="Train")
    p.add_argument("--annotations", type=str, default=None,
                   help="UCF-Crime temporal annotation txt (Test split labels)")
    p.add_argument("--detector_checkpoint", type=str, default=None)
    args = p.parse_args(argv)

    from cvsd_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # a missing card is reported before any file is read
    cfg = resolve_config(args)
    cfg["detector"]["pose_head"] = True
    state_dict = None
    if args.detector_checkpoint:
        from cvsd_tpu_torch.cli.common import load_detector_cli

        state_dict, cfg = load_detector_cli(args.detector_checkpoint, cfg, args.overrides)
        cfg["detector"]["pose_head"] = True

    annotations = None
    if args.annotations:
        from cvsd_tpu_torch.data.ucf_crime import read_temporal_annotations

        annotations = {a.name.rsplit(".", 1)[0]: a
                       for a in read_temporal_annotations(args.annotations)}

    from cvsd_tpu_torch.pipeline.pose_export import export_poselift_dataset
    from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline

    pipeline = DetectionPipeline(cfg, state_dict=state_dict, device=device)
    stats = export_poselift_dataset(pipeline, args.videos, args.output,
                                    split=args.split, annotations=annotations)
    print(json.dumps(stats, default=str))


if __name__ == "__main__":
    main()
