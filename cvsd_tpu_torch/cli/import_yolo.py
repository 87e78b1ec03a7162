"""Import an ultralytics yolov5*u checkpoint into a detector checkpoint (the
port's ``cvsd_tpu/cli/import_yolo.py``).

Maps the torch checkpoint the reference detects with (``yolov5mu.pt``) onto
``PersonDetector(head_variant='v8dfl')`` and writes a msgpack checkpoint with
the architecture embedded, which every detector consumer of either package
loads (``--detector_checkpoint`` of cli.stream, cli.preprocess, cli.serve,
``load_detector_checkpoint``, ``DetectionPipeline``, ``DetectorTrainer``).
Without ``--pose_head`` every leaf comes from the torch file, and the output
is byte-identical to the JAX CLI's for the same file and flags; with it the
keypoint branch (which ultralytics detection models lack) comes from the
port's seeded initialisation. The conversion is numpy on the host: it runs
no model and needs no card.

    python -m cvsd_tpu_torch.cli.import_yolo --torch_checkpoint yolov5mu.pt \
        --output checkpoints/yolov5mu.msgpack
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--torch_checkpoint", required=True, help=".pt file (ultralytics u-series)")
    p.add_argument("--output", required=True, help="output .msgpack path")
    p.add_argument("--img_size", type=int, default=640)
    p.add_argument("--width_mult", type=float, default=0.75, help="0.75 = v5m")
    p.add_argument("--depth_mult", type=float, default=0.67, help="0.67 = v5m")
    p.add_argument("--pose_head", action="store_true",
                   help="add an (untrained) keypoint branch for fine-tuning")
    p.add_argument("--non_strict", action="store_true",
                   help="tolerate missing checkpoint keys")
    p.add_argument("--unsafe", action="store_true",
                   help="allow full torch unpickling (executes code from the "
                        "file) when weights_only=True loading fails; only for "
                        "trusted checkpoints")
    args = p.parse_args(argv)

    import torch

    from cvsd_tpu_torch.models.detector import PersonDetector
    from cvsd_tpu_torch.utils.checkpoint import save_checkpoint
    from cvsd_tpu_torch.utils.yolo_import import import_yolov5u, load_torch_checkpoint

    with torch.device("meta"):  # the architecture only; the weights are numpy
        model = PersonDetector(
            img_size=args.img_size, width_mult=args.width_mult, depth_mult=args.depth_mult,
            num_keypoints=17 if args.pose_head else 0, head_variant="v8dfl",
            dtype=torch.bfloat16,
        )
    sd = load_torch_checkpoint(args.torch_checkpoint, allow_unsafe_load=args.unsafe)
    variables = import_yolov5u(sd, model=model, strict=not args.non_strict)
    det_cfg = {
        "img_size": model.img_size, "width_mult": model.width_mult,
        "depth_mult": model.depth_mult, "pose_head": bool(model.num_keypoints),
        "num_keypoints": model.num_keypoints, "head_variant": "v8dfl",
        "num_classes": model.num_classes, "reg_max": model.reg_max,
        "dtype": "bfloat16",
    }
    save_checkpoint(args.output, variables, config={"detector": det_cfg},
                    source=args.torch_checkpoint)
    n = sum(int(leaf.size) for leaf in _leaves(variables["params"]))
    print(f"imported {args.torch_checkpoint} -> {args.output} ({n:,} params)")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
