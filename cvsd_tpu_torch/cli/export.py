"""Export serving artifacts (torch.export ``.pt2``) — the port's
``cvsd_tpu/cli/export.py``.

Writes one ``ExportedProgram`` (weights baked in, batch 1 to 4096) that
``serve/export.py::load_exported`` runs without the model classes or the
config. The JAX CLI writes StableHLO for PJRT runtimes; this one writes a
``.pt2`` for PyTorch, whose detect program keeps the hand-written NMS kernel
(``csrc/nms_fixpoint.cu``) as an operator. The detector is the one the
serving CLIs build from the file (``load_detector_cli`` ->
``build_detector``: the module cast to its configured dtype once, bf16 by
default). An artifact runs on the device type it was exported on:
``--platforms cuda`` (the default, the card) or ``cpu``. The JAX CLI's
``--config`` / ``--set`` / ``--use_synthetic`` are unused there and are
left out here.

    # detector (backbone -> decode -> NMS), batch 1 to 4096
    python -m cvsd_tpu_torch.cli.export --detector_checkpoint det.msgpack --output det.pt2

    # Shopformer anomaly scorer
    python -m cvsd_tpu_torch.cli.export --checkpoint stage2_best.msgpack --output scorer.pt2
"""

from __future__ import annotations

import argparse
import os

from cvsd_tpu_torch.utils.device import resolve_device

PLATFORMS = ("cuda", "cpu")


def _device(p: argparse.ArgumentParser, platforms) -> str:
    platforms = list(platforms or ["cuda"])
    if "tpu" in platforms:
        p.error("--platforms tpu: the port exports a torch.export program for PyTorch on "
                "the device it runs on (cuda or cpu); a TPU artifact is StableHLO from "
                "the JAX package's cvsd_tpu.cli.export")
    bad = [x for x in platforms if x not in PLATFORMS]
    if bad or len(platforms) != 1:
        p.error(f"--platforms takes one of {PLATFORMS}: an artifact holds its weights on "
                f"one device type (got {platforms})")
    return platforms[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--detector_checkpoint", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None, help="Shopformer checkpoint")
    p.add_argument("--output", type=str, required=True, help="output .pt2 path")
    p.add_argument("--platforms", nargs="*", default=None,
                   help="the device type the artifact runs on: cuda (default) or cpu "
                        "(tpu is refused: that is the JAX package's StableHLO)")
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--max_detections", type=int, default=128)
    p.add_argument("--tta_flip", action="store_true")
    args = p.parse_args(argv)
    if not args.detector_checkpoint and not args.checkpoint:
        p.error("one of --detector_checkpoint / --checkpoint is required")
    device = resolve_device(_device(p, args.platforms))  # before any file is read

    from cvsd_tpu_torch.serve.export import save_exported

    if args.detector_checkpoint:
        from cvsd_tpu_torch.cli.common import load_detector_cli
        from cvsd_tpu_torch.config import get_default_config
        from cvsd_tpu_torch.models.detector import build_detector
        from cvsd_tpu_torch.serve.export import export_detector

        # the serving path's detector (as cli.stream / cli.serve build it):
        # the architecture from the file, the module cast to its dtype once
        state_dict, cfg = load_detector_cli(args.detector_checkpoint, get_default_config())
        model = build_detector(cfg, device=device, state_dict=state_dict)
        exp = export_detector(model, conf_thresh=args.conf, iou_thresh=args.iou,
                              max_detections=args.max_detections, tta_flip=args.tta_flip)
        save_exported(exp, args.output)
        print(f"detector -> {args.output} ({os.path.getsize(args.output) // 1024} KiB, "
              f"device {device}, images (b,{model.img_size},{model.img_size},3) f32)")
    else:
        from cvsd_tpu_torch.eval.evaluate import load_model
        from cvsd_tpu_torch.serve.export import export_scorer

        scorer = load_model(args.checkpoint, device=device)
        exp = export_scorer(scorer)
        save_exported(exp, args.output)
        m = scorer.config["model"]
        print(f"scorer -> {args.output} ({os.path.getsize(args.output) // 1024} KiB, "
              f"device {device}, poses (b,{m.get('seq_len', 12)},"
              f"{m.get('num_keypoints', 18)},{m.get('in_channels', 2)}) f32)")


if __name__ == "__main__":
    main()
