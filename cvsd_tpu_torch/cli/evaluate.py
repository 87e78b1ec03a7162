"""Evaluate a trained Shopformer checkpoint (frame- and video-level).

    python -m cvsd_tpu_torch.cli.evaluate --checkpoint ckpt/stage2_best.msgpack \
        --output_dir evaluation [--device cpu]

Writes ``<output_dir>/metrics.json`` (and the plots where matplotlib is
installed) and prints the frame-level metrics. ``--device`` unset means the
CUDA card, an error without one.
"""

from __future__ import annotations

import argparse
import json

from cvsd_tpu_torch.cli.common import add_config_args, resolve_config
from cvsd_tpu_torch.utils.device import resolve_device, use_float32_math


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_config_args(p)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="evaluation")
    p.add_argument("--save_scores", action="store_true")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # a missing card is reported before any file
    use_float32_math()

    config = None
    if args.config or args.overrides or args.use_synthetic:
        config = resolve_config(args)

    from cvsd_tpu_torch.eval.evaluate import evaluate_checkpoint

    result = evaluate_checkpoint(args.checkpoint, config=config, output_dir=args.output_dir,
                                 save_scores=args.save_scores, device=device)
    print(json.dumps(result["test_metrics"], indent=2))
    if result.get("auc_delta_vs_recorded") is not None:
        print(f"AUC delta vs checkpoint-recorded: {result['auc_delta_vs_recorded']:+.4f}")


if __name__ == "__main__":
    main()
