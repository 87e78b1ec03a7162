"""Score pose sequences with a trained checkpoint.

    python -m cvsd_tpu_torch.cli.inference --checkpoint ckpt/stage2_best.msgpack \
        --threshold 0.14 --output predictions.json [--device cpu]

``--device`` unset means the CUDA card, an error without one.
"""

from __future__ import annotations

import argparse

from cvsd_tpu_torch.cli.common import add_config_args, resolve_config
from cvsd_tpu_torch.utils.device import resolve_device, use_float32_math


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_config_args(p)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--threshold", type=float, default=None,
                   help="fixed score threshold (default: optimal on labels)")
    p.add_argument("--output", type=str, default=None, help="JSON output path")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # a missing card is reported before any file
    use_float32_math()

    config = None
    if args.config or args.overrides or args.use_synthetic:
        config = resolve_config(args)

    from cvsd_tpu_torch.infer.inference import run_inference

    result = run_inference(args.checkpoint, config=config, threshold=args.threshold,
                           output_path=args.output, device=device)
    m = result["metrics"]
    print(f"sequences={result['num_sequences']} threshold={result['threshold']:.4f} "
          f"auc_roc={m['auc_roc']:.4f} f1={m['f1']:.4f}")


if __name__ == "__main__":
    main()
