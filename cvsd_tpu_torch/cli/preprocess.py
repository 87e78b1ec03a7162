"""UCF-Crime preprocessing: videos -> batched person detection -> BBox CSVs.

    python -m cvsd_tpu_torch.cli.preprocess --dataset_dir dataset \
        --categories Shoplifting Shopping --limit 5 [--device cpu]

The port runs on one device (no mesh). ``--device`` unset means the CUDA
card, an error without one.
"""

from __future__ import annotations

import argparse
import json

from cvsd_tpu_torch.cli.common import add_config_args, resolve_config
from cvsd_tpu_torch.utils.device import use_float32_math


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_config_args(p)
    p.add_argument("--dataset_dir", type=str, default="dataset")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--categories", nargs="*", default=["Shoplifting", "Shopping"])
    p.add_argument("--limit", type=int, default=None, help="max videos to process")
    p.add_argument("--detector_checkpoint", type=str, default=None,
                   help="msgpack with detector variables")
    args = p.parse_args(argv)
    use_float32_math()
    cfg = resolve_config(args)

    state_dict = None
    if args.detector_checkpoint:
        from cvsd_tpu_torch.cli.common import load_detector_cli

        state_dict, cfg = load_detector_cli(args.detector_checkpoint, cfg, args.overrides)

    from cvsd_tpu_torch.pipeline.preprocess import preprocess_ucf_crime

    stats = preprocess_ucf_crime(cfg, args.dataset_dir, output_dir=args.output_dir,
                                 category_filter=args.categories, limit=args.limit,
                                 state_dict=state_dict, device=args.device)
    print(json.dumps(stats, indent=2, default=str))


if __name__ == "__main__":
    main()
