"""Hyperparameter sweep over Shopformer configs (the port's copy of
``cvsd_tpu/cli/sweep.py``: grid / random / recommended / quick modes and the
analysis report).

    python -m cvsd_tpu_torch.cli.sweep --mode quick --output_dir sweeps/quick
    python -m cvsd_tpu_torch.cli.sweep --mode random --num_configs 20
    python -m cvsd_tpu_torch.cli.sweep --mode quick --max_configs 2 --device cpu

``--device`` unset means the CUDA card, an error without one.
"""

from __future__ import annotations

import argparse
import json

from cvsd_tpu_torch.cli.common import add_config_args, resolve_config
from cvsd_tpu_torch.utils.device import resolve_device


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_config_args(p)
    p.add_argument("--mode", choices=("grid", "random", "recommended", "quick"),
                   default="recommended")
    p.add_argument("--num_configs", type=int, default=20, help="random mode size")
    p.add_argument("--max_configs", type=int, default=None)
    p.add_argument("--output_dir", type=str, default="sweeps/run")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # a missing card is reported before any config

    base = None
    if args.config or args.overrides or args.use_synthetic:
        base = resolve_config(args)

    from cvsd_tpu_torch.sweep.sweep import analyze_results, generate_configs, run_sweep

    configs = generate_configs(args.mode, base_config=base,
                               num_random=args.num_configs, seed=args.seed)
    results = run_sweep(configs, args.output_dir, verbose=True, max_configs=args.max_configs,
                        device=device)
    print(json.dumps(analyze_results(results), indent=2, default=float))


if __name__ == "__main__":
    main()
