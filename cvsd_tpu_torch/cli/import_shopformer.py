"""Import a reference-trained Shopformer torch checkpoint (the port's
``cvsd_tpu/cli/import_shopformer.py``).

Converts the reference's ``best_model.pt`` / ``final_model.pt`` (v1) or
``stage2_best.pt`` (v2) into a msgpack checkpoint that cli.evaluate,
cli.inference, cli.stream, cli.serve and cli.annotate of either package
load; the file is byte-identical to the JAX CLI's for the same torch file
and flags. One eval-mode scoring pass runs on the device before the file is
written.

    python -m cvsd_tpu_torch.cli.import_shopformer --torch_checkpoint best_model.pt \
        --variant v1 --kpts 17 --output shopformer.msgpack [--device cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--torch_checkpoint", required=True)
    p.add_argument("--output", required=True, help="output .msgpack path")
    p.add_argument("--variant", choices=["v1", "v2"], default=None,
                   help="reference generation (default: from embedded config, else v2)")
    p.add_argument("--kpts", type=int, default=None,
                   help="keypoints (v1 default 17, v2 default 18)")
    p.add_argument("--seq_len", type=int, default=12)
    p.add_argument("--num_tokens", type=int, default=2)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--latent", type=int, default=8)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--ff", type=int, default=64)
    p.add_argument("--d_model", type=int, default=None,
                   help="transformer width when != latent*kpts (adds projections)")
    p.add_argument("--unsafe", action="store_true",
                   help="allow full torch unpickling (executes code from the "
                        "file) when weights_only=True loading fails; only for "
                        "trusted checkpoints")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the scoring pass (default: the CUDA card, an "
                        "error without one; 'cpu' runs on the host)")
    args = p.parse_args(argv)

    import torch

    from cvsd_tpu_torch.utils.checkpoint import save_checkpoint
    from cvsd_tpu_torch.utils.shopformer_import import (import_shopformer_checkpoint,
                                                        reference_model_config)

    model_cfg = None
    if args.variant is not None:
        kpts = args.kpts if args.kpts is not None else (17 if args.variant == "v1" else 18)
        model_cfg = reference_model_config(
            args.variant, num_keypoints=kpts, seq_len=args.seq_len,
            num_tokens=args.num_tokens, hidden_channels=args.hidden,
            latent_channels=args.latent, num_heads=args.heads,
            dim_feedforward=args.ff, d_model=args.d_model)
    model, variables, config = import_shopformer_checkpoint(
        args.torch_checkpoint, model_cfg=model_cfg, variant=args.variant,
        allow_unsafe_load=args.unsafe, device=args.device)

    # smoke: one eval-mode scoring pass before persisting
    dev = next(model.parameters()).device
    poses = torch.zeros((2, model.seq_len, model.num_keypoints, model.in_channels),
                        dtype=torch.float32, device=dev)
    if not bool(torch.isfinite(model.compute_anomaly_score(poses)).all()):
        raise SystemExit("the imported model scores non-finite values")

    save_checkpoint(args.output, variables, config=config, source=args.torch_checkpoint)
    n = sum(int(p_.numel()) for p_ in model.parameters())
    print(f"imported {args.torch_checkpoint} ({config['model']['variant']}) "
          f"-> {args.output} ({n:,} params)")


if __name__ == "__main__":
    main()
