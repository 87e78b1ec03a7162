"""Train the Shopformer (two stages).

    python -m cvsd_tpu_torch.cli.train --config configs/paper.yaml
    python -m cvsd_tpu_torch.cli.train --use_synthetic --set training.stage1_epochs=2 --device cpu
    python -m cvsd_tpu_torch.cli.train --config c.yaml --stage 2 --checkpoint ckpt/stage1_best.msgpack

Checkpoints (``stage{1,2}_{best,final,epochN}.msgpack``) are the JAX
package's format: either package loads them. ``--profile DIR`` writes a
``torch.profiler`` chrome trace of the run to ``DIR/trace.json``.
``--device`` unset means the CUDA card, an error without one. Launched as
several ranks (``torchrun``), training is data-parallel over the ranks' mesh
(``cli/common.py::maybe_mesh``); rank 0 alone writes.
"""

from __future__ import annotations

import argparse

from cvsd_tpu_torch.cli.common import add_config_args, maybe_mesh, resolve_config
from cvsd_tpu_torch.utils.device import resolve_device, use_float32_math


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_config_args(p)
    p.add_argument("--stage", type=int, default=1, choices=(1, 2),
                   help="start stage (2 auto-loads stage1_best)")
    p.add_argument("--checkpoint", type=str, default=None, help="resume checkpoint")
    p.add_argument("--output_dir", type=str, default=None, help="checkpoint dir override")
    p.add_argument("--profile", type=str, default=None,
                   help="directory for a torch.profiler trace of the run")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # a missing card is reported before any file
    use_float32_math()

    cfg = resolve_config(args)
    if args.checkpoint and not args.config:
        # adopt the resume checkpoint's embedded MODEL architecture so the
        # rebuilt model matches the weights; explicit --set model.* flags win
        from cvsd_tpu_torch.config import apply_overrides
        from cvsd_tpu_torch.utils.checkpoint import load_checkpoint

        _state, meta = load_checkpoint(args.checkpoint)
        emb = ((meta or {}).get("config") or {}).get("model")
        if emb:
            cfg = dict(cfg)
            cfg["model"] = {**cfg.get("model", {}), **emb}
            cfg = apply_overrides(cfg, [o for o in args.overrides if o.startswith("model.")])
    if args.output_dir:
        cfg["experiment"]["checkpoint_dir"] = args.output_dir

    from cvsd_tpu_torch.train.loop import train_from_config
    from cvsd_tpu_torch.utils.logging import device_trace

    with device_trace(args.profile):
        train_from_config(cfg, mesh_config=maybe_mesh(cfg, device), start_stage=args.stage,
                          resume_checkpoint=args.checkpoint, device=device)


if __name__ == "__main__":
    main()
