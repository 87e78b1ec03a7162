"""Shared CLI plumbing: config loading, dotted overrides, the device, and
detector checkpoints (the port's copy of ``cvsd_tpu/cli/common.py``).

``--device`` takes the place of the JAX CLIs' ``JAX_PLATFORMS``: unset, the
entry points run on the CUDA card and raise without one; ``--device cpu``
runs them on the host. The persistent compile cache (ROADMAP.md, module
queue: The rest) and the mesh (module queue: Parallel) are not ported.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Tuple

import torch

from cvsd_tpu_torch.config import apply_overrides, get_default_config, load_config, validate_config


def add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", type=str, default=None,
                   help="YAML config path (in place of the checkpoint's embedded config)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="a.b.c=value", help="dotted-path config override (repeatable)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card, an error without one; "
                        "'cpu' runs on the host)")
    p.add_argument("--use_synthetic", action="store_true",
                   help="use the synthetic pose dataset (data.dataset=synthetic)")


def resolve_config(args: argparse.Namespace) -> Dict[str, Any]:
    """``--config`` (or the defaults) with the ``--set`` overrides and
    ``--use_synthetic``, validated."""
    cfg = load_config(args.config) if args.config else get_default_config()
    cfg = apply_overrides(cfg, args.overrides)
    if getattr(args, "use_synthetic", False):
        cfg["data"]["dataset"] = "synthetic"
    validate_config(cfg)
    return cfg


# architecture fields a detector checkpoint must dictate for the weights to
# apply and decode correctly; runtime fields (thresholds, batch_size,
# stream_depth, ...) stay with the session config. "quantized" is among them
# here and not in the JAX package's tuple, which lacks it: an int8 checkpoint
# then builds a float detector there unless --set detector.quantized=true is
# given (ROADMAP.md section 3)
_DETECTOR_ARCH_KEYS = (
    "head_variant", "num_classes", "reg_max", "width_mult", "depth_mult",
    "img_size", "num_keypoints", "pose_head", "channel_divisor", "dtype", "quantized",
)


def load_detector_cli(path: str, cfg: Dict[str, Any], overrides=None
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Load a detector checkpoint for a CLI consumer: returns (state_dict,
    cfg) with the checkpoint's embedded architecture config merged into
    cfg['detector'], so a checkpoint of another head_variant/width/reg_max
    than the session default rebuilds correctly. CLI dotted ``detector.*``
    overrides are re-applied afterwards, so explicit --set flags still win.
    The flax variables become the state_dict of that detector (built on the
    meta device: shapes only)."""
    from cvsd_tpu_torch.models.detector import detector_from_config
    from cvsd_tpu_torch.utils.checkpoint import load_checkpoint
    from cvsd_tpu_torch.utils.weights import flax_to_state_dict

    variables, meta = load_checkpoint(path)
    embedded = ((meta or {}).get("config") or {}).get("detector") or {}
    if embedded:
        det = dict(cfg.get("detector", {}) or {})
        for k in _DETECTOR_ARCH_KEYS:
            if k in embedded:
                det[k] = embedded[k]
        cfg = dict(cfg)
        cfg["detector"] = det
        if overrides:
            cfg = apply_overrides(cfg, [o for o in overrides if o.startswith("detector.")])
    with torch.device("meta"):
        template = detector_from_config(cfg)
    return flax_to_state_dict(variables, template), cfg
