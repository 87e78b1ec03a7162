"""Unified configuration tree: YAML load/merge + CLI overrides.

The port's own copy of ``cvsd_tpu/config/config.py`` (same defaults, same
keys, so one YAML file configures both packages); ``yaml`` is imported
lazily.

Design: a single nested dict (the "config tree") is the source of truth,
threaded through model/data/trainer factories and embedded in every
checkpoint. ``Config`` is a light attribute-access view over that dict.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List, Optional


class Config(dict):
    """Nested dict with attribute access. ``cfg.model.d_model`` == ``cfg['model']['d_model']``."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def to_dict(self) -> Dict[str, Any]:
        def conv(x):
            if isinstance(x, dict):
                return {k: conv(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [conv(v) for v in x]
            return x

        return conv(self)


def get_default_config() -> Config:
    """Paper-aligned defaults (reference: shopformer_2/utils/config.py:96-162 and
    shopformer_2/configs/paper_config.yaml — V=18, T=12, 2 tokens, d_model 144)."""
    return Config(
        {
            "experiment": {
                "name": "shopformer",
                "seed": 42,
                "checkpoint_dir": "checkpoints",
                "log_every_n_batches": 10,
            },
            "data": {
                "data_dir": "data/poselift",
                "dataset": "poselift",  # poselift | synthetic
                "seq_len": 12,
                "stride": 6,
                "max_gap": 5,
                "num_keypoints": 17,
                "add_neck": True,  # 17 -> 18 keypoints (v2 semantics)
                "batch_size": 32,
                "synthetic": {
                    "num_train": 256,
                    "num_test": 128,
                    "train_anomaly_ratio": 0.0,
                    "test_anomaly_ratio": 0.3,
                },
                "augment": {
                    "enabled": True,
                    "flip_prob": 0.5,
                    "jitter_std": 0.01,
                    "scale_range": [0.9, 1.1],
                    "rotation_range": [-10.0, 10.0],
                    "shear_range": [0.0, 0.0],
                    "translate_range": [0.0, 0.0],
                    "temporal_dropout_prob": 0.1,
                    "keypoint_dropout_prob": 0.05,
                    # v1 batch-level extras (reference shopformer/train.py:68-186)
                    "time_warp_prob": 0.0,
                    "mixup_alpha": 0.0,
                },
            },
            "model": {
                "in_channels": 2,
                "hidden_channels": 64,
                "latent_channels": 8,
                "num_keypoints": 18,  # 17 + synthetic neck
                "seq_len": 12,
                "num_tokens": 2,
                "gcae_layers": 4,
                "layout": "coco_with_neck",  # coco | openpose | coco_with_neck
                "num_heads": 2,
                "num_encoder_layers": 2,
                "num_decoder_layers": 2,
                "dim_feedforward": 64,
                "dropout": 0.1,
                "variant": "v2",  # v1: post-LN/ReLU, shifted-target decode, PE-in-score-target
                #                   v2: pre-LN/GELU, identity-target decode, plain MSE score
                "dtype": "float32",  # compute dtype for the shopformer (tiny model; fp32)
            },
            "training": {
                "stage1_epochs": 10,
                "stage2_epochs": 20,
                "optimizer": "adam",  # adam | adamw
                "lr": 5.0e-5,
                "weight_decay": 0.0,
                "grad_clip": 1.0,
                "grad_accum_steps": 1,
                "scheduler": "constant",  # constant|cosine_warmup|step|exponential|reduce_on_plateau
                "scheduler_params": {
                    "warmup_epochs": 1,
                    "step_size": 10,
                    "gamma": 0.95,
                    "plateau_patience": 5,
                    "plateau_factor": 0.5,
                },
                "early_stopping": {"enabled": True, "patience": 20, "min_delta": 0.0, "mode": "max"},
                "checkpoint_every_n_epochs": 10,
                "eval_every_n_epochs": 1,
            },
            "eval": {
                "threshold": None,  # None -> optimal (youden)
                "threshold_method": "youden",  # youden | f1
                "video_aggregations": ["max", "mean", "percentile_95"],
                "save_plots": True,
                "save_scores": False,
            },
            "detector": {
                "img_size": 640,
                "batch_size": 32,
                "dtype": "bfloat16",
                "width_mult": 0.75,
                "depth_mult": 0.67,
                "conf_threshold": 0.25,
                "iou_threshold": 0.45,
                "max_detections": 128,
                "nms_method": "pallas_fixpoint",  # | pallas_seq (the ported CUDA kernels)
                "person_class_only": True,
                "pose_head": False,
                "tta_flip": False,  # horizontal-flip TTA (2x fwd, ~sqrt(2) less kpt noise)
                "pose_mode": "head",  # head | topdown (crop-based pose net)
                "stream_depth": 3,  # in-flight detection batches in streaming
                # streaming: detect every Nth source frame (skipped frames are
                # cheaply cap.grab()'d, never resized/uploaded); the tracker
                # bridges the gaps and pose windows sample at this stride.
                # Beats the 1-core host decode floor (PROFILE.md) at a small,
                # measured AUC cost (RESULTS.md frame-stride table).
                "frame_stride": 1,
                "pose_topdown": {"num_keypoints": 17, "width": 32, "crop_size": 64},
                "pose_topdown_checkpoint": None,
            },
            "parallel": {
                "mesh_shape": None,  # None -> (num_devices,) 1-D data mesh
                "mesh_axes": ["data"],
                "batch_axis": "data",
                "model_axis": None,  # set to an axis name to enable TP over d_ff/heads
            },
        }
    )


def load_config(path: str) -> Config:
    """Load a YAML config merged over defaults. Relative data_dir is resolved
    against the config file's directory (reference: shopformer_2/utils/config.py:12-56).
    ``yaml`` is imported here, not at module import: the port runs where it is absent."""
    import yaml

    with open(path, "r") as f:
        user = yaml.safe_load(f) or {}
    cfg = merge_configs(get_default_config(), user)
    data_dir = cfg["data"].get("data_dir")
    if data_dir and not os.path.isabs(data_dir):
        resolved = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(path)), data_dir))
        if os.path.exists(resolved):
            cfg["data"]["data_dir"] = resolved
    return cfg


def save_config(cfg: Dict[str, Any], path: str) -> None:
    """Persist the effective config next to checkpoints: JSON for a ``.json``
    path, else YAML (``yaml`` imported only then)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cfg = Config(cfg).to_dict()
    with open(path, "w") as f:
        if path.endswith(".json"):
            json.dump(cfg, f, indent=2)
        else:
            import yaml

            yaml.safe_dump(cfg, f, sort_keys=False)


def merge_configs(base: Dict[str, Any], override: Dict[str, Any]) -> Config:
    """Recursive merge; override wins (reference: shopformer_2/utils/config.py:74-93)."""
    out = copy.deepcopy(dict(base))
    for k, v in (override or {}).items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_configs(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return Config(out)


def _parse_value(s: str) -> Any:
    try:
        return json.loads(s)
    except (ValueError, TypeError):
        return s


def apply_overrides(cfg: Dict[str, Any], overrides: Optional[List[str]]) -> Config:
    """Apply ``section.key=value`` dotted-path CLI overrides (values parsed as JSON,
    falling back to string). Unifies v1's 36 argparse flags with the YAML tree."""
    cfg = merge_configs(cfg, {})
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"override must look like a.b.c=value, got {item!r}")
        path, value = item.split("=", 1)
        node = cfg
        keys = path.split(".")
        for k in keys[:-1]:
            if k not in node or not isinstance(node[k], dict):
                node[k] = {}
            node = node[k]
        node[keys[-1]] = _parse_value(value)
    return cfg


REQUIRED_SECTIONS = ("data", "model", "training")


def validate_config(cfg: Dict[str, Any]) -> None:
    """Structural validation (reference: shopformer_2/utils/config.py:165-202)."""
    for section in REQUIRED_SECTIONS:
        if section not in cfg:
            raise ValueError(f"config missing required section {section!r}")
    m = cfg["model"]
    d_model = int(m["latent_channels"]) * int(m["num_keypoints"])
    if d_model % int(m["num_heads"]) != 0:
        raise ValueError(
            f"d_model (latent_channels*num_keypoints = {d_model}) must be divisible by "
            f"num_heads ({m['num_heads']})"
        )
    if int(cfg["data"]["seq_len"]) < int(m["num_tokens"]):
        raise ValueError("seq_len must be >= num_tokens")
    if m.get("variant", "v2") not in ("v1", "v2"):
        raise ValueError(f"model.variant must be v1|v2, got {m.get('variant')!r}")
    layout = m.get("layout", "coco")
    expected_v = {"coco": 17, "openpose": 18, "coco_with_neck": 18}.get(layout)
    if expected_v is not None and int(m["num_keypoints"]) != expected_v:
        raise ValueError(
            f"layout {layout!r} implies {expected_v} keypoints, got num_keypoints={m['num_keypoints']}"
        )

