"""Hyperparameter sweep: grid / random / recommended / quick config search,
incremental results, analysis (the port's copy of ``cvsd_tpu/sweep/sweep.py``,
over ``train/loop.py::Trainer``).

The 12-dim ``SEARCH_SPACE``, ``QUICK_SEARCH_SPACE``, 5 named
``RECOMMENDED_CONFIGS``, the four generation modes, per-config training with
failure capture and an incremental ``sweep_results.json``, and the top-5 plus
per-parameter mean-AUC analysis. Configs run in-process, one after another,
on one device (the default is the CUDA card, resolved before the first
config, so a missing card raises instead of failing every config). A
failing config is recorded as ``failed`` and the sweep goes on, as the
reference's does; ``training.max_seconds`` bounds each config's wall clock.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import time
import traceback
from typing import Any, Dict, Iterable, List, Optional

from cvsd_tpu_torch.config import Config, get_default_config, merge_configs
from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device

SEARCH_SPACE: Dict[str, List[Any]] = {
    "model.hidden_channels": [64, 128],
    "model.latent_channels": [8, 16],
    "model.num_heads": [2, 4],
    "model.num_encoder_layers": [2, 3],
    "model.dim_feedforward": [64, 128],
    "model.dropout": [0.1, 0.2, 0.3],
    "model.num_tokens": [2, 4],
    "training.lr": [1e-4, 5e-5, 1e-5],
    "data.batch_size": [16, 32],
    "training.weight_decay": [1e-4, 1e-5],
    "training.scheduler": ["cosine_warmup", "reduce_on_plateau"],
    "data.augment.jitter_std": [0.01, 0.02, 0.03],
}

QUICK_SEARCH_SPACE: Dict[str, List[Any]] = {
    "model.hidden_channels": [64, 128],
    "model.latent_channels": [8, 16],
    "model.num_encoder_layers": [2, 3],
    "model.dropout": [0.1, 0.2],
    "training.lr": [1e-4, 5e-5],
}

RECOMMENDED_CONFIGS: List[Dict[str, Any]] = [
    {"name": "baseline", "model.hidden_channels": 64, "model.latent_channels": 8,
     "model.num_heads": 2, "model.num_encoder_layers": 2, "model.dim_feedforward": 64,
     "model.dropout": 0.1, "training.lr": 5e-5, "data.batch_size": 32,
     "training.stage1_epochs": 30, "training.stage2_epochs": 50},
    {"name": "deeper_wider", "model.hidden_channels": 128, "model.latent_channels": 16,
     "model.num_heads": 4, "model.num_encoder_layers": 3, "model.dim_feedforward": 128,
     "model.dropout": 0.2, "training.lr": 1e-4, "data.batch_size": 32,
     "training.stage1_epochs": 40, "training.stage2_epochs": 60},
    {"name": "high_regularization", "model.hidden_channels": 64, "model.latent_channels": 8,
     "model.num_heads": 2, "model.num_encoder_layers": 2, "model.dim_feedforward": 64,
     "model.dropout": 0.3, "training.lr": 1e-4, "training.weight_decay": 1e-3,
     "data.batch_size": 16, "training.stage1_epochs": 30, "training.stage2_epochs": 50},
    {"name": "more_tokens", "model.hidden_channels": 64, "model.latent_channels": 16,
     "model.num_heads": 4, "model.num_encoder_layers": 2, "model.dim_feedforward": 128,
     "model.dropout": 0.2, "model.num_tokens": 4, "training.lr": 5e-5,
     "data.batch_size": 32, "training.stage1_epochs": 30, "training.stage2_epochs": 50},
    {"name": "aggressive_augmentation", "model.hidden_channels": 128, "model.latent_channels": 8,
     "model.num_heads": 2, "model.num_encoder_layers": 2, "model.dim_feedforward": 64,
     "model.dropout": 0.2, "training.lr": 1e-4, "data.batch_size": 32,
     "data.augment.jitter_std": 0.03, "data.augment.temporal_dropout_prob": 0.1,
     "training.stage1_epochs": 40, "training.stage2_epochs": 60},
]


def _set_path(cfg: Dict[str, Any], path: str, value: Any) -> None:
    node = cfg
    keys = path.split(".")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def generate_configs(
    mode: str = "recommended",
    base_config: Optional[Dict[str, Any]] = None,
    num_random: int = 20,
    seed: int = 0,
    search_space: Optional[Dict[str, List[Any]]] = None,
) -> List[Dict[str, Any]]:
    """Build the list of full config trees to sweep (reference: sweep.py:364-385)."""
    base = merge_configs(get_default_config(), base_config or {})
    configs: List[Dict[str, Any]] = []

    def make(overrides: Dict[str, Any], name: str) -> Dict[str, Any]:
        cfg = merge_configs(base, {})
        for k, v in overrides.items():
            if k == "name":
                continue
            _set_path(cfg, k, v)
        cfg["experiment"]["name"] = name
        return cfg

    if mode == "recommended":
        for rc in RECOMMENDED_CONFIGS:
            configs.append(make(rc, rc["name"]))
    elif mode in ("grid", "quick"):
        space = search_space or (QUICK_SEARCH_SPACE if mode == "quick" else SEARCH_SPACE)
        keys = list(space.keys())
        for i, combo in enumerate(itertools.product(*(space[k] for k in keys))):
            configs.append(make(dict(zip(keys, combo)), f"{mode}_{i:04d}"))
        if mode == "quick":
            # quick pairs a reduced space with synthetic data + tiny epochs
            # (reference: sweep.py:372-377)
            for cfg in configs:
                cfg["data"]["dataset"] = "synthetic"
                cfg["training"]["stage1_epochs"] = min(cfg["training"]["stage1_epochs"], 2)
                cfg["training"]["stage2_epochs"] = min(cfg["training"]["stage2_epochs"], 2)
    elif mode == "random":
        space = search_space or SEARCH_SPACE
        rng = random.Random(seed)
        for i in range(num_random):
            overrides = {k: rng.choice(v) for k, v in space.items()}
            configs.append(make(overrides, f"random_{i:04d}"))
    else:
        raise ValueError(f"unknown sweep mode {mode!r}")
    return configs


def run_sweep(
    configs: Iterable[Dict[str, Any]],
    output_dir: str,
    verbose: bool = False,
    max_configs: Optional[int] = None,
    timeout_seconds: Optional[float] = 7200.0,
    device: DeviceLike = None,
) -> List[Dict[str, Any]]:
    """Train each config in-process, harvest best AUC, write incremental
    sweep_results.json (reference: sweep.py:158-266).

    timeout_seconds bounds each config's wall clock (default 2 h, the
    reference's per-config subprocess timeout, sweep.py:189-195): the trainer
    checks the budget between epochs (training.max_seconds) and stops the run
    with whatever best checkpoint it has — a hung/slow config can no longer
    stall the whole sweep. None/0 disables the bound. ``device``: the
    default is the CUDA card, raising without one."""
    from cvsd_tpu_torch.train.loop import Trainer

    device = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    results: List[Dict[str, Any]] = []
    configs = list(configs)
    if max_configs:
        configs = configs[:max_configs]

    with open(os.path.join(output_dir, "sweep_info.json"), "w") as f:
        json.dump({"num_configs": len(configs),
                   "names": [c["experiment"]["name"] for c in configs]}, f, indent=2)

    for i, cfg in enumerate(configs):
        name = cfg["experiment"]["name"]
        cfg = merge_configs(cfg, {"experiment": {"checkpoint_dir": os.path.join(output_dir, name)}})
        if timeout_seconds:
            cfg = merge_configs(cfg, {"training": {"max_seconds": float(timeout_seconds)}})
        t0 = time.time()
        entry: Dict[str, Any] = {"name": name, "index": i, "config": Config(cfg).to_dict()}
        try:
            artifact = Trainer(cfg, verbose=verbose, device=device).setup().fit()
            entry.update(
                status="timeout" if artifact.get("timed_out") else "ok",
                best_auc=artifact["best_auc"],
                best_epoch=artifact["best_epoch"],
                test_metrics=artifact["test_metrics"],
            )
        except Exception as e:  # capture, don't abort the sweep (reference :189-220)
            entry.update(status="failed", error=f"{type(e).__name__}: {e}",
                         traceback=traceback.format_exc()[-2000:])
        entry["seconds"] = time.time() - t0
        results.append(entry)
        with open(os.path.join(output_dir, "sweep_results.json"), "w") as f:
            json.dump(results, f, indent=2, default=float)
        if verbose:
            print(f"[{i+1}/{len(configs)}] {name}: {entry.get('best_auc', entry['status'])}")
    analysis = analyze_results(results)
    with open(os.path.join(output_dir, "analysis.json"), "w") as f:
        json.dump(analysis, f, indent=2, default=float)
    return results


def analyze_results(results: List[Dict[str, Any]], top_k: int = 5) -> Dict[str, Any]:
    """Top-k configs + per-parameter mean-AUC importance (reference: sweep.py:271-328)."""
    # timed-out runs that still recorded a best checkpoint rank alongside
    # completed ones; never-evaluated runs (best_auc sentinel -1) drop out
    ok = [r for r in results if r.get("status") in ("ok", "timeout")
          and r.get("best_auc") is not None and r["best_auc"] >= 0.0]
    ranked = sorted(ok, key=lambda r: r["best_auc"], reverse=True)
    analysis: Dict[str, Any] = {
        "num_ok": len(ok),
        "num_failed": len(results) - len(ok),
        "top": [
            {"name": r["name"], "best_auc": r["best_auc"], "test_metrics": r.get("test_metrics")}
            for r in ranked[:top_k]
        ],
    }
    # per-parameter importance: mean AUC per swept value
    param_values: Dict[str, Dict[str, List[float]]] = {}
    for r in ok:
        flat = _flatten(r["config"])
        for k, v in flat.items():
            if k in SEARCH_SPACE or k in QUICK_SEARCH_SPACE:
                param_values.setdefault(k, {}).setdefault(str(v), []).append(r["best_auc"])
    analysis["param_importance"] = {
        k: {val: sum(aucs) / len(aucs) for val, aucs in vals.items()}
        for k, vals in param_values.items()
        if len(vals) > 1
    }
    return analysis


def _flatten(cfg: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in cfg.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out
