"""Batched Shopformer scoring and checkpoint loading (PyTorch port of
``ShopformerScorer`` and ``load_model`` in ``cvsd_tpu/eval/evaluate.py``).
``load_model`` reads the JAX package's msgpack checkpoints through
``utils/checkpoint.py``; the evaluation drivers (``evaluate_checkpoint`` and
its plots) wait for the training slice (ROADMAP.md, module queue: Shopformer
training and evaluation)."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from cvsd_tpu_torch.config import Config, get_default_config, merge_configs
from cvsd_tpu_torch.data.datamodule import batch_iterator
from cvsd_tpu_torch.models.shopformer import SKIP_FLAX, Shopformer, build_shopformer
from cvsd_tpu_torch.utils.checkpoint import load_checkpoint
from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device, use_float32_math
from cvsd_tpu_torch.utils.weights import load_flax_variables


class ShopformerScorer:
    """A Shopformer on one device + fixed-shape batched scoring."""

    def __init__(self, model: Shopformer, config: Dict[str, Any], device: DeviceLike = None):
        self.device = resolve_device(device)
        use_float32_math()  # the Shopformer scores in float32
        self.model = model.to(self.device).eval()
        self.config = Config(config)

    def score(self, poses: np.ndarray, batch_size: Optional[int] = None) -> np.ndarray:
        """Score (N, T, V, C) pose sequences -> (N,) anomaly scores, in batches
        of one static shape (pad-and-mask)."""
        bs = int(batch_size or self.config["data"].get("batch_size", 32))
        out = []
        for batch in batch_iterator(np.asarray(poses, np.float32), batch_size=bs):
            s = self.fetch_scores(self.score_async(batch["poses"]))
            out.append(s[batch["mask"].astype(bool)])
        return np.concatenate(out) if out else np.zeros(0)

    def score_async(self, poses: np.ndarray) -> torch.Tensor:
        """Enqueue one (B, T, V, C) batch and return the device tensor without
        waiting for it; ``fetch_scores`` brings it to the host later."""
        x = torch.from_numpy(np.ascontiguousarray(poses, np.float32)).to(self.device)
        return self.model.compute_anomaly_score(x)

    @staticmethod
    def fetch_scores(device_scores: torch.Tensor) -> np.ndarray:
        return device_scores.cpu().numpy()


def load_model(checkpoint_path: str, config: Optional[Dict[str, Any]] = None,
               device: DeviceLike = None) -> ShopformerScorer:
    """Rebuild the Shopformer from the checkpoint's embedded config (or an
    explicit one, or a sibling ``config.json``), merged over the defaults,
    and fill it from the checkpoint's flax variables on ``device`` (default:
    the CUDA card, raising without one). The GCAE decoder's variables, which
    the port does not hold, are skipped."""
    dev = resolve_device(device)
    use_float32_math()
    state, meta = load_checkpoint(checkpoint_path)
    if config is None:
        config = meta.get("config")
        if config is None:
            sidecar = os.path.join(os.path.dirname(checkpoint_path), "config.json")
            if os.path.exists(sidecar):
                with open(sidecar) as f:
                    config = json.load(f)
    config = merge_configs(get_default_config(), config or {})
    model = build_shopformer(config, device="cpu")
    variables = {"params": state["params"], "batch_stats": state.get("batch_stats", {})}
    load_flax_variables(model, variables, skip=SKIP_FLAX)
    return ShopformerScorer(model, config, device=dev)
