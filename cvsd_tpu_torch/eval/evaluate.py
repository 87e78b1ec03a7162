"""Batched Shopformer scoring (PyTorch port of ``ShopformerScorer`` in
``cvsd_tpu/eval/evaluate.py``). Checkpoint loading (``load_model``) waits for
the msgpack reader (ROADMAP.md, deferred items)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from cvsd_tpu_torch.config import Config
from cvsd_tpu_torch.data.datamodule import batch_iterator
from cvsd_tpu_torch.models.shopformer import Shopformer
from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device


class ShopformerScorer:
    """A Shopformer on one device + fixed-shape batched scoring."""

    def __init__(self, model: Shopformer, config: Dict[str, Any], device: DeviceLike = None):
        self.device = resolve_device(device)
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
