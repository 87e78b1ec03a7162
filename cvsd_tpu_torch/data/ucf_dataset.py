"""UCFCrimeDataset, a windowed view of the tabular BBox CSVs, and the
deep-MIL ranking loss of Sultani et al. (CVPR'18, the UCF-Crime paper):
the port's copy of ``cvsd_tpu/data/ucf_dataset.py``, the loss on tensors."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from cvsd_tpu_torch.models.xception_time import windows_from_bbox_csv


class UCFCrimeDataset:
    """Windowed (N, T, C) view over one or more BBox CSVs."""

    def __init__(self, paths: Sequence[str], seq_len: int = 64, stride: int = 32):
        self.paths = list(paths)
        self.seq_len = seq_len
        self.X, self.y = windows_from_bbox_csv(self.paths, seq_len=seq_len, stride=stride)

    def __len__(self) -> int:
        return int(self.X.shape[0])

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        return self.X[idx], int(self.y[idx])

    def class_counts(self) -> Dict[int, int]:
        vals, counts = np.unique(self.y, return_counts=True)
        return dict(zip(vals.tolist(), counts.tolist()))


def mil_ranking_loss(
    anomaly_scores: torch.Tensor,  # (B, S) segment scores of anomalous bags
    normal_scores: torch.Tensor,   # (B, S) segment scores of normal bags
    margin: float = 1.0,
    sparsity_weight: float = 8e-5,
    smoothness_weight: float = 8e-5,
) -> torch.Tensor:
    """hinge(margin - max(anomaly bag) + max(normal bag)) + sparsity (sum of
    the anomaly scores) + smoothness (squared adjacent differences), the
    mean over bags."""
    a_max = anomaly_scores.amax(dim=-1)
    n_max = normal_scores.amax(dim=-1)
    hinge = torch.clamp(margin - a_max + n_max, min=0.0)
    sparsity = anomaly_scores.sum(dim=-1)
    smooth = (torch.diff(anomaly_scores, dim=-1) ** 2).sum(dim=-1)
    return (hinge + sparsity_weight * sparsity + smoothness_weight * smooth).mean()
