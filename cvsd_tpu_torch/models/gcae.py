"""GCAE encoder — spatio-temporal graph-convolutional pose tokenizer
(PyTorch port of the scoring half of ``cvsd_tpu/models/gcae.py``).

- GraphConvolution: A·X·W with a constant normalized skeleton adjacency
- TemporalConvolution: k=9 conv along time, stride s, pad 4, + BatchNorm
- STGCNBlock: gcn -> ReLU -> tcn -> +residual -> ReLU (1x1 conv+BN residual
  when the shape changes)
- GCAEEncoder: input BatchNorm over the (V, C) feature pair, ST-GCN blocks,
  adaptive-average pool to ``num_tokens``, tokens (B, num_tokens, V*latent)

Poses are (B, T, V, C) at the public functions; the temporal convolutions run
on (B, C, T, V). BatchNorm eps is flax's default 1e-5. The decoder is not on
the scoring path and is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cvsd_tpu_torch.models.graph import (
    adaptive_pool_matrix,
    compute_strides,
    normalized_skeleton_adjacency,
)

_BN_EPS = 1e-5  # flax nn.BatchNorm default


class GraphConvolution(nn.Module):
    """out = A @ X @ W + b over each (batch, time) slice; x is (B, T, V, C)."""

    def __init__(self, in_channels: int, out_channels: int, adj: torch.Tensor):
        super().__init__()
        self.register_buffer("adj", adj, persistent=False)
        self.Dense_0 = nn.Linear(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(torch.einsum("vw,btwc->btvc", self.adj, x))


class TemporalConvolution(nn.Module):
    """Conv (kernel 9 along T, stride s) + BatchNorm; x is (B, C, T, V)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, kernel_size: int = 9):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.Conv_0 = nn.Conv2d(in_channels, out_channels, (kernel_size, 1), (stride, 1), (pad, 0))
        self.BatchNorm_0 = nn.BatchNorm2d(out_channels, eps=_BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(self.Conv_0(x))


class STGCNBlock(nn.Module):
    """gcn -> ReLU -> tcn -> (+ residual) -> ReLU, on (B, T, V, C)."""

    def __init__(self, in_channels: int, out_channels: int, adj: torch.Tensor, stride: int = 1):
        super().__init__()
        self.GraphConvolution_0 = GraphConvolution(in_channels, out_channels, adj)
        self.TemporalConvolution_0 = TemporalConvolution(out_channels, out_channels, stride)
        self.project = not (in_channels == out_channels and stride == 1)
        if self.project:
            self.Conv_0 = nn.Conv2d(in_channels, out_channels, 1, (stride, 1))
            self.BatchNorm_0 = nn.BatchNorm2d(out_channels, eps=_BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.GraphConvolution_0(x))
        y = self.TemporalConvolution_0(y.permute(0, 3, 1, 2))  # (B, C, T, V)
        if self.project:
            res = self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)))
        else:
            res = x.permute(0, 3, 1, 2)
        return F.relu(y + res).permute(0, 2, 3, 1)


class FeatureBatchNorm(nn.Module):
    """Inference BatchNorm over the trailing (V, C) feature pair (flax
    ``BatchNorm(axis=(-2, -1))``): params and statistics are (V, C)."""

    def __init__(self, shape: Sequence[int], eps: float = _BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(*shape))
        self.bias = nn.Parameter(torch.zeros(*shape))
        self.register_buffer("running_mean", torch.zeros(*shape))
        self.register_buffer("running_var", torch.ones(*shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


class GCAEEncoder(nn.Module):
    """ST-GCN encoder: (B, T, V, C) -> (B, num_tokens, V*latent) tokens."""

    def __init__(self, in_channels: int = 2, hidden_channels: int = 64, latent_channels: int = 8,
                 num_keypoints: int = 18, seq_len: int = 12, num_tokens: int = 2,
                 num_layers: int = 4, layout: str = "coco_with_neck",
                 strides_override: Optional[Sequence[int]] = None):
        super().__init__()
        self.latent_channels = latent_channels
        self.num_tokens = num_tokens
        self.num_layers = num_layers
        adj = torch.from_numpy(normalized_skeleton_adjacency(num_keypoints, layout))
        self.BatchNorm_0 = FeatureBatchNorm((num_keypoints, in_channels))
        channels = [in_channels] + [hidden_channels] * (num_layers - 1) + [latent_channels]
        strides = (tuple(strides_override) if strides_override is not None
                   else compute_strides(seq_len, num_tokens, num_layers))
        t = seq_len
        for i in range(num_layers):
            self.add_module(f"STGCNBlock_{i}",
                            STGCNBlock(channels[i], channels[i + 1], adj, strides[i]))
            t = (t + 8 - 9) // strides[i] + 1
        self.pool = t != num_tokens
        if self.pool:
            self.register_buffer(
                "pool_matrix", torch.from_numpy(adaptive_pool_matrix(t, num_tokens)),
                persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, V, C = x.shape
        x = self.BatchNorm_0(x)
        for i in range(self.num_layers):
            x = getattr(self, f"STGCNBlock_{i}")(x)
        if self.pool:
            x = torch.einsum("ot,btvc->bovc", self.pool_matrix, x)
        return x.reshape(B, x.shape[1], V * self.latent_channels)


class GCAE(nn.Module):
    """The GCAE's encoder (the tokenizer the anomaly score needs)."""

    def __init__(self, **encoder_kwargs):
        super().__init__()
        self.encoder = GCAEEncoder(**encoder_kwargs)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)
