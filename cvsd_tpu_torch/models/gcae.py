"""GCAE — spatio-temporal graph-convolutional autoencoder, the pose tokenizer
(PyTorch port of ``cvsd_tpu/models/gcae.py``, both decoders).

- GraphConvolution: A·X·W with a constant normalized skeleton adjacency
- TemporalConvolution: k=9 conv along time, stride s, pad 4, + BatchNorm
- STGCNBlock: gcn -> ReLU -> tcn -> dropout -> +residual -> ReLU (1x1
  conv+BN residual when the shape changes)
- GCAEEncoder: input BatchNorm over the (V, C) feature pair, ST-GCN blocks,
  adaptive-average pool to ``num_tokens``, tokens (B, num_tokens, V*latent)
- GCAEDecoder: Dense expansion + ReLU, ``ceil(log2(seq_len/num_tokens))``
  x2 ConvTranspose + BatchNorm + ReLU along time, a resize to ``seq_len``,
  a k=9 conv back to ``in_channels``
- reference-mirror options, which ``utils/shopformer_import.py`` sets to
  read the reference's torch checkpoints: ``token_order="cv"`` (tokens in
  the reference's ``c*V + v`` order), ``pool_to_tokens=False`` (v1: no
  adaptive pool, as many tokens as the strides leave) and the decoder's
  ``variant="ref"`` (Dense expansion, per layer a ConvTranspose k=f s=f or a
  1x1 conv with BatchNorm + ReLU between the layers, the resize to
  ``seq_len``)

Poses are (B, T, V, C) at the public functions; the convolutions run on
(B, C, T, V). Every BatchNorm is ``models/layers.py::FlaxBatchNorm`` (flax's
train-mode statistics, eps 1e-5). A bfloat16 ``model.dtype`` computes as
flax's ``dtype=`` does over float32 parameters under XLA (``models/layers.py``):
every layer is one of that module's with its ``compute_dtype`` set
(``set_compute_dtype``), the products with the constant adjacency, pool and
resize matrices included (``product``).

Two parts are not PyTorch's stock behaviour, and the tests hold both to JAX:
  - flax's ``ConvTranspose`` does not flip its kernel, and its "SAME"
    padding for k 4, s 2 is lax's (2, 2): ``nn.ConvTranspose2d`` with
    padding 1 computes the same with the kernel flipped along time, which
    the weight bridge (``utils/weights.py``) does both ways;
  - ``jax.image.resize(..., "linear")`` antialiases when it shrinks (the
    default T 12 / 2 tokens decodes 2 -> 16 and resizes 16 -> 12). Like
    jax, the port resizes by a constant weight matrix along time
    (``linear_resize_matrix``): ``F.interpolate``'s antialiased bilinear
    computes the same, but its CUDA backward adds with atomics, so training
    would not repeat bit for bit.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cvsd_tpu_torch.models.graph import (
    adaptive_pool_matrix,
    compute_strides,
    normalized_skeleton_adjacency,
)
from cvsd_tpu_torch.models.layers import (Conv2d, ConvTranspose2d, DropoutRNG, FlaxBatchNorm,
                                          Linear, dropout, product)


class GraphConvolution(nn.Module):
    """out = A @ X @ W + b over each (batch, time) slice; x is (B, T, V, C)."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_channels: int, out_channels: int, adj: torch.Tensor):
        super().__init__()
        self.register_buffer("adj", adj, persistent=False)
        self.Dense_0 = Linear(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(product("vw,btwc->btvc", self.compute_dtype, self.adj, x))


class TemporalConvolution(nn.Module):
    """Conv (kernel 9 along T, stride s) + BatchNorm; x is (B, C, T, V)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, kernel_size: int = 9):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.Conv_0 = Conv2d(in_channels, out_channels, (kernel_size, 1), (stride, 1), (pad, 0))
        self.BatchNorm_0 = FlaxBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(self.Conv_0(x))


class STGCNBlock(nn.Module):
    """gcn -> ReLU -> tcn -> dropout -> (+ residual) -> ReLU, on (B, T, V, C)."""

    def __init__(self, in_channels: int, out_channels: int, adj: torch.Tensor, stride: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.GraphConvolution_0 = GraphConvolution(in_channels, out_channels, adj)
        self.TemporalConvolution_0 = TemporalConvolution(out_channels, out_channels, stride)
        self.project = not (in_channels == out_channels and stride == 1)
        if self.project:
            self.Conv_0 = Conv2d(in_channels, out_channels, 1, (stride, 1))
            self.BatchNorm_0 = FlaxBatchNorm(out_channels)

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        y = F.relu(self.GraphConvolution_0(x))
        y = self.TemporalConvolution_0(y.permute(0, 3, 1, 2))  # (B, C, T, V)
        y = dropout(y, self.dropout, self.training, rng)
        if self.project:
            res = self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)))
        else:
            res = x.permute(0, 3, 1, 2)
        return F.relu(y + res).permute(0, 2, 3, 1)


class GCAEEncoder(nn.Module):
    """ST-GCN encoder: (B, T, V, C) -> (B, num_tokens, V*latent) tokens
    (``pool_to_tokens=False``: as many tokens as the strides leave)."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_channels: int = 2, hidden_channels: int = 64, latent_channels: int = 8,
                 num_keypoints: int = 18, seq_len: int = 12, num_tokens: int = 2,
                 num_layers: int = 4, layout: str = "coco_with_neck",
                 strides_override: Optional[Sequence[int]] = None, dropout: float = 0.0,
                 token_order: str = "vc", pool_to_tokens: bool = True):
        super().__init__()
        if token_order not in ("vc", "cv"):
            raise ValueError(f"token_order must be 'vc' or 'cv', got {token_order!r}")
        self.latent_channels = latent_channels
        self.token_order = token_order
        self.num_tokens = num_tokens
        self.num_layers = num_layers
        adj = torch.from_numpy(normalized_skeleton_adjacency(num_keypoints, layout))
        # over the (V, C) feature pair of (B, T, V, C): flax BatchNorm(axis=(-2, -1))
        self.BatchNorm_0 = FlaxBatchNorm((num_keypoints, in_channels), feature_dims=(2, 3))
        channels = [in_channels] + [hidden_channels] * (num_layers - 1) + [latent_channels]
        strides = (tuple(strides_override) if strides_override is not None
                   else compute_strides(seq_len, num_tokens, num_layers))
        t = seq_len
        for i in range(num_layers):
            self.add_module(f"STGCNBlock_{i}",
                            STGCNBlock(channels[i], channels[i + 1], adj, strides[i], dropout))
            t = (t + 8 - 9) // strides[i] + 1
        self.pool = pool_to_tokens and t != num_tokens
        self.out_tokens = num_tokens if pool_to_tokens else t
        if self.pool:
            self.register_buffer(
                "pool_matrix", torch.from_numpy(adaptive_pool_matrix(t, num_tokens)),
                persistent=False)

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        B, T, V, C = x.shape
        x = self.BatchNorm_0(x)
        for i in range(self.num_layers):
            x = getattr(self, f"STGCNBlock_{i}")(x, rng)
        if self.pool:
            x = product("ot,btvc->bovc", self.compute_dtype, self.pool_matrix, x)
        if self.token_order == "cv":  # the reference's embedding order c*V + v
            x = x.transpose(2, 3)
        return x.reshape(B, x.shape[1], V * self.latent_channels)


def num_upsample_layers(seq_len: int, num_tokens: int) -> int:
    """x2 layers until the token axis meets or passes ``seq_len``."""
    if seq_len <= num_tokens:
        return 0
    return max(0, math.ceil(math.log2(seq_len / num_tokens)))


def linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 weights of ``jax.image.resize(...,
    "linear")`` along one axis (its ``compute_weight_mat`` with the triangle
    kernel, widened by in/out when it shrinks: the antialiasing)."""
    scale = out_size / in_size
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    w = np.where(((sample >= -0.5) & (sample <= in_size - 0.5))[None, :], w, 0.0)
    return np.ascontiguousarray(w.T, dtype=np.float32)


class GCAEDecoder(nn.Module):
    """Tokens (B, num_tokens, V*latent) -> poses (B, seq_len, V, in_channels)."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_channels: int = 2, hidden_channels: int = 64, latent_channels: int = 8,
                 num_keypoints: int = 18, seq_len: int = 12, num_tokens: int = 2):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.hidden_channels = hidden_channels
        self.seq_len = seq_len
        self.n_up = num_upsample_layers(seq_len, num_tokens)
        H = hidden_channels
        self.Dense_0 = Linear(latent_channels * num_keypoints, num_keypoints * H)
        for i in range(self.n_up):
            # flax ConvTranspose(k (4, 1), s (2, 1), "SAME") == this with the
            # kernel flipped along time (the bridge flips it)
            self.add_module(f"ConvTranspose_{i}", ConvTranspose2d(H, H, (4, 1), (2, 1), (1, 0)))
            self.add_module(f"BatchNorm_{i}", FlaxBatchNorm(H))
        t_up = num_tokens * 2 ** self.n_up
        self.resize = t_up != seq_len
        if self.resize:
            self.register_buffer("resize_matrix",
                                 torch.from_numpy(linear_resize_matrix(t_up, seq_len)),
                                 persistent=False)
        self.Conv_0 = Conv2d(H, in_channels, (9, 1), padding=(4, 0))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        B, n = tokens.shape[:2]
        V, H = self.num_keypoints, self.hidden_channels
        x = F.relu(self.Dense_0(tokens)).reshape(B, n, V, H).permute(0, 3, 1, 2)  # (B, H, n, V)
        for i in range(self.n_up):
            x = F.relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"ConvTranspose_{i}")(x)))
        if self.resize:  # jax.image.resize "linear" along time; V stays
            x = product("ot,bhtv->bhov", self.compute_dtype, self.resize_matrix, x)
        return self.Conv_0(x).permute(0, 2, 3, 1)


def ref_upsample_factors(num_tokens: int, seq_len: int, num_layers: int) -> List[int]:
    """The reference decoder's greedy x2 upsample plan: double while it stays
    <= seq_len, one layer at a time; the resize takes the remainder."""
    factors = [1] * num_layers
    current = num_tokens
    for i in range(num_layers):
        if current < seq_len and current * 2 <= seq_len:
            factors[i] = 2
            current *= 2
    return factors


class GCAERefDecoder(nn.Module):
    """The reference's decoder stack (``GCAEDecoder(variant="ref")`` of the
    JAX package): tokens (B, n, V*latent) -> poses (B, seq_len, V,
    in_channels). A Dense expansion with no activation, then per layer a
    ConvTranspose (k=f, s=f) along time where the plan doubles, else a 1x1
    conv, with BatchNorm + ReLU between the layers and not after the last,
    then jax's antialiased linear resize to ``seq_len``. ``in_tokens`` is
    the encoder's token count (v1 may feed more than ``num_tokens``): the
    plan is the configured one and the resize takes what it leaves. Flax
    names: Dense_0, ConvTranspose_i, Conv_i and BatchNorm_i, each type
    counted on its own."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_channels: int = 2, hidden_channels: int = 64, latent_channels: int = 8,
                 num_keypoints: int = 18, seq_len: int = 12, num_tokens: int = 2,
                 num_layers: int = 4, token_order: str = "vc",
                 in_tokens: Optional[int] = None):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.hidden_channels = hidden_channels
        self.seq_len = seq_len
        self.token_order = token_order
        H = hidden_channels
        self.Dense_0 = Linear(latent_channels * num_keypoints, num_keypoints * H)
        channels = [H] * (num_layers - 1) + [in_channels]
        self.layers = []  # (conv name, BatchNorm name or None), in order
        n_ct = n_conv = 0
        t = num_tokens if in_tokens is None else in_tokens
        for i, f in enumerate(ref_upsample_factors(num_tokens, seq_len, num_layers)):
            if f > 1:  # flax ConvTranspose(k=f, s=f, "VALID") == this, kernel flipped
                name = f"ConvTranspose_{n_ct}"
                self.add_module(name, ConvTranspose2d(H, channels[i], (f, 1), (f, 1)))
                n_ct += 1
            else:
                name = f"Conv_{n_conv}"
                self.add_module(name, Conv2d(H, channels[i], 1))
                n_conv += 1
            bn = None
            if i < num_layers - 1:
                bn = f"BatchNorm_{i}"
                self.add_module(bn, FlaxBatchNorm(channels[i]))
            self.layers.append((name, bn))
            t *= f
        self.resize = t != seq_len
        if self.resize:
            self.register_buffer("resize_matrix", torch.from_numpy(linear_resize_matrix(t, seq_len)),
                                 persistent=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        B, n = tokens.shape[:2]
        V, H = self.num_keypoints, self.hidden_channels
        x = self.Dense_0(tokens)
        if self.token_order == "cv":  # the reference's embedding order h*V + v
            x = x.reshape(B, n, H, V).transpose(1, 2)  # (B, H, n, V)
        else:
            x = x.reshape(B, n, V, H).permute(0, 3, 1, 2)
        for name, bn in self.layers:
            x = getattr(self, name)(x)
            if bn is not None:
                x = F.relu(getattr(self, bn)(x))
        if self.resize:  # jax.image.resize "linear" along time; V stays
            x = product("ot,bhtv->bhov", self.compute_dtype, self.resize_matrix, x)
        return x.permute(0, 2, 3, 1)


class GCAE(nn.Module):
    """Graph-conv autoencoder: encode -> tokens, decode -> reconstruction."""

    def __init__(self, in_channels: int = 2, hidden_channels: int = 64, latent_channels: int = 8,
                 num_keypoints: int = 18, seq_len: int = 12, num_tokens: int = 2,
                 num_layers: int = 4, layout: str = "coco_with_neck",
                 strides_override: Optional[Sequence[int]] = None, dropout: float = 0.0,
                 token_order: str = "vc", pool_to_tokens: bool = True,
                 decoder_variant: str = "tpu"):
        super().__init__()
        kw = dict(in_channels=in_channels, hidden_channels=hidden_channels,
                  latent_channels=latent_channels, num_keypoints=num_keypoints,
                  seq_len=seq_len, num_tokens=num_tokens)
        self.encoder = GCAEEncoder(num_layers=num_layers, layout=layout,
                                   strides_override=strides_override, dropout=dropout,
                                   token_order=token_order, pool_to_tokens=pool_to_tokens, **kw)
        if decoder_variant == "ref":
            self.decoder = GCAERefDecoder(num_layers=num_layers, token_order=token_order,
                                          in_tokens=self.encoder.out_tokens, **kw)
        elif decoder_variant == "tpu":
            self.decoder = GCAEDecoder(**kw)
        else:
            raise ValueError(f"gcae_decoder_variant must be 'tpu' or 'ref', got "
                             f"{decoder_variant!r}")

    def encode(self, x: torch.Tensor, rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        return self.encoder(x, rng)

    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.decoder(tokens)

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRNG] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(reconstruction, tokens)."""
        tokens = self.encoder(x, rng)
        return self.decoder(tokens), tokens
