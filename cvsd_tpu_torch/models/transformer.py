"""Token transformer — encoder-decoder autoencoder over GCAE tokens
(PyTorch port of ``cvsd_tpu/models/transformer.py``).

- v1: post-LN layers with ReLU FFN, shifted-target decoding, always-on
  output projection
- v2: pre-LN + exact-erf GELU, identity target, projections only when the
  token width differs from d_model

Attention is written out as flax computes it (query scaled by
1/sqrt(head_dim), softmax over keys, per-head projections), so flax weights
carry across through ``utils/weights.py``. LayerNorm eps is ``ln_eps``
(1e-6 by default, not torch's 1e-5). The layers are ``models/layers.py``'s,
so a bfloat16 ``model.dtype`` computes as flax's ``dtype=`` does under XLA
(the attention's products, its scale and the positional table in the
compute dtype too).

In train mode, dropout (``models/layers.py::dropout``, from the explicit
``DropoutRNG`` the caller passes) sits where flax has ``nn.Dropout``: after
the positional encoding, after each attention block and after the FFN's
activation and its output; and on the attention weights, with flax's
``broadcast_dropout=True``: ONE (1, 1, q, k) mask shared by the whole batch
and every head. In eval mode nothing changes.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cvsd_tpu_torch.models.layers import (DropoutRNG, LayerNorm, Linear, dropout, gelu, product,
                                          softmax)


def sinusoidal_positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) sinusoidal table; odd d_model supported."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)[:, : d_model // 2]
    return pe


class MultiHeadDotProductAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (qkv_features = d_model):
    per-head q/k/v projections, softmax(q k^T / sqrt(hd)) v, out; in train
    mode the weights are dropped with one mask broadcast over batch and
    heads."""

    flax_kernel_init = "lecun_normal"  # flax's default for these projections (init_module)
    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not divisible by num_heads {num_heads}")
        self.dropout = dropout
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.query = Linear(d_model, d_model)
        self.key = Linear(d_model, d_model)
        self.value = Linear(d_model, d_model)
        self.out = Linear(d_model, d_model)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        B, Lq, _ = q_in.shape
        Lk = kv_in.shape[1]
        h, hd = self.num_heads, self.head_dim
        dt = self.compute_dtype
        q = self.query(q_in).reshape(B, Lq, h, hd)
        if dt is None:
            q = q / math.sqrt(hd)
        else:  # flax divides by sqrt(depth) rounded to the compute dtype
            q = q / torch.tensor(math.sqrt(hd), dtype=dt, device=q.device)
        k = self.key(kv_in).reshape(B, Lk, h, hd)
        v = self.value(kv_in).reshape(B, Lk, h, hd)
        weights = softmax(product("bqhd,bkhd->bhqk", dt, q, k), dim=-1)
        if self.training and self.dropout > 0.0:
            if rng is None:
                raise ValueError("train-mode dropout needs a DropoutRNG (an explicit generator)")
            keep = 1.0 - self.dropout
            mask = rng.keep_mask((1, 1, Lq, Lk), keep, weights.device, batched=False)
            weights = weights * (mask.to(weights.dtype) / keep)
        out = product("bhqk,bkhd->bqhd", dt, weights, v)
        return self.out(out.reshape(B, Lq, h * hd))


class _FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, activation: str, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.Dense_0 = Linear(d_model, d_ff)
        self.Dense_1 = Linear(d_ff, d_model)
        # exact (erf) GELU for v2, as the reference's stock layers compute it
        self.act = F.relu if activation == "relu" else gelu

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        x = dropout(self.act(self.Dense_0(x)), self.dropout, self.training, rng)
        return dropout(self.Dense_1(x), self.dropout, self.training, rng)


class _Residual(nn.Module):
    """The residual stream. Below float32 (a ``compute_dtype``) it is kept in
    float32 as XLA computes it: a sum that a LayerNorm or the score reads is
    widened there unrounded (XLA folds the widening into the add), while the
    next residual add reads it rounded to the compute dtype."""

    compute_dtype: Optional[torch.dtype] = None

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return x if dt is None else x.to(dt).float()


class TransformerEncoderLayer(_Residual):
    """Post-LN (v1) or pre-LN (v2) encoder layer."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, norm_first: bool,
                 activation: str, ln_eps: float = 1e-6, dropout: float = 0.0):
        super().__init__()
        self.norm_first = norm_first
        self.dropout = dropout
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(d_model, num_heads,
                                                                           dropout)
        self._FeedForward_0 = _FeedForward(d_model, d_ff, activation, dropout)
        self.LayerNorm_0 = LayerNorm(d_model, eps=ln_eps)
        self.LayerNorm_1 = LayerNorm(d_model, eps=ln_eps)

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        attn, ffn = self.MultiHeadDotProductAttention_0, self._FeedForward_0

        def drop(y):
            return dropout(y, self.dropout, self.training, rng)

        r = self.residual
        if self.norm_first:
            h = self.LayerNorm_0(x)
            x = r(x) + drop(attn(h, h, rng))
            return r(x) + ffn(self.LayerNorm_1(x), rng)
        x = self.LayerNorm_0(r(x) + drop(attn(x, x, rng)))
        return self.LayerNorm_1(r(x) + ffn(x, rng))


class TransformerDecoderLayer(_Residual):
    """Self-attn, cross-attn, FFN — post-LN (v1) or pre-LN (v2)."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, norm_first: bool,
                 activation: str, ln_eps: float = 1e-6, dropout: float = 0.0):
        super().__init__()
        self.norm_first = norm_first
        self.dropout = dropout
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(d_model, num_heads,
                                                                           dropout)
        self.MultiHeadDotProductAttention_1 = MultiHeadDotProductAttention(d_model, num_heads,
                                                                           dropout)
        self._FeedForward_0 = _FeedForward(d_model, d_ff, activation, dropout)
        for i in range(3):
            self.add_module(f"LayerNorm_{i}", LayerNorm(d_model, eps=ln_eps))

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        self_attn = self.MultiHeadDotProductAttention_0
        cross_attn = self.MultiHeadDotProductAttention_1
        ffn = self._FeedForward_0

        def drop(y):
            return dropout(y, self.dropout, self.training, rng)

        r = self.residual
        if self.norm_first:
            h = self.LayerNorm_0(tgt)
            tgt = r(tgt) + drop(self_attn(h, h, rng))
            tgt = r(tgt) + drop(cross_attn(self.LayerNorm_1(tgt), memory, rng))
            return r(tgt) + ffn(self.LayerNorm_2(tgt), rng)
        tgt = self.LayerNorm_0(r(tgt) + drop(self_attn(tgt, tgt, rng)))
        tgt = self.LayerNorm_1(r(tgt) + drop(cross_attn(tgt, memory, rng)))
        return self.LayerNorm_2(r(tgt) + ffn(tgt, rng))


class ShopformerTransformer(nn.Module):
    """Encoder-decoder token reconstructor (defaults: d_model 144, 2 heads,
    2+2 layers, ff 64)."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, d_model: int = 144, num_heads: int = 2, num_encoder_layers: int = 2,
                 num_decoder_layers: int = 2, dim_feedforward: int = 64, max_len: int = 100,
                 input_dim: Optional[int] = None, variant: str = "v2",
                 final_norm: bool = False, ln_eps: float = 1e-6, dropout: float = 0.0):
        super().__init__()
        if variant not in ("v1", "v2"):
            raise ValueError(f"model.variant must be v1|v2, got {variant!r}")
        d_in = input_dim if input_dim is not None else d_model
        norm_first = variant == "v2"
        activation = "gelu" if variant == "v2" else "relu"
        self.variant = variant
        self.dropout = dropout
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.in_proj = Linear(d_in, d_model) if d_in != d_model else None
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_positional_encoding(max_len, d_model)),
            persistent=False)
        for i in range(num_encoder_layers):
            self.add_module(f"enc_layers_{i}", TransformerEncoderLayer(
                d_model, num_heads, dim_feedforward, norm_first, activation, ln_eps, dropout))
        for i in range(num_decoder_layers):
            self.add_module(f"dec_layers_{i}", TransformerDecoderLayer(
                d_model, num_heads, dim_feedforward, norm_first, activation, ln_eps, dropout))
        self.enc_norm = LayerNorm(d_model, eps=ln_eps) if final_norm else None
        self.dec_norm = LayerNorm(d_model, eps=ln_eps) if final_norm else None
        self.out_proj = (Linear(d_model, d_in)
                         if (variant == "v1" or d_in != d_model) else None)

    def _embed(self, x: torch.Tensor, rng: Optional[DropoutRNG]) -> torch.Tensor:
        if self.in_proj is not None:
            x = self.in_proj(x)
        pe = self.pe[None, : x.shape[1], :]
        if self.compute_dtype is not None:  # flax's table in the compute dtype, added in
            pe = pe.to(self.compute_dtype).float()  # float32 (the LayerNorm widens it)
            x = x.float()
        return dropout(x + pe, self.dropout, self.training, rng)

    def encode(self, tokens: torch.Tensor, rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        x = self._embed(tokens, rng)
        for i in range(self.num_encoder_layers):
            x = getattr(self, f"enc_layers_{i}")(x, rng)
        return self.enc_norm(x) if self.enc_norm is not None else x

    def decode(self, tgt: torch.Tensor, memory: torch.Tensor,
               rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        x = self._embed(tgt, rng)
        for i in range(self.num_decoder_layers):
            x = getattr(self, f"dec_layers_{i}")(x, memory, rng)
        return self.dec_norm(x) if self.dec_norm is not None else x

    def forward(self, tokens: torch.Tensor, rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        memory = self.encode(tokens, rng)
        if self.variant == "v1":  # shifted target: zeros start token + tokens[:, :-1]
            tgt = torch.cat([torch.zeros_like(tokens[:, :1]), tokens[:, :-1]], 1)
        else:  # identity target
            tgt = tokens
        out = self.decode(tgt, memory, rng)
        return self.out_proj(out) if self.out_proj is not None else out

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "ShopformerTransformer":
        m = config["model"]
        embed = int(m.get("latent_channels", 8)) * int(m.get("num_keypoints", 18))
        d_model = int(m.get("d_model", embed))
        return cls(
            d_model=d_model,
            input_dim=embed if embed != d_model else None,
            num_heads=int(m.get("num_heads", 2)),
            num_encoder_layers=int(m.get("num_encoder_layers", 2)),
            num_decoder_layers=int(m.get("num_decoder_layers", 2)),
            dim_feedforward=int(m.get("dim_feedforward", 64)),
            variant=m.get("variant", "v2"),
            final_norm=bool(m.get("transformer_final_norm", False)),
            ln_eps=float(m.get("ln_eps", 1e-6)),
            dropout=float(m.get("dropout", 0.1)),
        )


def build_transformer(config: Dict[str, Any]) -> ShopformerTransformer:
    """Factory, the counterpart of ``cvsd_tpu/models/transformer.py::build_transformer``."""
    return ShopformerTransformer.from_config(config)
