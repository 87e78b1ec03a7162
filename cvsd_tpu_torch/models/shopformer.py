"""Shopformer scoring surface — GCAE tokenizer ⊕ transformer token
reconstructor ⊕ reconstruction-error anomaly score (PyTorch port of
``cvsd_tpu/models/shopformer.py``, inference only).

Scoring follows ``variant``: v1 adds the sinusoidal PE to the target tokens,
v2 compares against the plain tokens. Weights come from a flax Shopformer
through ``utils/weights.py::load_flax_variables(model, v, skip=SKIP_FLAX)``
or from a seeded ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from cvsd_tpu_torch.models.gcae import GCAE
from cvsd_tpu_torch.models.transformer import ShopformerTransformer, sinusoidal_positional_encoding
from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device

# flax subtrees the port does not hold: the GCAE decoder is not on the
# scoring path (ROADMAP.md, deferred items)
SKIP_FLAX = ("gcae/decoder",)


class Shopformer(nn.Module):
    """Composed anomaly scorer (defaults: V=18, T=12, 2 tokens, d_model 144)."""

    def __init__(self, in_channels: int = 2, hidden_channels: int = 64, latent_channels: int = 8,
                 num_keypoints: int = 18, seq_len: int = 12, num_tokens: int = 2,
                 gcae_layers: int = 4, layout: str = "coco_with_neck", num_heads: int = 2,
                 num_encoder_layers: int = 2, num_decoder_layers: int = 2,
                 dim_feedforward: int = 64, variant: str = "v2", score_max_len: int = 100,
                 gcae_strides: Optional[tuple] = None, transformer_final_norm: bool = False,
                 ln_eps: float = 1e-6, d_model_override: Optional[int] = None):
        super().__init__()
        self.variant = variant
        self.seq_len = seq_len
        self.num_keypoints = num_keypoints
        self.in_channels = in_channels
        embed = latent_channels * num_keypoints
        self.d_model = d_model_override or embed
        self.gcae = GCAE(in_channels=in_channels, hidden_channels=hidden_channels,
                         latent_channels=latent_channels, num_keypoints=num_keypoints,
                         seq_len=seq_len, num_tokens=num_tokens, num_layers=gcae_layers,
                         layout=layout, strides_override=gcae_strides)
        self.transformer = ShopformerTransformer(
            d_model=self.d_model, num_heads=num_heads, num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers, dim_feedforward=dim_feedforward,
            input_dim=embed if embed != self.d_model else None, variant=variant,
            final_norm=transformer_final_norm, ln_eps=ln_eps)
        self.register_buffer(
            "score_pe", torch.from_numpy(sinusoidal_positional_encoding(score_max_len, self.d_model)),
            persistent=False)

    def tokenize(self, poses: torch.Tensor) -> torch.Tensor:
        """poses (B, T, V, C) -> (B, num_tokens, d_model) tokens."""
        return self.gcae.encode(poses)

    def reconstruct_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.transformer(tokens)

    def score_target(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens + PE under v1, plain tokens under v2."""
        if self.variant == "v1":
            return tokens + self.score_pe[None, : tokens.shape[1], :].to(tokens.dtype)
        return tokens

    def compute_normality_score(self, tokens: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
        return ((recon - self.score_target(tokens)) ** 2).mean(dim=(1, 2))

    @torch.no_grad()
    def compute_anomaly_score(self, poses: torch.Tensor) -> torch.Tensor:
        """poses -> per-sample anomaly score (higher = more anomalous)."""
        tokens = self.tokenize(poses)
        return self.compute_normality_score(tokens, self.reconstruct_tokens(tokens))

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "Shopformer":
        m = config["model"]
        for key, default in (("token_order", "vc"), ("pool_to_tokens", True),
                             ("gcae_decoder_variant", "tpu")):
            if m.get(key, default) != default:
                raise NotImplementedError(
                    f"model.{key}={m.get(key)!r} (the reference-mirror import options) is "
                    "not ported yet: ROADMAP.md, deferred items")
        if str(m.get("dtype", "float32")) != "float32":
            raise NotImplementedError("the port scores the Shopformer in float32 only")
        return cls(
            in_channels=int(m.get("in_channels", 2)),
            hidden_channels=int(m.get("hidden_channels", 64)),
            latent_channels=int(m.get("latent_channels", 8)),
            num_keypoints=int(m.get("num_keypoints", 18)),
            seq_len=int(m.get("seq_len", 12)),
            num_tokens=int(m.get("num_tokens", 2)),
            gcae_layers=int(m.get("gcae_layers", 4)),
            layout=m.get("layout", "coco_with_neck"),
            num_heads=int(m.get("num_heads", 2)),
            num_encoder_layers=int(m.get("num_encoder_layers", 2)),
            num_decoder_layers=int(m.get("num_decoder_layers", 2)),
            dim_feedforward=int(m.get("dim_feedforward", 64)),
            variant=m.get("variant", "v2"),
            gcae_strides=(tuple(m["gcae_strides"]) if m.get("gcae_strides") else None),
            transformer_final_norm=bool(m.get("transformer_final_norm", False)),
            ln_eps=float(m.get("ln_eps", 1e-6)),
            d_model_override=(int(m["d_model"]) if m.get("d_model") else None),
        )


def build_shopformer(config: Dict[str, Any], device: DeviceLike = None, seed: int = 0,
                     state_dict: Optional[Dict[str, torch.Tensor]] = None) -> Shopformer:
    """Shopformer from ``config['model']`` on ``device`` (default: the CUDA
    card, raising without one), eval mode; weights from ``state_dict`` or
    seeded random (xavier-uniform, as the JAX modules initialise)."""
    from cvsd_tpu_torch.utils.weights import init_module

    dev = resolve_device(device)
    model = Shopformer.from_config(config)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_module(model, seed, xavier=True)
    return model.to(dev).eval()
