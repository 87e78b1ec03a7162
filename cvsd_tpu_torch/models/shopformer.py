"""Shopformer — GCAE tokenizer ⊕ transformer token reconstructor ⊕
reconstruction-error anomaly score (PyTorch port of
``cvsd_tpu/models/shopformer.py``).

Scoring follows ``variant``: v1 adds the sinusoidal PE to the target tokens,
v2 compares against the plain tokens. The two training stages' losses:
stage 1 is the GCAE's reconstruction MSE; stage 2 is the transformer's MSE
against the variant target, on tokens from the GCAE in eval mode under
``no_grad`` (the counterpart of ``stop_gradient(tokenize(train=False))``).
The GCAE's dropout is ``model.dropout`` under v1 and 0 under v2, as in JAX.

The reference-mirror options (``gcae_strides``, ``token_order``,
``pool_to_tokens``, ``gcae_decoder_variant``, ``transformer_final_norm``,
``ln_eps``; ``models/gcae.py``, ``models/transformer.py``) rebuild the
reference's own architectures, whose torch checkpoints
``utils/shopformer_import.py`` reads; the defaults are the JAX package's
design.

Weights come from a flax Shopformer through
``utils/weights.py::load_flax_variables`` or from a seeded
``torch.Generator``. ``train`` arguments set the mode of the part they
concern for the call and restore it after; train-mode dropout draws from the
``DropoutRNG`` passed in (``models/layers.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from cvsd_tpu_torch.models.gcae import GCAE
from cvsd_tpu_torch.models.layers import DropoutRNG, set_mode
from cvsd_tpu_torch.models.transformer import ShopformerTransformer, sinusoidal_positional_encoding
from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device


class Shopformer(nn.Module):
    """Composed anomaly detector (defaults: V=18, T=12, 2 tokens, d_model 144)."""

    def __init__(self, in_channels: int = 2, hidden_channels: int = 64, latent_channels: int = 8,
                 num_keypoints: int = 18, seq_len: int = 12, num_tokens: int = 2,
                 gcae_layers: int = 4, layout: str = "coco_with_neck", num_heads: int = 2,
                 num_encoder_layers: int = 2, num_decoder_layers: int = 2,
                 dim_feedforward: int = 64, dropout: float = 0.1, variant: str = "v2",
                 score_max_len: int = 100, gcae_strides: Optional[tuple] = None,
                 transformer_final_norm: bool = False, ln_eps: float = 1e-6,
                 d_model_override: Optional[int] = None, token_order: str = "vc",
                 pool_to_tokens: bool = True, gcae_decoder_variant: str = "tpu"):
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
                         layout=layout, strides_override=gcae_strides,
                         dropout=dropout if variant == "v1" else 0.0,
                         token_order=token_order, pool_to_tokens=pool_to_tokens,
                         decoder_variant=gcae_decoder_variant)
        self.transformer = ShopformerTransformer(
            d_model=self.d_model, num_heads=num_heads, num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers, dim_feedforward=dim_feedforward,
            input_dim=embed if embed != self.d_model else None, variant=variant,
            final_norm=transformer_final_norm, ln_eps=ln_eps, dropout=dropout)
        self.register_buffer(
            "score_pe", torch.from_numpy(sinusoidal_positional_encoding(score_max_len, self.d_model)),
            persistent=False)

    # -- components -------------------------------------------------------------

    def tokenize(self, poses: torch.Tensor, rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """poses (B, T, V, C) -> (B, num_tokens, d_model) tokens."""
        return self.gcae.encode(poses, rng)

    def reconstruct_tokens(self, tokens: torch.Tensor,
                           rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        return self.transformer(tokens, rng)

    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens -> poses (B, T, V, C) through the GCAE decoder."""
        return self.gcae.decode(tokens)

    def gcae_forward(self, poses: torch.Tensor, rng: Optional[DropoutRNG] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(reconstruction, tokens): the stage-1 forward."""
        return self.gcae(poses, rng)

    # -- scoring ----------------------------------------------------------------

    def score_target(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens + PE under v1, plain tokens under v2."""
        if self.variant == "v1":
            return tokens + self.score_pe[None, : tokens.shape[1], :].to(tokens.dtype)
        return tokens

    def compute_normality_score(self, tokens: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
        return ((recon - self.score_target(tokens)) ** 2).mean(dim=(1, 2))

    @torch.no_grad()
    def compute_anomaly_score(self, poses: torch.Tensor) -> torch.Tensor:
        """poses -> per-sample anomaly score (higher = more anomalous); the
        model is expected in eval mode, as build_shopformer and load_model
        leave it."""
        tokens = self.tokenize(poses)
        return self.compute_normality_score(tokens, self.reconstruct_tokens(tokens))

    def get_anomaly_scores(self, poses: torch.Tensor) -> torch.Tensor:
        """Alias for compute_anomaly_score."""
        return self.compute_anomaly_score(poses)

    def predict(self, poses: torch.Tensor, threshold: float = 0.5) -> Dict[str, torch.Tensor]:
        """Binary anomaly predictions at a threshold."""
        scores = self.compute_anomaly_score(poses)
        return {"scores": scores, "predictions": (scores >= threshold).to(torch.int32)}

    def forward(self, poses: torch.Tensor, decode_poses: bool = True,
                rng: Optional[DropoutRNG] = None) -> Dict[str, torch.Tensor]:
        """The v1 output dict: tokens, reconstructed tokens, normality score
        and (with ``decode_poses``) the GCAE's pose reconstruction."""
        tokens = self.tokenize(poses, rng)
        recon_tokens = self.reconstruct_tokens(tokens, rng)
        out = {
            "tokens": tokens,
            "reconstructed_tokens": recon_tokens,
            "normality_score": self.compute_normality_score(tokens, recon_tokens),
        }
        if decode_poses:
            out["gcae_reconstructed"] = self.decode_tokens(tokens)
        return out

    # -- the two stages' losses -------------------------------------------------------

    def compute_gcae_loss(self, poses: torch.Tensor, train: bool = True,
                          mask: Optional[torch.Tensor] = None,
                          rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """Stage 1: MSE between the GCAE's reconstruction and the poses; in
        train mode the GCAE's BatchNorms move their running statistics."""
        with set_mode(self.gcae, train):
            recon, _ = self.gcae(poses, rng)
        return _masked_mean(((recon - poses) ** 2).mean(dim=(1, 2, 3)), mask)

    def compute_transformer_loss(self, poses: torch.Tensor, train: bool = True,
                                 mask: Optional[torch.Tensor] = None,
                                 rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """Stage 2: MSE between the transformer's output and the variant
        target, on tokens from the GCAE in eval mode without gradients."""
        with torch.no_grad(), set_mode(self.gcae, False):
            tokens = self.gcae.encode(poses)
        with set_mode(self.transformer, train):
            recon = self.transformer(tokens, rng)
        return _masked_mean(((recon - self.score_target(tokens)) ** 2).mean(dim=(1, 2)), mask)

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "Shopformer":
        m = config["model"]
        if str(m.get("dtype", "float32")) != "float32":
            raise NotImplementedError("the port runs the Shopformer in float32 only")
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
            dropout=float(m.get("dropout", 0.1)),
            variant=m.get("variant", "v2"),
            gcae_strides=(tuple(m["gcae_strides"]) if m.get("gcae_strides") else None),
            transformer_final_norm=bool(m.get("transformer_final_norm", False)),
            ln_eps=float(m.get("ln_eps", 1e-6)),
            d_model_override=(int(m["d_model"]) if m.get("d_model") else None),
            token_order=m.get("token_order", "vc"),
            pool_to_tokens=bool(m.get("pool_to_tokens", True)),
            gcae_decoder_variant=m.get("gcae_decoder_variant", "tpu"),
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


def count_parameters(model: nn.Module) -> Dict[str, int]:
    """Parameter counts per top-level part (``gcae``, ``transformer``) and
    their ``total``."""
    counts: Dict[str, int] = {}
    for name, sub in model.named_children():
        counts[name] = int(sum(p.numel() for p in sub.parameters()))
    counts["total"] = sum(counts.values())
    return counts


def _masked_mean(per_sample: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return per_sample.mean()
    mask = mask.to(per_sample.dtype)
    return (per_sample * mask).sum() / torch.clamp(mask.sum(), min=1.0)
