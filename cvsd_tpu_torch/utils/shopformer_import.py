"""Import the reference's Shopformer torch checkpoints (the port's copy of
``cvsd_tpu/utils/shopformer_import.py``).

The reference trains in torch: v1 writes ``best_model.pt`` /
``final_model.pt`` / ``gcae_checkpoint.pt`` (``{'model_state_dict': ...}``),
v2 ``stage{1,2}_best.pt`` (its config embedded). This module converts those
state dicts into the flax-layout numpy tree the msgpack checkpoints of both
packages hold (``utils/checkpoint.py``), which ``utils/weights.py`` carries
into the port's ``Shopformer``, strictly.

The reference architectures differ from the JAX package's design in
load-bearing details (v1's greedy-halving strides with no adaptive pool,
the ``c*V + v`` token order, the decoder's per-layer ConvTranspose(k=f,
s=f) stack, v2's final LayerNorms, torch's LayerNorm eps 1e-5), so the
importer builds the model in reference-mirror mode through the config keys
``gcae_strides`` / ``token_order`` / ``pool_to_tokens`` /
``gcae_decoder_variant`` / ``transformer_final_norm`` / ``ln_eps``
(``models/gcae.py``, ``models/transformer.py``) and maps the weights
exactly.

Weight layout maps (torch -> flax):
- Linear (O,I) -> Dense kernel (I,O) = W.T;  GraphConvolution.weight is
  already (I,O) -> copied as-is
- Conv2d (O,I,kh,kw) on (B,C,T,V) -> Conv kernel (kh,kw,I,O) on (B,T,V,C)
- ConvTranspose2d (I,O,kh,kw) -> ConvTranspose kernel = spatially FLIPPED
  then (kh,kw,I,O)  (flax ConvTranspose correlates where torch convolves)
- BatchNorm1d over C*V (feature idx c*V+v) -> flax BatchNorm over (V,C):
  reshape (C,V) then transpose
- MultiheadAttention in_proj_weight (3E,E) -> q/k/v Dense kernels
  W[j*E:(j+1)*E].T reshaped (E,H,hd); out_proj.weight (E,E) ->
  out kernel W.T reshaped (H,hd,E)
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from cvsd_tpu_torch.models.gcae import ref_upsample_factors
from cvsd_tpu_torch.models.graph import compute_strides, compute_strides_v1
from cvsd_tpu_torch.utils.device import DeviceLike


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x,
                      np.float32)


def _linear(sd, p):
    return {"kernel": _np(sd[p + ".weight"]).T, "bias": _np(sd[p + ".bias"])}


def _conv(sd, p):
    return {"kernel": _np(sd[p + ".weight"]).transpose(2, 3, 1, 0),
            "bias": _np(sd[p + ".bias"])}


def _conv_transpose(sd, p):
    w = _np(sd[p + ".weight"])[:, :, ::-1, ::-1]
    return {"kernel": np.ascontiguousarray(w.transpose(2, 3, 0, 1)),
            "bias": _np(sd[p + ".bias"])}


def _bn(sd, p) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    return ({"scale": _np(sd[p + ".weight"]), "bias": _np(sd[p + ".bias"])},
            {"mean": _np(sd[p + ".running_mean"]), "var": _np(sd[p + ".running_var"])})


def _bn_vc(sd, p, V: int, C: int):
    """BatchNorm1d over C*V (idx c*V+v) -> flax (V, C) feature pair."""
    def r(a):
        return np.ascontiguousarray(_np(a).reshape(C, V).T)
    return ({"scale": r(sd[p + ".weight"]), "bias": r(sd[p + ".bias"])},
            {"mean": r(sd[p + ".running_mean"]), "var": r(sd[p + ".running_var"])})


def _mha(sd, p, num_heads: int):
    W = _np(sd[p + ".in_proj_weight"])
    b = _np(sd[p + ".in_proj_bias"])
    E = W.shape[1]
    hd = E // num_heads
    out = {}
    for j, name in enumerate(("query", "key", "value")):
        out[name] = {
            "kernel": np.ascontiguousarray(W[j * E:(j + 1) * E].T.reshape(E, num_heads, hd)),
            "bias": b[j * E:(j + 1) * E].reshape(num_heads, hd).copy(),
        }
    Wo = _np(sd[p + ".out_proj.weight"])
    out["out"] = {"kernel": np.ascontiguousarray(Wo.T.reshape(num_heads, hd, E)),
                  "bias": _np(sd[p + ".out_proj.bias"])}
    return out


def _ln(sd, p):
    return {"scale": _np(sd[p + ".weight"]), "bias": _np(sd[p + ".bias"])}


def _enc_layer(sd, p, heads):
    params = {
        "MultiHeadDotProductAttention_0": _mha(sd, p + ".self_attn", heads),
        "_FeedForward_0": {"Dense_0": _linear(sd, p + ".linear1"),
                           "Dense_1": _linear(sd, p + ".linear2")},
        "LayerNorm_0": _ln(sd, p + ".norm1"),
        "LayerNorm_1": _ln(sd, p + ".norm2"),
    }
    return params


def _dec_layer(sd, p, heads):
    return {
        "MultiHeadDotProductAttention_0": _mha(sd, p + ".self_attn", heads),
        "MultiHeadDotProductAttention_1": _mha(sd, p + ".multihead_attn", heads),
        "_FeedForward_0": {"Dense_0": _linear(sd, p + ".linear1"),
                           "Dense_1": _linear(sd, p + ".linear2")},
        "LayerNorm_0": _ln(sd, p + ".norm1"),
        "LayerNorm_1": _ln(sd, p + ".norm2"),
        "LayerNorm_2": _ln(sd, p + ".norm3"),
    }


def reference_model_config(
    variant: str,
    num_keypoints: int = 17,
    seq_len: int = 12,
    num_tokens: int = 2,
    hidden_channels: int = 64,
    latent_channels: int = 8,
    gcae_layers: int = 4,
    num_heads: int = 2,
    num_encoder_layers: int = 2,
    num_decoder_layers: int = 2,
    dim_feedforward: int = 64,
    layout: Optional[str] = None,
    d_model: Optional[int] = None,
) -> Dict[str, Any]:
    """The `model` config subtree that mirrors a reference architecture
    exactly (pass to Shopformer.from_config / build_shopformer)."""
    if layout is None:
        layout = "coco" if num_keypoints == 17 else "coco_with_neck"
    strides = (compute_strides_v1(seq_len, num_tokens, gcae_layers) if variant == "v1"
               else compute_strides(seq_len, num_tokens, gcae_layers))
    m: Dict[str, Any] = {
        "variant": variant,
        "num_keypoints": num_keypoints,
        "seq_len": seq_len,
        "num_tokens": num_tokens,
        "hidden_channels": hidden_channels,
        "latent_channels": latent_channels,
        "gcae_layers": gcae_layers,
        "num_heads": num_heads,
        "num_encoder_layers": num_encoder_layers,
        "num_decoder_layers": num_decoder_layers,
        "dim_feedforward": dim_feedforward,
        "layout": layout,
        "gcae_strides": list(strides),
        "token_order": "cv",
        "pool_to_tokens": variant != "v1",
        "gcae_decoder_variant": "ref",
        "transformer_final_norm": variant == "v2",
        "ln_eps": 1e-5,
    }
    if d_model:
        m["d_model"] = int(d_model)
    return m


def convert_state_dict(
    sd: Dict[str, Any],
    model_cfg: Dict[str, Any],
) -> Dict[str, Any]:
    """torch full-model state dict -> flax {'params', 'batch_stats'} for a
    Shopformer built from `reference_model_config`."""
    V = int(model_cfg["num_keypoints"])
    C = 2
    heads = int(model_cfg["num_heads"])
    H = int(model_cfg["hidden_channels"])
    variant = model_cfg["variant"]
    n_layers = int(model_cfg["gcae_layers"])
    strides = list(model_cfg["gcae_strides"])
    channels = [C] + [H] * (n_layers - 1) + [int(model_cfg["latent_channels"])]

    params: Dict[str, Any] = {"gcae": {"encoder": {}, "decoder": {}}, "transformer": {}}
    stats: Dict[str, Any] = {"gcae": {"encoder": {}, "decoder": {}}}

    # ---- GCAE encoder
    enc_p, enc_s = params["gcae"]["encoder"], stats["gcae"]["encoder"]
    p, st = _bn_vc(sd, "gcae.encoder.bn_input", V, C)
    enc_p["BatchNorm_0"], enc_s["BatchNorm_0"] = p, st
    for i in range(n_layers):
        blk = f"gcae.encoder.layers.{i}"
        bp: Dict[str, Any] = {}
        bs: Dict[str, Any] = {}
        bp["GraphConvolution_0"] = {"Dense_0": {
            "kernel": _np(sd[blk + ".gcn.weight"]),  # stored (in, out) already
            "bias": _np(sd[blk + ".gcn.bias"])}}
        bp["TemporalConvolution_0"] = {"Conv_0": _conv(sd, blk + ".tcn.conv")}
        pr, sr = _bn(sd, blk + ".tcn.bn")
        bp["TemporalConvolution_0"]["BatchNorm_0"] = pr
        bs["TemporalConvolution_0"] = {"BatchNorm_0": sr}
        if blk + ".residual.0.weight" in sd:  # non-identity residual
            bp["Conv_0"] = _conv(sd, blk + ".residual.0")
            pr, sr = _bn(sd, blk + ".residual.1")
            bp["BatchNorm_0"] = pr
            bs["BatchNorm_0"] = sr
        elif not (channels[i] == channels[i + 1] and strides[i] == 1):
            raise KeyError(f"expected residual conv params for block {i}")
        enc_p[f"STGCNBlock_{i}"] = bp
        enc_s[f"STGCNBlock_{i}"] = bs

    # ---- GCAE decoder (reference Sequential: CT/Conv [+BN+ReLU+Dropout])
    dec_p, dec_s = params["gcae"]["decoder"], stats["gcae"]["decoder"]
    dec_p["Dense_0"] = _linear(sd, "gcae.decoder.initial_proj")
    factors = ref_upsample_factors(
        int(model_cfg["num_tokens"]), int(model_cfg["seq_len"]), n_layers)
    seq_idx = 0
    n_ct = n_conv = n_bn = 0
    for i in range(n_layers):
        key = f"gcae.decoder.layers.{seq_idx}"
        if factors[i] > 1:
            dec_p[f"ConvTranspose_{n_ct}"] = _conv_transpose(sd, key)
            n_ct += 1
        else:
            dec_p[f"Conv_{n_conv}"] = _conv(sd, key)
            n_conv += 1
        seq_idx += 1
        if i < n_layers - 1:
            pr, sr = _bn(sd, f"gcae.decoder.layers.{seq_idx}")
            dec_p[f"BatchNorm_{n_bn}"] = pr
            dec_s[f"BatchNorm_{n_bn}"] = sr
            n_bn += 1
            seq_idx += 3  # BN, ReLU, Dropout

    # ---- transformer
    t = params["transformer"]
    if variant == "v1":
        enc_prefix, dec_prefix = "transformer.encoder_layers", "transformer.decoder_layers"
    else:
        enc_prefix, dec_prefix = "transformer.encoder.layers", "transformer.decoder.layers"
    n_enc = int(model_cfg["num_encoder_layers"])
    n_dec = int(model_cfg["num_decoder_layers"])
    for i in range(n_enc):
        t[f"enc_layers_{i}"] = _enc_layer(sd, f"{enc_prefix}.{i}", heads)
    for i in range(n_dec):
        t[f"dec_layers_{i}"] = _dec_layer(sd, f"{dec_prefix}.{i}", heads)
    if variant == "v1":
        t["out_proj"] = _linear(sd, "transformer.output_proj")
    else:
        t["enc_norm"] = _ln(sd, "transformer.encoder.norm")
        t["dec_norm"] = _ln(sd, "transformer.decoder.norm")
        if "transformer.input_projection.weight" in sd:
            t["in_proj"] = _linear(sd, "transformer.input_projection")
            t["out_proj"] = _linear(sd, "transformer.output_projection")

    # guard against silently dropping depth: any layer index in the state
    # dict beyond the configured counts means the model config is wrong
    import re

    bounds = ((r"transformer\.(?:encoder_layers|encoder\.layers)\.(\d+)\.", n_enc,
               "num_encoder_layers"),
              (r"transformer\.(?:decoder_layers|decoder\.layers)\.(\d+)\.", n_dec,
               "num_decoder_layers"),
              (r"gcae\.(?:encoder|decoder)\.layers\.(\d+)\.", None, None))
    max_gcae_seq = 0
    for k in sd:
        mm = re.match(bounds[0][0], k)
        if mm and int(mm.group(1)) >= n_enc:
            raise ValueError(f"checkpoint has encoder layer {mm.group(1)} but "
                             f"config num_encoder_layers={n_enc}")
        mm = re.match(bounds[1][0], k)
        if mm and int(mm.group(1)) >= n_dec:
            raise ValueError(f"checkpoint has decoder layer {mm.group(1)} but "
                             f"config num_decoder_layers={n_dec}")
        mm = re.match(r"gcae\.encoder\.layers\.(\d+)\.", k)
        if mm and int(mm.group(1)) >= n_layers:
            raise ValueError(f"checkpoint has GCAE block {mm.group(1)} but "
                             f"config gcae_layers={n_layers}")
        mm = re.match(r"gcae\.decoder\.layers\.(\d+)\.", k)
        if mm:
            max_gcae_seq = max(max_gcae_seq, int(mm.group(1)))
    if max_gcae_seq >= seq_idx:
        raise ValueError(f"checkpoint decoder Sequential index {max_gcae_seq} "
                         f"beyond the configured stack (expected < {seq_idx})")
    return {"params": params, "batch_stats": stats}


def _extract_state_dict(obj) -> Dict[str, Any]:
    if hasattr(obj, "keys"):
        for key in ("model_state_dict", "state_dict"):
            if key in obj:
                return obj[key]
        if all(isinstance(k, str) for k in obj.keys()):
            return obj
    raise ValueError("unrecognized checkpoint structure")


def import_shopformer_checkpoint(
    path: str,
    model_cfg: Optional[Dict[str, Any]] = None,
    variant: Optional[str] = None,
    allow_unsafe_load: bool = False,
    device: DeviceLike = None,
):
    """Load a reference torch checkpoint -> (Shopformer, variables, config):
    the port's model filled from ``variables`` (the flax-layout numpy tree),
    in eval mode on ``device`` (default: the CUDA card, raising without one).

    model_cfg: reference_model_config(...) output; when None, derived from
    the checkpoint's embedded config (v2) or reference defaults (v1 needs
    `variant='v1'` plus any non-default hyperparameters via model_cfg).

    allow_unsafe_load: checkpoints that fail `weights_only=True` need full
    unpickling, which executes arbitrary code from the file. That retry only
    happens with this explicit opt-in (cli.import_shopformer: --unsafe);
    otherwise the safe-load failure is raised.
    """
    from cvsd_tpu_torch.models.shopformer import Shopformer
    from cvsd_tpu_torch.utils.device import resolve_device, use_float32_math
    from cvsd_tpu_torch.utils.weights import load_flax_variables
    from cvsd_tpu_torch.utils.yolo_import import torch_load

    dev = resolve_device(device)  # a missing card is reported before the file is read
    obj = torch_load(path, allow_unsafe_load)
    sd = _extract_state_dict(obj)
    if model_cfg is None:
        emb = obj.get("config") if hasattr(obj, "get") else None
        m = (emb or {}).get("model", {})
        # real v2 checkpoints embed the NESTED yaml schema
        # (model.gcae.hidden_channels, model.transformer.num_heads);
        # flat keys are kept for hand-built configs and v1-style dicts
        g = m.get("gcae", {}) or {}
        t = m.get("transformer", {}) or {}
        model_cfg = reference_model_config(
            variant or m.get("variant", "v2"),
            num_keypoints=int(m.get("num_keypoints", 18 if (emb is not None) else 17)),
            seq_len=int(m.get("seq_len", 12)),
            num_tokens=int(m.get("num_tokens", 2)),
            hidden_channels=int(m.get("hidden_channels",
                                      g.get("hidden_channels", 64))),
            latent_channels=int(m.get("latent_channels",
                                      g.get("latent_channels", 8))),
            gcae_layers=int(m.get("gcae_layers", m.get(
                "gcae_num_layers", g.get("num_layers", 4)))),
            num_heads=int(m.get("num_heads", m.get(
                "nhead", t.get("num_heads", 2)))),
            num_encoder_layers=int(m.get("num_encoder_layers",
                                         t.get("num_layers", 2))),
            num_decoder_layers=int(m.get("num_decoder_layers",
                                         t.get("num_layers", 2))),
            dim_feedforward=int(m.get("dim_feedforward",
                                      t.get("dim_feedforward", 64))),
            d_model=m.get("d_model", t.get("d_model")),
        )
    variables = convert_state_dict(sd, model_cfg)
    config = {"model": dict(model_cfg)}
    use_float32_math()  # the Shopformer scores in float32
    model = load_flax_variables(Shopformer.from_config(config), variables)
    return model.to(dev).eval(), variables, config
