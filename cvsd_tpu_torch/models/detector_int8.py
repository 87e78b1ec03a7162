"""Post-training int8 quantization of the person detector, and its
quantization-aware fine-tuning (PyTorch port of
``cvsd_tpu/models/detector_int8.py``).

- BatchNorm folding: every ConvBNAct's BatchNorm (scale, bias, running
  statistics) is folded into the conv kernel and a bias.
- Weights: symmetric int8 with one scale per output channel.
- Activations: symmetric int8 with one scale per tensor, calibrated by
  running representative batches through the model in observe mode (each
  quantized conv records the absmax of its input).
- The final 1×1 head convs (``kernel``, ``bias``) stay floating point.

The modules mirror ``models/detector.py`` under the same flax names
(``Backbone_0``, ``C3_2``, ``ConvBNAct_1``, ``Conv_0``, ...), so the weight
bridge (``utils/weights.py``) maps the int8 tree leaf for leaf. A serving
``ConvBNAct`` holds ``w_int8`` (int8, kept in the GEMM layout (Cout,
k·k·Cin) the card route reads, HWIO in the flax tree), ``w_scale`` (Cout,),
``bias`` (Cout,) and ``act_scale`` (), all float32 but the weight; a QAT
one (``qat=True``) holds ``w`` (HWIO, float32, trainable), ``bias`` and the
frozen ``act_scale``. No float leaf is cast to the compute dtype: flax keeps
them float32.

The serving forward of a ConvBNAct is the reference's arithmetic:
``round(x_f32 / act_scale)`` clipped to ±127 as int8, an int8 × int8
convolution accumulated in int32 (``ops/int8_conv.py``: im2col and
``torch._int_mm`` on the card, float64 ``conv2d`` on the CPU), then
``acc * (act_scale * w_scale) + bias``, SiLU, cast to ``dtype``. The model
runs NHWC throughout (the int8 GEMM's natural layout) and takes the images
as given: the first conv quantizes them from float32.

``QuantPersonDetector`` has the attributes ``make_detect_fn``,
``decode_raw``, ``decode_with_tta`` and ``DetectionPipeline`` read, so they
run on it unchanged, flip-TTA and the v8dfl head included.

The folding and the weight quantization are numpy on the flax (HWIO)
arrays, copied from the reference, so ``w_int8``, ``w_scale`` and ``bias``
equal the JAX package's bit for bit. ``calibrate``, ``quantize_detector``
and ``prepare_qat`` run on the device of the float model they are given.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cvsd_tpu_torch.models.detector import Conv2d, PersonDetector, _Named, _widths
from cvsd_tpu_torch.ops.int8_conv import int8_conv
from cvsd_tpu_torch.utils.device import use_float32_math
from cvsd_tpu_torch.utils.weights import load_flax_variables

_BN_EPS = 1e-3  # matches models.detector.ConvBNAct


def _conv_nhwc(x: torch.Tensor, w_oihw: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    return F.conv2d(x.permute(0, 3, 1, 2), w_oihw, None, stride, pad).permute(0, 2, 3, 1)


def _nchw(fn, x: torch.Tensor) -> torch.Tensor:
    """An NCHW op applied to an NHWC tensor."""
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return _nchw(partial(F.interpolate, scale_factor=2, mode="nearest"), x)


def _pool(x: torch.Tensor) -> torch.Tensor:
    return _nchw(partial(F.max_pool2d, kernel_size=5, stride=1, padding=2), x)  # "SAME"


class ConvBNAct(nn.Module):
    """int8 conv + folded-BN bias + SiLU (serving), or its fake-quant mirror
    (``qat``). ``forward(x, observe)``: observe runs the conv in float32 with
    the dequantized weights and records the input's absmax in ``absmax``."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16, qat: bool = False):
        super().__init__()
        self.cin, self.features, self.kernel, self.stride = cin, features, kernel, stride
        self.dtype, self.qat = dtype, qat
        if qat:
            self.w = nn.Parameter(torch.zeros(kernel, kernel, cin, features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_buffer("w_int8", torch.zeros(features, kernel * kernel * cin,
                                                       dtype=torch.int8))
            self.register_buffer("w_scale", torch.ones(features))
            self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("act_scale", torch.ones(()))
        self.absmax: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor, observe: bool = False) -> torch.Tensor:
        k, s = self.kernel, self.stride
        p = (k - 1) // 2
        if self.qat:
            w = self.w
            s_w = torch.clamp(w.detach().abs().amax(dim=(0, 1, 2)) / 127.0, min=1e-12)
            wq = w + (torch.clamp(torch.round(w / s_w), -127.0, 127.0) * s_w - w).detach()
            xf = x.to(torch.float32)
            a = self.act_scale  # a buffer: the calibrated range stays frozen
            xq = xf + (torch.clamp(torch.round(xf / a), -127.0, 127.0) * a - xf).detach()
            y = _conv_nhwc(xq, wq.permute(3, 2, 0, 1), s, p) + self.bias
            return F.silu(y).to(self.dtype)
        if observe:
            xf = x.to(torch.float32)
            self.absmax = xf.abs().amax()
            w_f = (self.w_int8.to(torch.float32) * self.w_scale[:, None]).reshape(
                self.features, k, k, self.cin).permute(0, 3, 1, 2)
            y = _conv_nhwc(xf, w_f, s, p) + self.bias
        else:
            xq = torch.clamp(torch.round(x.to(torch.float32) / self.act_scale),
                             -127.0, 127.0).to(torch.int8)
            acc = int8_conv(xq, self.w_int8, k, s)
            y = acc.to(torch.float32) * (self.act_scale * self.w_scale) + self.bias
        return F.silu(y).to(self.dtype)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, shortcut: bool = True, **q):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(cin, features, 1, **q)
        self.ConvBNAct_1 = ConvBNAct(features, features, 3, **q)
        self.residual = shortcut and cin == features

    def forward(self, x, observe=False):
        y = self.ConvBNAct_1(self.ConvBNAct_0(x, observe), observe)
        return x + y if self.residual else y


class C3(_Named):
    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = True, **q):
        super().__init__()
        c_h = features // 2
        self.n = n
        self._add("ConvBNAct_0", ConvBNAct(cin, c_h, 1, **q))
        self._add("ConvBNAct_1", ConvBNAct(cin, c_h, 1, **q))
        for i in range(n):
            self._add(f"Bottleneck_{i}", Bottleneck(c_h, c_h, shortcut, **q))
        self._add("ConvBNAct_2", ConvBNAct(2 * c_h, features, 1, **q))

    def forward(self, x, observe=False):
        a = self.ConvBNAct_0(x, observe)
        b = self.ConvBNAct_1(x, observe)
        for i in range(self.n):
            a = getattr(self, f"Bottleneck_{i}")(a, observe)
        return self.ConvBNAct_2(torch.cat([a, b], -1), observe)


class SPPF(nn.Module):
    def __init__(self, cin: int, features: int, **q):
        super().__init__()
        c_h = features // 2
        self.ConvBNAct_0 = ConvBNAct(cin, c_h, 1, **q)
        self.ConvBNAct_1 = ConvBNAct(4 * c_h, features, 1, **q)

    def forward(self, x, observe=False):
        x = self.ConvBNAct_0(x, observe)
        p1 = _pool(x)
        p2 = _pool(p1)
        p3 = _pool(p2)
        return self.ConvBNAct_1(torch.cat([x, p1, p2, p3], -1), observe)


class Backbone(nn.Module):
    def __init__(self, width_mult: float = 0.75, depth_mult: float = 0.67,
                 channel_divisor: int = 8, **q):
        super().__init__()
        w, d = _widths(width_mult, depth_mult, channel_divisor)
        self.ConvBNAct_0 = ConvBNAct(3, w(64), 6, 2, **q)
        self.ConvBNAct_1 = ConvBNAct(w(64), w(128), 3, 2, **q)
        self.C3_0 = C3(w(128), w(128), d(3), **q)
        self.ConvBNAct_2 = ConvBNAct(w(128), w(256), 3, 2, **q)
        self.C3_1 = C3(w(256), w(256), d(6), **q)
        self.ConvBNAct_3 = ConvBNAct(w(256), w(512), 3, 2, **q)
        self.C3_2 = C3(w(512), w(512), d(9), **q)
        self.ConvBNAct_4 = ConvBNAct(w(512), w(1024), 3, 2, **q)
        self.C3_3 = C3(w(1024), w(1024), d(3), **q)
        self.SPPF_0 = SPPF(w(1024), w(1024), **q)

    def forward(self, x, observe=False):
        x = self.C3_0(self.ConvBNAct_1(self.ConvBNAct_0(x, observe), observe), observe)
        p3 = x = self.C3_1(self.ConvBNAct_2(x, observe), observe)
        p4 = x = self.C3_2(self.ConvBNAct_3(x, observe), observe)
        x = self.C3_3(self.ConvBNAct_4(x, observe), observe)
        return p3, p4, self.SPPF_0(x, observe)


class PANNeck(nn.Module):
    def __init__(self, width_mult: float = 0.75, depth_mult: float = 0.67,
                 channel_divisor: int = 8, **q):
        super().__init__()
        w, d = _widths(width_mult, depth_mult, channel_divisor)
        self.ConvBNAct_0 = ConvBNAct(w(1024), w(512), 1, **q)
        self.C3_0 = C3(2 * w(512), w(512), d(3), shortcut=False, **q)
        self.ConvBNAct_1 = ConvBNAct(w(512), w(256), 1, **q)
        self.C3_1 = C3(2 * w(256), w(256), d(3), shortcut=False, **q)
        self.ConvBNAct_2 = ConvBNAct(w(256), w(256), 3, 2, **q)
        self.C3_2 = C3(2 * w(256), w(512), d(3), shortcut=False, **q)
        self.ConvBNAct_3 = ConvBNAct(w(512), w(512), 3, 2, **q)
        self.C3_3 = C3(2 * w(512), w(1024), d(3), shortcut=False, **q)

    def forward(self, feats, observe=False):
        p3, p4, p5 = feats
        t5 = self.ConvBNAct_0(p5, observe)
        x = self.C3_0(torch.cat([_upsample2(t5), p4], -1), observe)
        t4 = self.ConvBNAct_1(x, observe)
        n3 = self.C3_1(torch.cat([_upsample2(t4), p3], -1), observe)
        n4 = self.C3_2(torch.cat([self.ConvBNAct_2(n3, observe), t4], -1), observe)
        n5 = self.C3_3(torch.cat([self.ConvBNAct_3(n4, observe), t5], -1), observe)
        return n3, n4, n5


class DetectHead(nn.Module):
    def __init__(self, c: int, num_keypoints: int = 0, **q):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(c, c, 3, **q)
        self.Conv_0 = Conv2d(c, 4, 1)
        self.ConvBNAct_1 = ConvBNAct(c, c, 3, **q)
        self.Conv_1 = Conv2d(c, 1, 1)
        self.num_keypoints = num_keypoints
        if num_keypoints:
            self.ConvBNAct_2 = ConvBNAct(c, c, 3, **q)
            self.Conv_2 = Conv2d(c, num_keypoints * 3, 1)

    def forward(self, x, observe=False):
        outs = [_nchw(self.Conv_0, self.ConvBNAct_0(x, observe)),
                _nchw(self.Conv_1, self.ConvBNAct_1(x, observe))]
        if self.num_keypoints:
            outs.append(_nchw(self.Conv_2, self.ConvBNAct_2(x, observe)))
        return torch.cat(outs, -1)


class V8DFLHead(nn.Module):
    def __init__(self, c: int, num_classes: int = 80, reg_max: int = 16, box_ch: int = 64,
                 cls_ch: int = 192, num_keypoints: int = 0, **q):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(c, box_ch, 3, **q)
        self.ConvBNAct_1 = ConvBNAct(box_ch, box_ch, 3, **q)
        self.Conv_0 = Conv2d(box_ch, 4 * reg_max, 1)
        self.ConvBNAct_2 = ConvBNAct(c, cls_ch, 3, **q)
        self.ConvBNAct_3 = ConvBNAct(cls_ch, cls_ch, 3, **q)
        self.Conv_1 = Conv2d(cls_ch, num_classes, 1)
        self.num_keypoints = num_keypoints
        if num_keypoints:
            self.ConvBNAct_4 = ConvBNAct(c, c, 3, **q)
            self.Conv_2 = Conv2d(c, num_keypoints * 3, 1)

    def forward(self, x, observe=False):
        b = self.ConvBNAct_1(self.ConvBNAct_0(x, observe), observe)
        s = self.ConvBNAct_3(self.ConvBNAct_2(x, observe), observe)
        outs = [_nchw(self.Conv_0, b), _nchw(self.Conv_1, s)]
        if self.num_keypoints:
            outs.append(_nchw(self.Conv_2, self.ConvBNAct_4(x, observe)))
        return torch.cat(outs, -1)


class QuantPersonDetector(nn.Module):
    """int8 mirror of PersonDetector: the same attributes and
    ``forward(images (B, S, S, 3) NHWC) -> {'p3', 'p4', 'p5'}`` NHWC maps.
    ``forward(images, observe=True)`` returns ``(maps, {"quant_stats":
    tree})``, the tree mirroring the module tree down to each ConvBNAct's
    ``{"absmax": ()}``, as the reference's ``quant_stats`` collection."""

    def __init__(self, img_size: int = 640, width_mult: float = 0.75,
                 depth_mult: float = 0.67, num_keypoints: int = 0,
                 head_variant: str = "anchor_free", num_classes: int = 80, reg_max: int = 16,
                 channel_divisor: int = 8, dtype: torch.dtype = torch.bfloat16,
                 qat: bool = False):
        super().__init__()
        if head_variant not in ("anchor_free", "v8dfl"):
            raise ValueError(f"unknown head_variant {head_variant!r}")
        self.img_size = img_size
        self.width_mult = width_mult
        self.depth_mult = depth_mult
        self.channel_divisor = channel_divisor
        self.num_keypoints = num_keypoints
        self.head_variant = head_variant
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.dtype = dtype
        self.qat = qat
        q = {"dtype": dtype, "qat": qat}
        w, _ = _widths(width_mult, depth_mult, channel_divisor)
        self.Backbone_0 = Backbone(width_mult, depth_mult, channel_divisor, **q)
        self.PANNeck_0 = PANNeck(width_mult, depth_mult, channel_divisor, **q)
        widths = (w(256), w(512), w(1024))
        if head_variant == "v8dfl":
            box_ch = max(16, widths[0] // 4, 4 * reg_max)
            cls_ch = max(widths[0], min(num_classes, 100))
            self.heads = [f"V8DFLHead_{i}" for i in range(3)]
            for name, c in zip(self.heads, widths):
                self.add_module(name, V8DFLHead(c, num_classes, reg_max, box_ch, cls_ch,
                                                num_keypoints, **q))
        else:
            self.heads = [f"DetectHead_{i}" for i in range(3)]
            for name, c in zip(self.heads, widths):
                self.add_module(name, DetectHead(c, num_keypoints, **q))

    def forward(self, images: torch.Tensor, observe: bool = False):
        feats = self.PANNeck_0(self.Backbone_0(images, observe), observe)
        raw = {level: getattr(self, head)(f, observe)
               for level, head, f in zip(("p3", "p4", "p5"), self.heads, feats)}
        if not observe:
            return raw
        stats: Dict[str, Any] = {}
        for name, m in self.named_modules():
            if isinstance(m, ConvBNAct) and m.absmax is not None:
                node = stats
                for part in name.split("."):
                    node = node.setdefault(part, {})
                node["absmax"] = m.absmax
                m.absmax = None
        return raw, {"quant_stats": stats}


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _like(model: PersonDetector, qat: bool) -> QuantPersonDetector:
    return QuantPersonDetector(
        img_size=model.img_size, width_mult=model.width_mult, depth_mult=model.depth_mult,
        num_keypoints=model.num_keypoints, head_variant=model.head_variant,
        num_classes=model.num_classes, reg_max=model.reg_max,
        channel_divisor=model.channel_divisor, dtype=model.dtype, qat=qat,
    ).to(_device_of(model))


def quant_model_like(model: PersonDetector) -> QuantPersonDetector:
    """The int8 mirror with the same hyperparameters, on the model's device,
    holding flax's initial values (``w_int8`` 0, ``w_scale`` 1, ``bias`` 0,
    ``act_scale`` 1) until variables are loaded."""
    return _like(model, qat=False).eval()


def _fold_conv_bn(conv_kernel, bn_scale, bn_bias, bn_mean, bn_var):
    """Fold BN(y) = gamma*(y-mean)/sqrt(var+eps) + beta into the conv:
    W' = W * gamma/sqrt(var+eps) (per out channel), b' = beta - mean*g."""
    g = np.asarray(bn_scale, np.float32) / np.sqrt(
        np.asarray(bn_var, np.float32) + _BN_EPS)
    w = np.asarray(conv_kernel, np.float32) * g  # broadcasts over last dim
    b = np.asarray(bn_bias, np.float32) - np.asarray(bn_mean, np.float32) * g
    return w, b


def _quantize_weight(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8: scale[c] = absmax[...,c]/127."""
    absmax = np.max(np.abs(w), axis=(0, 1, 2))
    scale = np.maximum(absmax / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def _is_conv_bn(p: Mapping[str, Any]) -> bool:
    return set(p.keys()) == {"Conv_0", "BatchNorm_0"}  # a ConvBNAct scope


def _fold_scope(p: Mapping[str, Any], bs: Mapping[str, Any]):
    return _fold_conv_bn(p["Conv_0"]["kernel"], p["BatchNorm_0"]["scale"],
                         p["BatchNorm_0"]["bias"], bs["BatchNorm_0"]["mean"],
                         bs["BatchNorm_0"]["var"])


def convert_variables(variables: Mapping[str, Any]) -> Dict[str, Any]:
    """PersonDetector variables (params + batch_stats, numpy) ->
    QuantPersonDetector variables: every {Conv_0, BatchNorm_0} pair becomes
    {w_int8, w_scale, bias, act_scale=1}; plain head convs pass through.
    Activation scales start at 1.0: run ``calibrate`` before inference."""

    def walk(p, bs):
        if _is_conv_bn(p):
            w, b = _fold_scope(p, bs)
            w_int8, w_scale = _quantize_weight(w)
            return {"w_int8": w_int8, "w_scale": w_scale, "bias": b,
                    "act_scale": np.ones((), np.float32)}
        return {k: (walk(v, bs.get(k, {})) if isinstance(v, Mapping) else v)
                for k, v in p.items()}

    return {"params": walk(variables["params"], variables.get("batch_stats", {}))}


@torch.no_grad()
def calibrate(qmodel: QuantPersonDetector, qvariables: Mapping[str, Any],
              batches: Iterable[np.ndarray], margin: float = 1.0) -> Dict[str, Any]:
    """Set every act_scale from the observed input absmax over the
    calibration batches (letterboxed images, (B, S, S, 3) in [0, 1]);
    ``margin`` scales the range (1.0 = exact absmax clipping). Runs on
    ``qmodel``'s device in float32 (TF32 off) and leaves ``qmodel`` holding
    the returned variables."""
    use_float32_math()
    load_flax_variables(qmodel, qvariables)
    dev = next(qmodel.buffers()).device
    acc: Optional[Dict[str, Any]] = None

    def merge(a, b):
        return {k: (merge(v, b[k]) if isinstance(v, dict) else np.maximum(v, b[k]))
                for k, v in a.items()}

    def to_host(t):
        return {k: (to_host(v) if isinstance(v, dict) else v.cpu().numpy()) for k, v in t.items()}

    for batch in batches:
        _, stats = qmodel(torch.as_tensor(np.asarray(batch)).to(dev), observe=True)
        stats = to_host(stats["quant_stats"])
        acc = stats if acc is None else merge(acc, stats)
    if acc is None:
        raise ValueError("calibrate: no batches given")

    def write(p, s):
        if "act_scale" in p and not isinstance(p["act_scale"], Mapping):
            absmax = float(np.asarray(s["absmax"]))
            out = dict(p)
            out["act_scale"] = np.asarray(max(absmax * margin / 127.0, 1e-12), np.float32)
            return out
        return {k: (write(v, s[k]) if isinstance(v, Mapping) and k in s else v)
                for k, v in p.items()}

    out = {"params": write(qvariables["params"], acc)}
    load_flax_variables(qmodel, out)
    return out


def quantize_detector(model: PersonDetector, variables: Mapping[str, Any],
                      calibration_batches: Iterable[np.ndarray], margin: float = 1.0
                      ) -> Tuple[QuantPersonDetector, Dict[str, Any]]:
    """One-call PTQ: fold BN, quantize weights per channel, calibrate the
    activation scales. Returns (qmodel holding qvariables on the model's
    device, qvariables), ready for ``models.detector.make_detect_fn``."""
    qmodel = quant_model_like(model)
    qvars = calibrate(qmodel, convert_variables(variables), calibration_batches, margin=margin)
    return qmodel, qvars


# ---------------------------------------------------------------------------
# quantization-aware fine-tuning (QAT)


def qat_model_like(model: PersonDetector) -> QuantPersonDetector:
    """The fake-quant (QAT) mirror with the same hyperparameters, on the
    model's device."""
    return _like(model, qat=True)


def _fold_to_float(variables: Mapping[str, Any]) -> Dict[str, Any]:
    """PersonDetector variables -> QAT variables: every ConvBNAct becomes
    {w (float, BN-folded), bias, act_scale=1}; head convs pass through."""

    def walk(p, bs):
        if _is_conv_bn(p):
            w, b = _fold_scope(p, bs)
            return {"w": w, "bias": b, "act_scale": np.ones((), np.float32)}
        return {k: (walk(v, bs.get(k, {})) if isinstance(v, Mapping) else v)
                for k, v in p.items()}

    return {"params": walk(variables["params"], variables.get("batch_stats", {}))}


def _graft_act_scales(qat_params: Mapping[str, Any], src_params: Mapping[str, Any]):
    """Copy calibrated act_scale leaves from a PTQ tree into a QAT tree."""
    out = {}
    for k, v in qat_params.items():
        if k == "act_scale" and not isinstance(v, Mapping):
            out[k] = src_params["act_scale"]
        elif isinstance(v, Mapping):
            out[k] = _graft_act_scales(v, src_params[k])
        else:
            out[k] = v
    return out


def prepare_qat(model: PersonDetector, variables: Mapping[str, Any],
                calibration_batches: Iterable[np.ndarray], margin: float = 1.0
                ) -> Tuple[QuantPersonDetector, Dict[str, Any]]:
    """Float checkpoint -> (qat_model, qat_variables) ready for fine-tuning
    (``train/qat.py``): BN folded into trainable float kernels, activation
    scales calibrated (by the PTQ observe pass) and frozen. ``qat_model``
    holds the variables, on the model's device."""
    calibrated = calibrate(quant_model_like(model), convert_variables(variables),
                           calibration_batches, margin=margin)
    qat_vars = {"params": _graft_act_scales(_fold_to_float(variables)["params"],
                                            calibrated["params"])}
    return load_flax_variables(qat_model_like(model), qat_vars), qat_vars


def finalize_qat(qat_variables: Mapping[str, Any]) -> Dict[str, Any]:
    """QAT variables (after fine-tuning) -> serving int8 variables: the
    serving forward computes (round(x/a)*a) . (w_int8*w_scale) + bias, the
    fake-quant forward's arithmetic at the final weights."""

    def walk(p):
        if set(p.keys()) == {"w", "bias", "act_scale"}:
            w_int8, w_scale = _quantize_weight(np.asarray(p["w"], np.float32))
            return {"w_int8": w_int8, "w_scale": w_scale,
                    "bias": p["bias"], "act_scale": p["act_scale"]}
        return {k: (walk(v) if isinstance(v, Mapping) else v) for k, v in p.items()}

    return {"params": walk(qat_variables["params"])}
