"""Person detector: CSP backbone + SPPF + PAN neck + one of two heads at 3
scales (strides 8/16/32) — the compact anchor-free head or the ultralytics-u
DFL head (``v8dfl``) — each with the optional 17-keypoint pose branch, and
horizontal-flip test-time averaging (PyTorch port of
``cvsd_tpu/models/detector.py``).

Submodules carry the flax auto-names (``Backbone_0``, ``C3_2``,
``ConvBNAct_1``, ``Conv_0``, ``BatchNorm_0``, ...) so flax weights load
through ``utils/weights.py`` by a mechanical key map. Images are NHWC at the
public functions; the convolutions run NCHW (``channels_last`` on the card).

Precision. The reference computes in ``dtype`` (bfloat16 by default) over
float32 parameters (flax's ``dtype`` / ``param_dtype`` split). The port does
the same with explicit casts: ``PersonDetector.forward`` casts the images to
``dtype``, each ``Conv2d`` casts its float32 weight and bias to its input's
dtype at the call, and each ``FlaxBatchNorm`` (flax's train-mode BatchNorm,
momentum 0.97, eps 1e-3) reduces in float32 and returns the input's dtype.
So training (``train/detector_train.py``) keeps float32 master weights and
float32 running statistics, which Adam's small updates and the 0.97
momentum need. ``torch.autocast`` is not used: its op lists (which ops run
in float32, which in half) are not flax's. ``build_detector``, the serving
path, casts the whole module to ``dtype`` once, so the casts are no-ops
there and its outputs are those of the port before training came;
``load_detector_checkpoint`` keeps the float32 parameters, as the
reference's loader does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cvsd_tpu_torch.data.augment import flip_permutation
from cvsd_tpu_torch.models.layers import FlaxBatchNorm
from cvsd_tpu_torch.ops.nms import batched_nms, check_nms_method
from cvsd_tpu_torch.utils.device import (DeviceLike, resolve_device, torch_dtype,
                                         use_float32_math)

STRIDES = (8, 16, 32)


def _round_ch(c: float, divisor: int = 8) -> int:
    return max(divisor, int(math.ceil(c / divisor) * divisor))


class _Named(nn.Module):
    """Registers children under explicit (flax) names, in call order."""

    def _add(self, name: str, module: nn.Module) -> nn.Module:
        self.add_module(name, module)
        return module


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype: the weight and bias are cast to it
    at the call, as flax's ``Conv(dtype=...)`` casts its float32 parameters
    (a no-op where they already have that dtype)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvBNAct(nn.Module):
    """Conv (no bias) -> BatchNorm (flax's, momentum 0.97, eps 1e-3: ultralytics'
    torch momentum 0.03) -> SiLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        p = (kernel - 1) // 2  # the stem's k=6, s=2 gets p=2
        self.Conv_0 = Conv2d(cin, cout, kernel, stride, p, bias=False)
        self.BatchNorm_0 = FlaxBatchNorm(cout, momentum=0.97, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.BatchNorm_0(self.Conv_0(x)))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, shortcut: bool = True):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(cin, features, 1)
        self.ConvBNAct_1 = ConvBNAct(features, features, 3)
        self.residual = shortcut and cin == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvBNAct_1(self.ConvBNAct_0(x))
        return x + y if self.residual else y


class C3(_Named):
    """CSP block with n bottlenecks."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        c_h = features // 2
        self.n = n
        self._add("ConvBNAct_0", ConvBNAct(cin, c_h, 1))
        self._add("ConvBNAct_1", ConvBNAct(cin, c_h, 1))
        for i in range(n):
            self._add(f"Bottleneck_{i}", Bottleneck(c_h, c_h, shortcut))
        self._add("ConvBNAct_2", ConvBNAct(2 * c_h, features, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.ConvBNAct_0(x)
        b = self.ConvBNAct_1(x)
        for i in range(self.n):
            a = getattr(self, f"Bottleneck_{i}")(a)
        return self.ConvBNAct_2(torch.cat([a, b], 1))


class SPPF(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        c_h = features // 2
        self.ConvBNAct_0 = ConvBNAct(cin, c_h, 1)
        self.ConvBNAct_1 = ConvBNAct(4 * c_h, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ConvBNAct_0(x)
        p1 = F.max_pool2d(x, 5, 1, 2)  # "SAME" 5x5 / stride 1
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.ConvBNAct_1(torch.cat([x, p1, p2, p3], 1))


def _widths(width_mult: float, depth_mult: float, divisor: int):
    w = lambda c: _round_ch(c * width_mult, divisor)  # noqa: E731
    d = lambda n: max(1, round(n * depth_mult))  # noqa: E731
    return w, d


class Backbone(nn.Module):
    def __init__(self, width_mult: float = 0.75, depth_mult: float = 0.67, channel_divisor: int = 8):
        super().__init__()
        w, d = _widths(width_mult, depth_mult, channel_divisor)
        self.ConvBNAct_0 = ConvBNAct(3, w(64), 6, 2)          # /2
        self.ConvBNAct_1 = ConvBNAct(w(64), w(128), 3, 2)     # /4
        self.C3_0 = C3(w(128), w(128), d(3))
        self.ConvBNAct_2 = ConvBNAct(w(128), w(256), 3, 2)    # /8
        self.C3_1 = C3(w(256), w(256), d(6))
        self.ConvBNAct_3 = ConvBNAct(w(256), w(512), 3, 2)    # /16
        self.C3_2 = C3(w(512), w(512), d(9))
        self.ConvBNAct_4 = ConvBNAct(w(512), w(1024), 3, 2)   # /32
        self.C3_3 = C3(w(1024), w(1024), d(3))
        self.SPPF_0 = SPPF(w(1024), w(1024))

    def forward(self, x):
        x = self.C3_0(self.ConvBNAct_1(self.ConvBNAct_0(x)))
        p3 = x = self.C3_1(self.ConvBNAct_2(x))
        p4 = x = self.C3_2(self.ConvBNAct_3(x))
        x = self.C3_3(self.ConvBNAct_4(x))
        return p3, p4, self.SPPF_0(x)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample (NCHW)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class PANNeck(nn.Module):
    def __init__(self, width_mult: float = 0.75, depth_mult: float = 0.67, channel_divisor: int = 8):
        super().__init__()
        w, d = _widths(width_mult, depth_mult, channel_divisor)
        self.ConvBNAct_0 = ConvBNAct(w(1024), w(512), 1)
        self.C3_0 = C3(2 * w(512), w(512), d(3), shortcut=False)
        self.ConvBNAct_1 = ConvBNAct(w(512), w(256), 1)
        self.C3_1 = C3(2 * w(256), w(256), d(3), shortcut=False)
        self.ConvBNAct_2 = ConvBNAct(w(256), w(256), 3, 2)
        self.C3_2 = C3(2 * w(256), w(512), d(3), shortcut=False)
        self.ConvBNAct_3 = ConvBNAct(w(512), w(512), 3, 2)
        self.C3_3 = C3(2 * w(512), w(1024), d(3), shortcut=False)

    def forward(self, feats):
        p3, p4, p5 = feats
        t5 = self.ConvBNAct_0(p5)
        x = self.C3_0(torch.cat([_upsample2(t5), p4], 1))
        t4 = self.ConvBNAct_1(x)
        n3 = self.C3_1(torch.cat([_upsample2(t4), p3], 1))
        n4 = self.C3_2(torch.cat([self.ConvBNAct_2(n3), t4], 1))
        n5 = self.C3_3(torch.cat([self.ConvBNAct_3(n4), t5], 1))
        return n3, n4, n5


class DetectHead(nn.Module):
    """Decoupled anchor-free head: box (4) + objectness (1) [+ keypoints 17x3]."""

    def __init__(self, c: int, num_keypoints: int = 0):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(c, c, 3)
        self.Conv_0 = Conv2d(c, 4, 1)
        self.ConvBNAct_1 = ConvBNAct(c, c, 3)
        self.Conv_1 = Conv2d(c, 1, 1)
        self.num_keypoints = num_keypoints
        if num_keypoints:
            self.ConvBNAct_2 = ConvBNAct(c, c, 3)
            self.Conv_2 = Conv2d(c, num_keypoints * 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self.Conv_0(self.ConvBNAct_0(x)), self.Conv_1(self.ConvBNAct_1(x))]
        if self.num_keypoints:
            outs.append(self.Conv_2(self.ConvBNAct_2(x)))
        return torch.cat(outs, 1)  # (B, 5[+3K], H, W)


class V8DFLHead(nn.Module):
    """Ultralytics v8-style decoupled head: DFL box branch (4*reg_max bins) +
    class branch (nc logits) [+ the optional keypoint branch]. The branch
    widths (box_ch, cls_ch) are set from the P3 width and shared by the
    three levels, as in the Detect module of yolov5*u checkpoints."""

    def __init__(self, c: int, num_classes: int = 80, reg_max: int = 16, box_ch: int = 64,
                 cls_ch: int = 192, num_keypoints: int = 0):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(c, box_ch, 3)
        self.ConvBNAct_1 = ConvBNAct(box_ch, box_ch, 3)
        self.Conv_0 = Conv2d(box_ch, 4 * reg_max, 1)
        self.ConvBNAct_2 = ConvBNAct(c, cls_ch, 3)
        self.ConvBNAct_3 = ConvBNAct(cls_ch, cls_ch, 3)
        self.Conv_1 = Conv2d(cls_ch, num_classes, 1)
        self.num_keypoints = num_keypoints
        if num_keypoints:
            self.ConvBNAct_4 = ConvBNAct(c, c, 3)
            self.Conv_2 = Conv2d(c, num_keypoints * 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self.Conv_0(self.ConvBNAct_1(self.ConvBNAct_0(x))),
                self.Conv_1(self.ConvBNAct_3(self.ConvBNAct_2(x)))]
        if self.num_keypoints:
            outs.append(self.Conv_2(self.ConvBNAct_4(x)))
        return torch.cat(outs, 1)  # (B, 4*reg_max + nc [+3K], H, W)


class PersonDetector(nn.Module):
    """Backbone -> PAN -> heads at strides 8/16/32.

    head_variant 'anchor_free' (4 box + 1 objectness [+ keypoints]) or
    'v8dfl' (the ultralytics-u DFL head, ``num_classes`` logits).
    forward(images (B, S, S, 3) in [0, 1], NHWC) -> raw per-level maps
    {'p3', 'p4', 'p5'}, each (B, H, W, C) NHWC like the reference."""

    def __init__(self, img_size: int = 640, width_mult: float = 0.75, depth_mult: float = 0.67,
                 num_keypoints: int = 0, head_variant: str = "anchor_free",
                 num_classes: int = 80, reg_max: int = 16, channel_divisor: int = 8,
                 dtype: torch.dtype = torch.bfloat16):
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
        w, _ = _widths(width_mult, depth_mult, channel_divisor)
        self.Backbone_0 = Backbone(width_mult, depth_mult, channel_divisor)
        self.PANNeck_0 = PANNeck(width_mult, depth_mult, channel_divisor)
        widths = (w(256), w(512), w(1024))
        if head_variant == "v8dfl":
            box_ch = max(16, widths[0] // 4, 4 * reg_max)
            cls_ch = max(widths[0], min(num_classes, 100))
            self.heads = [f"V8DFLHead_{i}" for i in range(3)]
            for name, c in zip(self.heads, widths):
                self.add_module(name, V8DFLHead(c, num_classes, reg_max, box_ch, cls_ch,
                                                num_keypoints))
        else:
            self.heads = [f"DetectHead_{i}" for i in range(3)]
            for name, c in zip(self.heads, widths):
                self.add_module(name, DetectHead(c, num_keypoints))

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        feats = self.PANNeck_0(self.Backbone_0(x))
        return {level: getattr(self, head)(f).permute(0, 2, 3, 1)
                for level, head, f in zip(("p3", "p4", "p5"), self.heads, feats)}


def decode_predictions(
    raw: Dict[str, torch.Tensor], img_size: int = 640, num_keypoints: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Raw head maps -> flat (boxes_xyxy (B,A,4), scores (B,A), kpts (B,A,K,3))
    in letterboxed-pixel coordinates; anchors in row-major (H, W) order per
    level, levels p3, p4, p5 (A = 8400 at 640)."""
    boxes_all, scores_all, kpts_all = [], [], []
    for name, stride in zip(("p3", "p4", "p5"), STRIDES):
        x = raw[name].to(torch.float32)
        B, H, W, _ = x.shape
        gy = torch.arange(H, dtype=torch.float32, device=x.device)[:, None].expand(H, W)
        gx = torch.arange(W, dtype=torch.float32, device=x.device)[None, :].expand(H, W)
        tx, ty, tw, th = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
        cx = (gx + torch.sigmoid(tx)) * stride
        cy = (gy + torch.sigmoid(ty)) * stride
        w = torch.exp(tw.clamp(-4.0, 4.0)) * stride
        h = torch.exp(th.clamp(-4.0, 4.0)) * stride
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
        boxes_all.append(boxes.reshape(B, H * W, 4))
        scores_all.append(torch.sigmoid(x[..., 4]).reshape(B, H * W))
        if num_keypoints:
            k = x[..., 5 : 5 + num_keypoints * 3].reshape(B, H, W, num_keypoints, 3)
            kx = (gx[..., None] + k[..., 0] * 2.0) * stride
            ky = (gy[..., None] + k[..., 1] * 2.0) * stride
            kc = torch.sigmoid(k[..., 2])
            kpts_all.append(torch.stack([kx, ky, kc], -1).reshape(B, H * W, num_keypoints, 3))
    boxes = torch.cat(boxes_all, 1)
    scores = torch.cat(scores_all, 1)
    kpts = torch.cat(kpts_all, 1) if kpts_all else None
    return boxes, scores, kpts


def decode_predictions_v8(
    raw: Dict[str, torch.Tensor],
    num_classes: int = 80,
    reg_max: int = 16,
    num_keypoints: int = 0,
    class_idx: int = 0,  # person: the reference tracks classes=[0]
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """v8/u-head decode: DFL softmax-expectation distances -> xyxy boxes in
    letterboxed-pixel coordinates + per-anchor person score (anchor points at
    cell centres + 0.5, ltrb distances, as ultralytics' Detect). The maps are
    cast to float32 before the DFL softmax."""
    boxes_all, scores_all, kpts_all = [], [], []
    bins = None
    for name, stride in zip(("p3", "p4", "p5"), STRIDES):
        x = raw[name].to(torch.float32)
        B, H, W, _ = x.shape
        if bins is None:
            bins = torch.arange(reg_max, dtype=torch.float32, device=x.device)
        gy = torch.arange(H, dtype=torch.float32, device=x.device)[:, None].expand(H, W) + 0.5
        gx = torch.arange(W, dtype=torch.float32, device=x.device)[None, :].expand(H, W) + 0.5
        dist = x[..., : 4 * reg_max].reshape(B, H, W, 4, reg_max)
        dist = (torch.softmax(dist, dim=-1) * bins).sum(-1)  # (B, H, W, 4) ltrb
        x1 = (gx - dist[..., 0]) * stride
        y1 = (gy - dist[..., 1]) * stride
        x2 = (gx + dist[..., 2]) * stride
        y2 = (gy + dist[..., 3]) * stride
        boxes_all.append(torch.stack([x1, y1, x2, y2], -1).reshape(B, H * W, 4))
        scores_all.append(torch.sigmoid(x[..., 4 * reg_max + class_idx]).reshape(B, H * W))
        if num_keypoints:
            k = x[..., 4 * reg_max + num_classes:].reshape(B, H, W, num_keypoints, 3)
            kx = (gx[..., None] - 0.5 + k[..., 0] * 2.0) * stride
            ky = (gy[..., None] - 0.5 + k[..., 1] * 2.0) * stride
            kc = torch.sigmoid(k[..., 2])
            kpts_all.append(torch.stack([kx, ky, kc], -1).reshape(B, H * W, num_keypoints, 3))
    boxes = torch.cat(boxes_all, 1)
    scores = torch.cat(scores_all, 1)
    kpts = torch.cat(kpts_all, 1) if kpts_all else None
    return boxes, scores, kpts


def decode_raw(model: PersonDetector, raw: Dict[str, torch.Tensor]):
    """Variant-dispatching decode: raw head maps -> (boxes, scores, kpts)."""
    if model.head_variant == "v8dfl":
        return decode_predictions_v8(raw, model.num_classes, model.reg_max, model.num_keypoints)
    return decode_predictions(raw, model.img_size, model.num_keypoints)


def flip_anchor_permutation(h: int, w: int) -> np.ndarray:
    """Flat anchor permutation pairing every FPN anchor with its horizontal
    mirror: level (H, W) index y*W+x <-> y*W+(W-1-x)."""
    parts, offset = [], 0
    for stride in STRIDES:
        H, W = h // stride, w // stride
        y, x = np.mgrid[0:H, 0:W]
        parts.append(offset + (y * W + (W - 1 - x)).reshape(-1))
        offset += H * W
    return np.concatenate(parts)


def decode_with_tta(model: PersonDetector, images: torch.Tensor, tta_flip: bool = False):
    """images (B, S, S, 3) -> decoded (boxes (B,A,4), scores (B,A), kpts).
    With ``tta_flip``: one 2B forward on [images, mirrored images], then each
    anchor averaged with its mirror partner's decode (static anchor
    permutation, x -> S - x, and the COCO left/right keypoint swap)."""
    if not tta_flip:
        return decode_raw(model, model(images))
    B, S = images.shape[0], images.shape[2]
    both = torch.cat([images, images.flip(2)], 0)
    boxes2, scores2, kpts2 = decode_raw(model, model(both))
    perm = torch.from_numpy(flip_anchor_permutation(int(images.shape[1]), int(S))).to(
        boxes2.device)
    fb = boxes2[B:][:, perm]
    fb = torch.stack([S - fb[..., 2], fb[..., 1], S - fb[..., 0], fb[..., 3]], -1)
    boxes = 0.5 * (boxes2[:B] + fb)
    scores = 0.5 * (scores2[:B] + scores2[B:][:, perm])
    kpts = None
    if kpts2 is not None:
        kperm = torch.from_numpy(flip_permutation(model.num_keypoints)).to(kpts2.device)
        fk = kpts2[B:][:, perm][:, :, kperm]
        fk = torch.stack([S - fk[..., 0], fk[..., 1], fk[..., 2]], -1)
        kpts = 0.5 * (kpts2[:B] + fk)
    return boxes, scores, kpts


def make_detect_fn(model: PersonDetector, conf_thresh: float = 0.25, iou_thresh: float = 0.45,
                   max_detections: int = 128, nms_method: str = "pallas_fixpoint",
                   tta_flip: bool = False):
    """images (B, S, S, 3) -> (boxes (B,M,4) xyxy, scores (B,M), valid (B,M)
    [, kpts (B,M,17,3)]): forward (2B with ``tta_flip``), decode, top-K, the
    ``nms_method`` kernel's greedy NMS, keypoint gather."""
    check_nms_method(nms_method)

    @torch.no_grad()
    def detect(images: torch.Tensor):
        boxes, scores, kpts = decode_with_tta(model, images, tta_flip)
        out_boxes, out_scores, valid, anchor_idx = batched_nms(
            boxes, scores, conf_thresh, iou_thresh, max_detections, method=nms_method)
        if kpts is None:
            return out_boxes, out_scores, valid
        idx = anchor_idx.to(torch.int64)[..., None, None].expand(-1, -1, *kpts.shape[2:])
        return out_boxes, out_scores, valid, torch.gather(kpts, 1, idx)

    return detect


def detector_from_config(config: Dict[str, Any]) -> PersonDetector:
    """The PersonDetector ``config['detector']`` describes, its weights not
    yet filled (under ``torch.device("meta")`` it allocates nothing: a
    template for ``utils/weights.py``). With ``detector.quantized`` it is the
    int8 serving variant, ``models/detector_int8.py::QuantPersonDetector``
    (the checkpoints ``cli.quantize_detector`` writes), with the same
    attributes, so every consumer runs it unchanged."""
    d = config.get("detector", {})
    cls = PersonDetector
    if d.get("quantized"):
        from cvsd_tpu_torch.models.detector_int8 import QuantPersonDetector

        cls = QuantPersonDetector
    return cls(
        img_size=int(d.get("img_size", 640)),
        width_mult=float(d.get("width_mult", 0.75)),
        depth_mult=float(d.get("depth_mult", 0.67)),
        num_keypoints=int(d.get("num_keypoints", 17)) if d.get("pose_head") else 0,
        head_variant=str(d.get("head_variant", "anchor_free")),
        num_classes=int(d.get("num_classes", 80)),
        reg_max=int(d.get("reg_max", 16)),
        channel_divisor=int(d.get("channel_divisor", 8)),
        dtype=torch_dtype(d.get("dtype", "bfloat16")),
    )


def build_detector(config: Dict[str, Any], device: DeviceLike = None, seed: int = 0,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None) -> PersonDetector:
    """PersonDetector from ``config['detector']`` on ``device`` (default: the
    CUDA card, raising without one), eval mode, in the configured dtype.
    Weights from ``state_dict`` (see utils/weights.py) or seeded random.
    The int8 variant (``detector.quantized``) keeps its int8 weights and
    float32 scales, biases and head convs as they are (flax's dtypes) and
    starts, without weights, from flax's initial values (``w_int8`` 0,
    ``w_scale`` 1, ``bias`` 0, ``act_scale`` 1; the head convs seeded)."""
    from cvsd_tpu_torch.utils.weights import init_module

    dev = resolve_device(device)
    model = detector_from_config(config)
    dtype = model.dtype
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_module(model, seed)
    if _is_quantized(model):
        return model.to(device=dev).eval()
    model = model.to(device=dev, dtype=dtype).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def _is_quantized(model: torch.nn.Module) -> bool:
    """The int8 detector runs NHWC and holds its int8 weight in the GEMM
    layout: neither the dtype cast nor ``channels_last`` applies to it."""
    from cvsd_tpu_torch.models.detector_int8 import QuantPersonDetector

    return isinstance(model, QuantPersonDetector)


def load_detector_checkpoint(path: str, device: DeviceLike = None
                             ) -> Tuple[PersonDetector, Dict[str, Any], Dict[str, Any]]:
    """(PersonDetector, variables, meta) from a ``DetectorTrainer.save`` file
    of either package: the architecture rebuilt from the embedded
    ``config['detector']``, the weights filled strictly from the file's flax
    ``variables`` (numpy, also returned), float32 parameters computing in the
    configured dtype (see the module docstring), on ``device`` (default: the
    CUDA card, raising without one), in eval mode."""
    from cvsd_tpu_torch.utils.checkpoint import load_checkpoint
    from cvsd_tpu_torch.utils.weights import load_flax_variables

    dev = resolve_device(device)  # a missing card is reported before the file is read
    variables, meta = load_checkpoint(path)
    model = load_flax_variables(detector_from_config((meta or {}).get("config") or {}), variables)
    if model.dtype == torch.float32:
        use_float32_math()
    model = model.to(dev).eval()
    if dev.type == "cuda" and not _is_quantized(model):
        model = model.to(memory_format=torch.channels_last)
    return model, variables, meta
