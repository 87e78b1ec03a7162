"""Top-down pose estimation: person crop -> heatmaps -> soft-argmax keypoints
(PyTorch port of ``cvsd_tpu/models/pose_topdown.py``).

- ``crop_and_resize``: static-shape bilinear crops of padded boxes, batched
  over (B, M) boxes by index arithmetic (no Python loop).
- ``TopDownPoseNet``: a small conv net on the crops -> per-joint heatmaps.
- ``soft_argmax``: heatmap logits -> sub-pixel keypoints and confidences.
- ``pose_from_boxes``: frames + boxes -> keypoints in frame pixels.

Submodules carry the flax auto-names (``Conv_0..6``, ``BatchNorm_0..5``),
so flax weights load through ``utils/weights.py``. Crops and heatmaps are
NHWC at the public functions, like the reference's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvsd_tpu_torch.models.layers import FlaxBatchNorm
from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device, use_float32_math


def crop_and_resize(images: torch.Tensor, boxes: torch.Tensor, out_size: int,
                    pad_frac: float = 0.25) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bilinear-resample each padded box region to (out_size, out_size).
    images (B, H, W, C) float, boxes (B, M, 4) xyxy pixels -> (crops
    (B, M, S, S, C), origin (B, M, 2), scale (B, M, 2)) with
    frame_xy = origin + crop_xy * scale. Degenerate boxes are clamped to
    >= 1 px; samples outside the frame take the nearest edge pixel. Each
    crop pixel is weighted in the reference's order (rows, then columns)."""
    x1, y1, x2, y2 = boxes.unbind(-1)  # (B, M)
    w = torch.clamp(x2 - x1, min=1.0)
    h = torch.clamp(y2 - y1, min=1.0)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    w, h = w * (1 + pad_frac), h * (1 + pad_frac)
    ox, oy = cx - w / 2, cy - h / 2
    sx, sy = w / out_size, h / out_size
    # sample grid: crop pixel (i, j) -> frame (ox + (j+0.5)*sx, oy + (i+0.5)*sy)
    grid = torch.arange(out_size, dtype=torch.float32, device=images.device) + 0.5
    jj = grid * sx[..., None] + ox[..., None] - 0.5  # (B, M, S)
    ii = grid * sy[..., None] + oy[..., None] - 0.5
    H, W = images.shape[1], images.shape[2]
    j0 = torch.floor(jj).to(torch.int64).clamp(0, W - 1)
    i0 = torch.floor(ii).to(torch.int64).clamp(0, H - 1)
    j1 = (j0 + 1).clamp(0, W - 1)
    i1 = (i0 + 1).clamp(0, H - 1)
    fj = (jj - j0).clamp(0.0, 1.0)[..., None, :, None]  # (B, M, 1, S, 1)
    fi = (ii - i0).clamp(0.0, 1.0)[..., :, None, None]  # (B, M, S, 1, 1)
    b = torch.arange(images.shape[0], device=images.device)[:, None, None, None]
    r0, r1 = i0[..., :, None], i1[..., :, None]  # (B, M, S, 1)
    c0, c1 = j0[..., None, :], j1[..., None, :]  # (B, M, 1, S)
    left = images[b, r0, c0] * (1 - fi) + images[b, r1, c0] * fi
    right = images[b, r0, c1] * (1 - fi) + images[b, r1, c1] * fi
    crops = left * (1 - fj) + right * fj
    return crops, torch.stack([ox, oy], -1), torch.stack([sx, sy], -1)


def soft_argmax(heatmaps: torch.Tensor, temperature: float = 1.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., Hh, Wh, K) logits -> (coords (..., K, 2) in [0,1] heatmap space,
    conf (..., K) = peak softmax probability)."""
    *lead, Hh, Wh, K = heatmaps.shape
    flat = heatmaps.reshape(*lead, Hh * Wh, K) / temperature
    prob = torch.softmax(flat, dim=-2)
    xs = (torch.arange(Wh, dtype=torch.float32, device=heatmaps.device) + 0.5) / Wh
    ys = (torch.arange(Hh, dtype=torch.float32, device=heatmaps.device) + 0.5) / Hh
    cx = torch.einsum("...ak,a->...k", prob, xs.repeat(Hh))
    cy = torch.einsum("...ak,a->...k", prob, ys.repeat_interleave(Wh))
    return torch.stack([cx, cy], -1), prob.amax(dim=-2)


def _pad_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """XLA's 'SAME' padding for an NCHW input: the total pad splits with the
    smaller half first, so a stride-2, k=3 conv on an even size pads (0, 1)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: last dim first
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class TopDownPoseNet(nn.Module):
    """Small conv net: (N, S, S, 3) crops -> (N, S/4, S/4, K) heatmap logits,
    float32. Six 3x3 conv -> BatchNorm (flax's, momentum 0.97, eps 1e-3) ->
    SiLU layers (two of stride 2) and a 1x1 conv to the K joints."""

    def __init__(self, num_keypoints: int = 17, width: int = 32, crop_size: int = 64,
                 temperature: float = 1.0):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.width = width
        self.crop_size = crop_size
        self.temperature = temperature
        w = width
        layers = ((3, w, 1), (w, 2 * w, 2), (2 * w, 2 * w, 1), (2 * w, 4 * w, 2),
                  (4 * w, 4 * w, 1), (4 * w, 4 * w, 1))
        self.strides = tuple(s for _, _, s in layers)
        for i, (cin, cout, stride) in enumerate(layers):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, cout, 3, stride, 0, bias=False))
            self.add_module(f"BatchNorm_{i}", FlaxBatchNorm(cout, momentum=0.97, eps=1e-3))
        self.Conv_6 = nn.Conv2d(4 * w, num_keypoints, 1)

    def forward(self, crops: torch.Tensor) -> torch.Tensor:
        x = crops.permute(0, 3, 1, 2).to(torch.float32)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        for i, stride in enumerate(self.strides):
            conv, bn = getattr(self, f"Conv_{i}"), getattr(self, f"BatchNorm_{i}")
            x = F.silu(bn(conv(_pad_same(x, 3, stride))))
        return self.Conv_6(x).permute(0, 2, 3, 1)


def pose_from_boxes(model: TopDownPoseNet, images: torch.Tensor, boxes: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched top-down pose: crops all B*M boxes, one pose-net forward, maps
    soft-argmax coords back to frame pixels. images (B, H, W, 3) float in
    [0, 1], boxes (B, M, 4) xyxy px. Returns (kpts (B, M, K, 3)
    [x_px, y_px, conf], crops (B, M, S, S, 3))."""
    B, M = boxes.shape[0], boxes.shape[1]
    S = model.crop_size
    crops, origins, scales = crop_and_resize(images, boxes, S)
    with torch.no_grad():
        heat = model(crops.reshape(B * M, S, S, crops.shape[-1]))
    coords, conf = soft_argmax(heat, model.temperature)  # (B*M, K, 2), (B*M, K)
    coords = coords.reshape(B, M, -1, 2)
    conf = conf.reshape(B, M, -1)
    # crop [0,1] -> frame px: origin + coord * S * scale
    frame_xy = origins[:, :, None, :] + coords * (S * scales[:, :, None, :])
    return torch.cat([frame_xy, conf[..., None]], -1), crops


def build_pose_topdown(config: Dict[str, Any], device: DeviceLike = None, seed: int = 0,
                       state_dict: Optional[Dict[str, torch.Tensor]] = None) -> TopDownPoseNet:
    """TopDownPoseNet from ``config['detector']['pose_topdown']`` on
    ``device`` (default: the CUDA card, raising without one), eval mode,
    float32. Weights from ``state_dict`` or seeded random."""
    from cvsd_tpu_torch.utils.weights import init_module

    dev = resolve_device(device)
    use_float32_math()  # the pose net runs in float32
    td = (config.get("detector", {}) or {}).get("pose_topdown") or {}
    model = TopDownPoseNet(num_keypoints=int(td.get("num_keypoints", 17)),
                           width=int(td.get("width", 32)),
                           crop_size=int(td.get("crop_size", 64)))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_module(model, seed)
    return _place(model, dev)


def _place(model: TopDownPoseNet, dev: torch.device) -> TopDownPoseNet:
    model = model.to(dev).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def load_pose_topdown_checkpoint(path: str, device: DeviceLike = None) -> TopDownPoseNet:
    """The TopDownPoseNet of a ``TopDownPoseTrainer.save`` file (the JAX
    package's trainer), carrying its weights, on ``device`` (default: the
    CUDA card, raising without one). Its shape and temperature come from the
    checkpoint's ``config['pose_topdown']``."""
    from cvsd_tpu_torch.utils.checkpoint import load_checkpoint
    from cvsd_tpu_torch.utils.weights import load_flax_variables

    dev = resolve_device(device)
    use_float32_math()
    variables, meta = load_checkpoint(path)
    cfg = ((meta or {}).get("config") or {}).get("pose_topdown") or {}
    model = TopDownPoseNet(num_keypoints=int(cfg.get("num_keypoints", 17)),
                           width=int(cfg.get("width", 32)),
                           crop_size=int(cfg.get("crop_size", 64)),
                           temperature=float(cfg.get("temperature", 1.0)))
    return _place(load_flax_variables(model, variables), dev)

