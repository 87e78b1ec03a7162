"""Batched letterbox + normalize on the device (PyTorch port of
``cvsd_tpu/ops/letterbox.py``).

Aspect-preserving bilinear resize to the square canvas, gray padding, and
uint8 -> [0, 1] conversion in the compute dtype. Frames are NHWC at the
public functions; the resize runs NCHW inside. ``antialias`` follows the
reference resize, which widens its triangle kernel when it downscales
(``jax.image.resize(..., "linear")``) and is a plain bilinear when it
upscales.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

PAD_VALUE = 114  # ultralytics' gray padding


def letterbox_params(src_h: int, src_w: int, size: int) -> Tuple[float, int, int, int, int]:
    """Static letterbox geometry: (scale, pad_x, pad_y, new_w, new_h)."""
    scale = min(size / src_h, size / src_w)
    new_w, new_h = int(round(src_w * scale)), int(round(src_h * scale))
    pad_x = (size - new_w) // 2
    pad_y = (size - new_h) // 2
    return scale, pad_x, pad_y, new_w, new_h


def letterbox_batch(frames: torch.Tensor, size: int = 640,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, size, size, 3) ``dtype`` in [0, 1], letterboxed."""
    B, H, W, C = frames.shape
    _scale, pad_x, pad_y, new_w, new_h = letterbox_params(H, W, size)
    x = frames.permute(0, 3, 1, 2).to(torch.float32)  # resize in f32
    if (new_h, new_w) != (H, W):
        downscale = new_h < H or new_w < W
        x = F.interpolate(x, size=(new_h, new_w), mode="bilinear", align_corners=False,
                          antialias=downscale)
    x = F.pad(x, (pad_x, size - new_w - pad_x, pad_y, size - new_h - pad_y),
              value=float(PAD_VALUE))
    return (x * (1.0 / 255.0)).to(dtype).permute(0, 2, 3, 1)


def unletterbox_boxes(boxes_xyxy: torch.Tensor, src_h: int, src_w: int, size: int) -> torch.Tensor:
    """Map xyxy boxes from letterboxed coords back to source-frame pixels."""
    scale, pad_x, pad_y, _, _ = letterbox_params(src_h, src_w, size)
    kw = dict(dtype=boxes_xyxy.dtype, device=boxes_xyxy.device)
    shift = torch.tensor([pad_x, pad_y, pad_x, pad_y], **kw)
    out = (boxes_xyxy - shift) / scale
    lim = torch.tensor([src_w, src_h, src_w, src_h], **kw)
    return torch.minimum(out.clamp(min=0), lim)
