"""Box geometry: format conversions and batched IoU (PyTorch port of
``cvsd_tpu/ops/iou.py``; same operation order, so float32 results match)."""

from __future__ import annotations

import torch


def xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2), any leading dims."""
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def xyxy_to_xywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def xyxy_to_xywhn(b: torch.Tensor, img_w: float, img_h: float) -> torch.Tensor:
    """xyxy pixels -> normalized (cx, cy, w, h), ultralytics' box.xywhn."""
    scale = torch.tensor([img_w, img_h, img_w, img_h], dtype=b.dtype, device=b.device)
    return xyxy_to_xywh(b) / scale


def box_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between (..., N, 4) and (..., M, 4) xyxy boxes -> (..., N, M)."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-9)
