"""Operation and byte counts from a configuration's published shapes, and
the card's published peaks.

FLOPs count the convolutions alone, as two operations a multiply-add
(ultralytics' GFLOPs are the same count: thop's multiply-adds times two),
so they are the same whatever implements the layers. BatchNorm, SiLU,
pooling, upsampling, decode and NMS, a few operations an element each,
are left out."""

from __future__ import annotations

import math
import subprocess
from typing import Dict, Optional, Tuple

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def _round_ch(c: float, divisor: int = 8) -> int:
    return max(divisor, int(math.ceil(c / divisor) * divisor))


class _Count:
    def __init__(self):
        self.flops = 0

    def conv(self, cin: int, cout: int, k: int, s: int, hw: Tuple[int, int],
             pad: int) -> Tuple[int, int]:
        h = (hw[0] + 2 * pad - k) // s + 1
        w = (hw[1] + 2 * pad - k) // s + 1
        self.flops += 2 * cin * cout * k * k * h * w
        return h, w

    def cba(self, cin, cout, k, s, hw):
        return self.conv(cin, cout, k, s, hw, (k - 1) // 2)

    def c3(self, cin, f, n, hw):
        h_ = f // 2
        self.cba(cin, h_, 1, 1, hw)
        self.cba(cin, h_, 1, 1, hw)
        for _ in range(n):
            self.cba(h_, h_, 1, 1, hw)
            self.cba(h_, h_, 3, 1, hw)
        self.cba(2 * h_, f, 1, 1, hw)
        return hw


def detector_flops(det: Dict) -> int:
    """Convolution FLOPs of one forward of one image at ``img_size``."""
    wm, dm = float(det["width_mult"]), float(det["depth_mult"])
    div = int(det.get("channel_divisor", 8))
    w = lambda c: _round_ch(c * wm, div)  # noqa: E731
    d = lambda n: max(1, round(n * dm))  # noqa: E731
    S = int(det["img_size"])
    c = _Count()
    hw = c.cba(3, w(64), 6, 2, (S, S))
    hw = c.cba(w(64), w(128), 3, 2, hw)
    c.c3(w(128), w(128), d(3), hw)
    hw3 = hw = c.cba(w(128), w(256), 3, 2, hw)
    c.c3(w(256), w(256), d(6), hw)
    hw4 = hw = c.cba(w(256), w(512), 3, 2, hw)
    c.c3(w(512), w(512), d(9), hw)
    hw5 = hw = c.cba(w(512), w(1024), 3, 2, hw)
    c.c3(w(1024), w(1024), d(3), hw)
    c.cba(w(1024), w(1024) // 2, 1, 1, hw)  # SPPF
    c.cba(2 * w(1024), w(1024), 1, 1, hw)
    c.cba(w(1024), w(512), 1, 1, hw5)  # PAN
    c.c3(2 * w(512), w(512), d(3), hw4)
    c.cba(w(512), w(256), 1, 1, hw4)
    c.c3(2 * w(256), w(256), d(3), hw3)
    c.cba(w(256), w(256), 3, 2, hw3)
    c.c3(2 * w(256), w(512), d(3), hw4)
    c.cba(w(512), w(512), 3, 2, hw4)
    c.c3(2 * w(512), w(1024), d(3), hw5)
    K = int(det.get("num_keypoints", 17)) if det.get("pose_head") else 0
    for ch, lv in zip((w(256), w(512), w(1024)), (hw3, hw4, hw5)):
        if det.get("head_variant", "anchor_free") == "v8dfl":
            reg_max, nc = int(det.get("reg_max", 16)), int(det.get("num_classes", 80))
            box_ch, cls_ch = max(16, w(256) // 4, 4 * reg_max), max(w(256), min(nc, 100))
            c.cba(ch, box_ch, 3, 1, lv)
            c.cba(box_ch, box_ch, 3, 1, lv)
            c.conv(box_ch, 4 * reg_max, 1, 1, lv, 0)
            c.cba(ch, cls_ch, 3, 1, lv)
            c.cba(cls_ch, cls_ch, 3, 1, lv)
            c.conv(cls_ch, nc, 1, 1, lv, 0)
            branches = [(ch, 3 * K)] if K else []
        else:
            branches = [(ch, 4), (ch, 1)] + ([(ch, 3 * K)] if K else [])
        for cin, cout in branches:
            c.cba(cin, cin, 3, 1, lv)
            c.conv(cin, cout, 1, 1, lv, 0)
    return c.flops


def pose_flops(td: Dict) -> int:
    """Convolution FLOPs of the top-down pose net on one crop ('SAME' padding)."""
    wd, K = int(td.get("width", 32)), int(td.get("num_keypoints", 17))
    S = int(td.get("crop_size", 64))
    flops, hw = 0, S
    for cin, cout, s in ((3, wd, 1), (wd, 2 * wd, 2), (2 * wd, 2 * wd, 1), (2 * wd, 4 * wd, 2),
                         (4 * wd, 4 * wd, 1), (4 * wd, 4 * wd, 1)):
        hw = -(-hw // s)
        flops += 2 * cin * cout * 9 * hw * hw
    return flops + 2 * 4 * wd * K * hw * hw


def detect_frame_flops(det: Dict) -> int:
    """One frame's detector FLOPs (both TTA passes with ``tta_flip``)."""
    return detector_flops(det) * (2 if det.get("tta_flip") else 1)


def nms_fixpoint_flops(batch: int, k: int) -> int:
    """The fixpoint kernel's IoUs: 12 FLOP for each pair of its upper
    triangle (the adjacency words' ANDs of each Jacobi step left out)."""
    return 12 * batch * (k * (k - 1) // 2)


def nms_bytes(batch: int, k: int, keep_bytes: int) -> int:
    """An NMS launch's least traffic: boxes (16 B) and alive (4 B) of each
    candidate read once, its keep flag (``keep_bytes``) written once."""
    return batch * k * (16 + 4 + keep_bytes)


def card() -> Dict[str, Optional[str]]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        name, limit = (x.strip() for x in out[0].split(",", 1))
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"name": None, "power_limit": None}
