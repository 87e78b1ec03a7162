"""Plain float32 reference of the detection path: letterbox, the CSP
detector (both heads), decode, flip TTA, greedy NMS, unletterbox, xywhn and
the top-down crops, pose net and soft-argmax.

Written from the published layer equations (ultralytics' YOLOv5 C3 / SPPF /
PAN, the anchor-free head with YOLO-Pose's keypoint branch, the v8 DFL
head) in plain ``torch`` operations, one function a layer. It imports
nothing of the program. Parameters come in one flat dict keyed by
``<module path>.<leaf>`` (the naming ``param_spec`` lays out), which the
benchmark fills from the seed and hands to both sides.

Departures from the program's arithmetic, each deliberate:

- Everything runs in float32 with TF32 off (``float32_math``); the program
  computes the detector in bfloat16.
- ``Ctx.fp8`` rounds every convolution's input and weight to float8 e4m3
  (one scale a tensor, amax / 448) before a float32 convolution: the
  control, one precision below the configuration's bfloat16.
- NMS is the textbook sequential greedy loop over the score-sorted
  candidates, not a Jacobi fixpoint or a CUDA kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

STRIDES = (8, 16, 32)
PAD_VALUE = 114.0
BN_EPS = 1e-3
FP8_MAX = 448.0
OUT_QUANTILE, OUT_REACH = 0.999, 2.0  # calibration of the output convolutions
# COCO keypoints: nose, then (left, right) pairs
FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16))


def float32_math() -> None:
    """float32 convolutions and matmuls in float32 on the card (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@dataclass
class Ctx:
    """Parameters and how to run them: ``calibrate`` sets each output
    convolution (one with a bias) on this forward's input: its weights lose
    their part along the input's mean, and are scaled and its bias shifted
    so that its channels centre on their biases and lie within OUT_REACH of
    them at OUT_QUANTILE; ``fp8`` rounds convolution operands to float8 e4m3."""
    params: Dict[str, torch.Tensor]
    calibrate: bool = False
    fp8: bool = False
    cache: Dict[str, torch.Tensor] = field(default_factory=dict)

    def p(self, name: str) -> torch.Tensor:
        t = self.cache.get(name)
        if t is None:
            t = self.params[name]
            if t.dtype != torch.float32:
                t = t.float()
                self.cache[name] = t
        return t


# -- architecture ------------------------------------------------------------


def _round_ch(c: float, divisor: int = 8) -> int:
    return max(divisor, int(math.ceil(c / divisor) * divisor))


def widths(det: dict):
    wm, dm = float(det["width_mult"]), float(det["depth_mult"])
    div = int(det.get("channel_divisor", 8))
    return (lambda c: _round_ch(c * wm, div)), (lambda n: max(1, round(n * dm)))


def _cba_spec(out: List, name: str, cin: int, cout: int, k: int) -> None:
    out.append((f"{name}.Conv_0.weight", (cout, cin, k, k), "conv"))
    for leaf, kind in (("weight", "bn_scale"), ("bias", "bn_bias"),
                       ("running_mean", "bn_mean"), ("running_var", "bn_var")):
        out.append((f"{name}.BatchNorm_0.{leaf}", (cout,), kind))


def _c3_spec(out, name, cin, f, n):
    h = f // 2
    _cba_spec(out, f"{name}.ConvBNAct_0", cin, h, 1)
    _cba_spec(out, f"{name}.ConvBNAct_1", cin, h, 1)
    for i in range(n):
        _cba_spec(out, f"{name}.Bottleneck_{i}.ConvBNAct_0", h, h, 1)
        _cba_spec(out, f"{name}.Bottleneck_{i}.ConvBNAct_1", h, h, 3)
    _cba_spec(out, f"{name}.ConvBNAct_2", 2 * h, f, 1)


def _conv_spec(out, name, cin, cout, k, bias=True, bias_kind="conv_bias"):
    out.append((f"{name}.weight", (cout, cin, k, k), "conv"))
    if bias:
        out.append((f"{name}.bias", (cout,), bias_kind))


def head_channels(det: dict) -> Tuple[int, int]:
    """(box_ch, cls_ch) of the v8 DFL head, set from the P3 width."""
    w, _ = widths(det)
    reg_max, nc = int(det.get("reg_max", 16)), int(det.get("num_classes", 80))
    return max(16, w(256) // 4, 4 * reg_max), max(w(256), min(nc, 100))


def num_keypoints(det: dict) -> int:
    return int(det.get("num_keypoints", 17)) if det.get("pose_head") else 0


def param_spec(det: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every parameter of the detector: (name, shape, kind)."""
    w, d = widths(det)
    out: List = []
    B = "Backbone_0"
    _cba_spec(out, f"{B}.ConvBNAct_0", 3, w(64), 6)
    _cba_spec(out, f"{B}.ConvBNAct_1", w(64), w(128), 3)
    _c3_spec(out, f"{B}.C3_0", w(128), w(128), d(3))
    _cba_spec(out, f"{B}.ConvBNAct_2", w(128), w(256), 3)
    _c3_spec(out, f"{B}.C3_1", w(256), w(256), d(6))
    _cba_spec(out, f"{B}.ConvBNAct_3", w(256), w(512), 3)
    _c3_spec(out, f"{B}.C3_2", w(512), w(512), d(9))
    _cba_spec(out, f"{B}.ConvBNAct_4", w(512), w(1024), 3)
    _c3_spec(out, f"{B}.C3_3", w(1024), w(1024), d(3))
    _cba_spec(out, f"{B}.SPPF_0.ConvBNAct_0", w(1024), w(1024) // 2, 1)
    _cba_spec(out, f"{B}.SPPF_0.ConvBNAct_1", 2 * w(1024), w(1024), 1)
    N = "PANNeck_0"
    _cba_spec(out, f"{N}.ConvBNAct_0", w(1024), w(512), 1)
    _c3_spec(out, f"{N}.C3_0", 2 * w(512), w(512), d(3))
    _cba_spec(out, f"{N}.ConvBNAct_1", w(512), w(256), 1)
    _c3_spec(out, f"{N}.C3_1", 2 * w(256), w(256), d(3))
    _cba_spec(out, f"{N}.ConvBNAct_2", w(256), w(256), 3)
    _c3_spec(out, f"{N}.C3_2", 2 * w(256), w(512), d(3))
    _cba_spec(out, f"{N}.ConvBNAct_3", w(512), w(512), 3)
    _c3_spec(out, f"{N}.C3_3", 2 * w(512), w(1024), d(3))
    K = num_keypoints(det)
    for i, c in enumerate((w(256), w(512), w(1024))):
        if det.get("head_variant", "anchor_free") == "v8dfl":
            H = f"V8DFLHead_{i}"
            box_ch, cls_ch = head_channels(det)
            reg_max, nc = int(det.get("reg_max", 16)), int(det.get("num_classes", 80))
            _cba_spec(out, f"{H}.ConvBNAct_0", c, box_ch, 3)
            _cba_spec(out, f"{H}.ConvBNAct_1", box_ch, box_ch, 3)
            _conv_spec(out, f"{H}.Conv_0", box_ch, 4 * reg_max, 1, bias_kind="dfl_bias")
            _cba_spec(out, f"{H}.ConvBNAct_2", c, cls_ch, 3)
            _cba_spec(out, f"{H}.ConvBNAct_3", cls_ch, cls_ch, 3)
            _conv_spec(out, f"{H}.Conv_1", cls_ch, nc, 1)
            if K:
                _cba_spec(out, f"{H}.ConvBNAct_4", c, c, 3)
                _conv_spec(out, f"{H}.Conv_2", c, 3 * K, 1)
        else:
            H = f"DetectHead_{i}"
            _cba_spec(out, f"{H}.ConvBNAct_0", c, c, 3)
            _conv_spec(out, f"{H}.Conv_0", c, 4, 1)
            _cba_spec(out, f"{H}.ConvBNAct_1", c, c, 3)
            _conv_spec(out, f"{H}.Conv_1", c, 1, 1)
            if K:
                _cba_spec(out, f"{H}.ConvBNAct_2", c, c, 3)
                _conv_spec(out, f"{H}.Conv_2", c, 3 * K, 1)
    return out


def pose_param_spec(td: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every parameter of the top-down pose net."""
    wd, K = int(td.get("width", 32)), int(td.get("num_keypoints", 17))
    chans = ((3, wd), (wd, 2 * wd), (2 * wd, 2 * wd), (2 * wd, 4 * wd), (4 * wd, 4 * wd),
             (4 * wd, 4 * wd))
    out: List = []
    for i, (cin, cout) in enumerate(chans):
        out.append((f"Conv_{i}.weight", (cout, cin, 3, 3), "conv"))
        for leaf, kind in (("weight", "bn_scale"), ("bias", "bn_bias"),
                           ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            out.append((f"BatchNorm_{i}.{leaf}", (cout,), kind))
    _conv_spec(out, "Conv_6", 4 * wd, K, 1)
    return out


# -- layers ------------------------------------------------------------------


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at one scale for the tensor (amax -> 448);
    the gradient passes through the rounding unchanged."""
    scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach())


def conv(ctx: Ctx, name: str, x: torch.Tensor, stride: int = 1, padding=0,
         bias: bool = False) -> torch.Tensor:
    w = ctx.p(f"{name}.weight")
    b = ctx.p(f"{name}.bias") if bias else None
    if ctx.fp8:
        x, w = fp8_round(x), fp8_round(w)
    if ctx.calibrate and bias:
        # an output conv: blind to its input's mean (else a map's spread is
        # a small difference of large numbers), its channels centred on
        # their biases, and scaled so that nearly all of it (OUT_QUANTILE)
        # lies within OUT_REACH of them: a trained head's maps are bounded,
        # and the anchors a detector serves are the top of their range
        m = x.mean(dim=(0, 2, 3))[:, None, None].expand(w.shape[1:]).reshape(-1)
        m = m / m.norm().clamp(min=1e-12)
        flat = w.reshape(w.shape[0], -1)
        w = (flat - (flat @ m)[:, None] * m[None]).reshape(w.shape)
        y = F.conv2d(x, w, None, stride, padding)
        mean = y.mean(dim=(0, 2, 3))
        dev = (y - mean[None, :, None, None]).abs().flatten()
        k = max(1, int(OUT_QUANTILE * dev.numel()))
        reach = dev.kthvalue(k).values.clamp(min=1e-6) / OUT_REACH
        w, b = w / reach, b - mean / reach
        for leaf, v in (("weight", w), ("bias", b)):
            ctx.params[f"{name}.{leaf}"] = v.detach().to(ctx.params[f"{name}.{leaf}"].dtype)
            ctx.cache.pop(f"{name}.{leaf}", None)
    return F.conv2d(x, w, b, stride, padding)


def batch_norm(ctx: Ctx, name: str, x: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm with the running statistics, eps BN_EPS."""
    scale, shift = ctx.p(f"{name}.weight"), ctx.p(f"{name}.bias")
    mean, var = ctx.p(f"{name}.running_mean"), ctx.p(f"{name}.running_var")
    inv = scale / torch.sqrt(var + BN_EPS)
    return (x - mean[None, :, None, None]) * inv[None, :, None, None] + shift[None, :, None, None]


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def cba(ctx: Ctx, name: str, x: torch.Tensor, k: int, s: int = 1) -> torch.Tensor:
    """Conv (no bias, padding (k-1)//2) -> BatchNorm -> SiLU."""
    y = conv(ctx, f"{name}.Conv_0", x, s, (k - 1) // 2)
    return silu(batch_norm(ctx, f"{name}.BatchNorm_0", y))


def c3(ctx: Ctx, name: str, x: torch.Tensor, n: int, shortcut: bool = True) -> torch.Tensor:
    a = cba(ctx, f"{name}.ConvBNAct_0", x, 1)
    b = cba(ctx, f"{name}.ConvBNAct_1", x, 1)
    for i in range(n):
        y = cba(ctx, f"{name}.Bottleneck_{i}.ConvBNAct_1",
                cba(ctx, f"{name}.Bottleneck_{i}.ConvBNAct_0", a, 1), 3)
        a = a + y if shortcut else y
    return cba(ctx, f"{name}.ConvBNAct_2", torch.cat([a, b], 1), 1)


def sppf(ctx: Ctx, name: str, x: torch.Tensor) -> torch.Tensor:
    x = cba(ctx, f"{name}.ConvBNAct_0", x, 1)
    p1 = F.max_pool2d(x, 5, 1, 2)
    p2 = F.max_pool2d(p1, 5, 1, 2)
    p3 = F.max_pool2d(p2, 5, 1, 2)
    return cba(ctx, f"{name}.ConvBNAct_1", torch.cat([x, p1, p2, p3], 1), 1)


def up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def detector_forward(ctx: Ctx, det: dict, images: torch.Tensor) -> List[torch.Tensor]:
    """images (B, S, S, 3) in [0, 1] -> the three raw head maps (B, H, W, C)."""
    _, d = widths(det)
    x = images.permute(0, 3, 1, 2).to(torch.float32)
    B = "Backbone_0"
    x = cba(ctx, f"{B}.ConvBNAct_0", x, 6, 2)
    x = c3(ctx, f"{B}.C3_0", cba(ctx, f"{B}.ConvBNAct_1", x, 3, 2), d(3))
    p3 = x = c3(ctx, f"{B}.C3_1", cba(ctx, f"{B}.ConvBNAct_2", x, 3, 2), d(6))
    p4 = x = c3(ctx, f"{B}.C3_2", cba(ctx, f"{B}.ConvBNAct_3", x, 3, 2), d(9))
    x = c3(ctx, f"{B}.C3_3", cba(ctx, f"{B}.ConvBNAct_4", x, 3, 2), d(3))
    p5 = sppf(ctx, f"{B}.SPPF_0", x)
    N = "PANNeck_0"
    t5 = cba(ctx, f"{N}.ConvBNAct_0", p5, 1)
    x = c3(ctx, f"{N}.C3_0", torch.cat([up2(t5), p4], 1), d(3), False)
    t4 = cba(ctx, f"{N}.ConvBNAct_1", x, 1)
    n3 = c3(ctx, f"{N}.C3_1", torch.cat([up2(t4), p3], 1), d(3), False)
    n4 = c3(ctx, f"{N}.C3_2", torch.cat([cba(ctx, f"{N}.ConvBNAct_2", n3, 3, 2), t4], 1), d(3),
            False)
    n5 = c3(ctx, f"{N}.C3_3", torch.cat([cba(ctx, f"{N}.ConvBNAct_3", n4, 3, 2), t5], 1), d(3),
            False)
    K = num_keypoints(det)
    maps = []
    for i, f in enumerate((n3, n4, n5)):
        if det.get("head_variant", "anchor_free") == "v8dfl":
            H = f"V8DFLHead_{i}"
            box = conv(ctx, f"{H}.Conv_0", cba(ctx, f"{H}.ConvBNAct_1",
                                                cba(ctx, f"{H}.ConvBNAct_0", f, 3), 3), bias=True)
            cls = conv(ctx, f"{H}.Conv_1", cba(ctx, f"{H}.ConvBNAct_3",
                                                cba(ctx, f"{H}.ConvBNAct_2", f, 3), 3), bias=True)
            outs = [box, cls]
            if K:
                outs.append(conv(ctx, f"{H}.Conv_2", cba(ctx, f"{H}.ConvBNAct_4", f, 3),
                                 bias=True))
        else:
            H = f"DetectHead_{i}"
            outs = [conv(ctx, f"{H}.Conv_0", cba(ctx, f"{H}.ConvBNAct_0", f, 3), bias=True),
                    conv(ctx, f"{H}.Conv_1", cba(ctx, f"{H}.ConvBNAct_1", f, 3), bias=True)]
            if K:
                outs.append(conv(ctx, f"{H}.Conv_2", cba(ctx, f"{H}.ConvBNAct_2", f, 3),
                                 bias=True))
        maps.append(torch.cat(outs, 1).permute(0, 2, 3, 1))
    return maps


# -- decode --------------------------------------------------------------------


def _grid(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    gy = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    gx = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    return gx, gy


def decode(det: dict, maps: List[torch.Tensor]):
    """Raw maps -> (boxes (B, A, 4) xyxy canvas px, person scores (B, A),
    keypoints (B, A, K, 3) or None); anchors row-major per level, p3..p5."""
    K = num_keypoints(det)
    v8 = det.get("head_variant", "anchor_free") == "v8dfl"
    reg_max, nc = int(det.get("reg_max", 16)), int(det.get("num_classes", 80))
    boxes, scores, kpts = [], [], []
    for x, s in zip(maps, STRIDES):
        x = x.to(torch.float32)
        B, H, W, _ = x.shape
        gx, gy = _grid(H, W, x.device)
        if v8:
            # anchor points at cell centres; ltrb distances are the softmax
            # expectation over reg_max bins (DFL)
            ax, ay = gx + 0.5, gy + 0.5
            dist = torch.softmax(x[..., :4 * reg_max].reshape(B, H, W, 4, reg_max), -1)
            dist = (dist * torch.arange(reg_max, dtype=torch.float32, device=x.device)).sum(-1)
            b = torch.stack([ax - dist[..., 0], ay - dist[..., 1], ax + dist[..., 2],
                             ay + dist[..., 3]], -1) * s
            score = torch.sigmoid(x[..., 4 * reg_max])  # class 0, person
            k = x[..., 4 * reg_max + nc:] if K else None
        else:
            cx = (gx + torch.sigmoid(x[..., 0])) * s
            cy = (gy + torch.sigmoid(x[..., 1])) * s
            w = torch.exp(x[..., 2].clamp(-4.0, 4.0)) * s
            h = torch.exp(x[..., 3].clamp(-4.0, 4.0)) * s
            b = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
            score = torch.sigmoid(x[..., 4])
            k = x[..., 5:5 + 3 * K] if K else None
        boxes.append(b.reshape(B, H * W, 4))
        scores.append(score.reshape(B, H * W))
        if K:
            k = k.reshape(B, H, W, K, 3)
            kx = (gx[..., None] + 2.0 * k[..., 0]) * s
            ky = (gy[..., None] + 2.0 * k[..., 1]) * s
            kpts.append(torch.stack([kx, ky, torch.sigmoid(k[..., 2])], -1).reshape(
                B, H * W, K, 3))
    return (torch.cat(boxes, 1), torch.cat(scores, 1), torch.cat(kpts, 1) if K else None)


def anchor_grid(size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each anchor's cell centre (A, 2) in canvas px and stride (A,)."""
    centres, strides = [], []
    for s in STRIDES:
        n = size // s
        gx, gy = _grid(n, n, device)
        centres.append(torch.stack([gx, gy], -1).reshape(-1, 2) * s + s / 2)
        strides.append(torch.full((n * n,), float(s), device=device))
    return torch.cat(centres), torch.cat(strides)


def mirror_anchor_index(size: int, device) -> torch.Tensor:
    """For each anchor, the index of the anchor at its horizontal mirror."""
    parts, offset = [], 0
    for s in STRIDES:
        n = size // s
        y = torch.arange(n, device=device)[:, None]
        x = torch.arange(n, device=device)[None, :]
        parts.append((offset + y * n + (n - 1 - x)).reshape(-1))
        offset += n * n
    return torch.cat(parts)


def keypoint_mirror(K: int) -> List[int]:
    perm = list(range(K))
    for a, b in FLIP_PAIRS:
        if a < K and b < K:
            perm[a], perm[b] = b, a
    return perm


def detect_candidates(ctx: Ctx, det: dict, images: torch.Tensor):
    """Letterboxed images -> decoded (boxes, scores, kpts) for every anchor,
    averaged with the mirrored image's decode when ``tta_flip`` is on."""
    if not det.get("tta_flip"):
        return decode(det, detector_forward(ctx, det, images))
    S = images.shape[2]
    boxes, scores, kpts = decode(det, detector_forward(ctx, det, images))
    fb, fs, fk = decode(det, detector_forward(ctx, det, images.flip(2)))
    m = mirror_anchor_index(S, images.device)
    fb, fs = fb[:, m], fs[:, m]
    fb = torch.stack([S - fb[..., 2], fb[..., 1], S - fb[..., 0], fb[..., 3]], -1)
    boxes, scores = (boxes + fb) / 2, (scores + fs) / 2
    if kpts is not None:
        fk = fk[:, m][:, :, keypoint_mirror(kpts.shape[2])]
        fk = torch.stack([S - fk[..., 0], fk[..., 1], fk[..., 2]], -1)
        kpts = (kpts + fk) / 2
    return boxes, scores, kpts


# -- NMS -----------------------------------------------------------------------


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of (..., N, 4) against (..., M, 4) xyxy boxes -> (..., N, M)."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter).clamp(min=1e-9)


def top_candidates(scores: torch.Tensor, conf: float, k: int):
    """Anchors scoring at least ``conf``, the ``k`` best, by descending
    score (ties: lower anchor first) -> (scores (B, k), anchors (B, k),
    alive (B, k))."""
    masked = torch.where(scores >= conf, scores, torch.full_like(scores, -math.inf))
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    return vals, idx, torch.isfinite(vals)


def greedy_nms(boxes: torch.Tensor, alive: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Sequential greedy NMS over score-sorted candidates (B, K, 4) -> keep (B, K)."""
    over = box_iou(boxes, boxes) > iou_thresh
    keep = alive.clone()
    K = boxes.shape[1]
    later = torch.arange(K, device=boxes.device)
    for i in range(K):
        keep &= ~(over[:, i, :] & (later > i) & keep[:, i:i + 1])
    return keep


def postprocess(det: dict, boxes, scores, kpts, pre_topk: int = 256):
    """conf mask -> top-K -> greedy NMS -> the best ``max_detections`` kept
    -> (boxes (B, M, 4), scores, valid, anchors, kpts or None); invalid rows
    zero."""
    conf, iou = float(det["conf_threshold"]), float(det["iou_threshold"])
    M = int(det["max_detections"])
    vals, idx, alive = top_candidates(scores, conf, min(pre_topk, scores.shape[1]))
    cand = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    keep = greedy_nms(cand, alive, iou)
    final = torch.where(keep, vals, torch.full_like(vals, -math.inf))
    out_s, order = torch.sort(final, dim=-1, descending=True, stable=True)
    out_s, order = out_s[:, :M], order[:, :M]
    valid = torch.isfinite(out_s)
    anchors = torch.where(valid, torch.gather(idx, 1, order), 0)
    out_b = torch.where(valid[..., None], torch.gather(cand, 1, order[..., None].expand(-1, -1, 4)),
                        0.0)
    out_s = torch.where(valid, out_s, 0.0)
    out_k = None
    if kpts is not None:
        out_k = kpts[torch.arange(kpts.shape[0], device=kpts.device)[:, None], anchors]
    if out_s.shape[1] < M:  # fewer candidates than slots
        pad = M - out_s.shape[1]
        out_b, out_s = F.pad(out_b, (0, 0, 0, pad)), F.pad(out_s, (0, pad))
        valid, anchors = F.pad(valid, (0, pad)), F.pad(anchors, (0, pad))
        if out_k is not None:
            out_k = F.pad(out_k, (0, 0, 0, 0, 0, pad))
    return out_b, out_s, valid, anchors, out_k


# -- letterbox -------------------------------------------------------------------


def letterbox_geometry(src_h: int, src_w: int, size: int):
    """(scale, pad_x, pad_y, new_w, new_h) of an aspect-kept fit into size x size."""
    scale = min(size / src_h, size / src_w)
    nw, nh = int(round(src_w * scale)), int(round(src_h * scale))
    return scale, (size - nw) // 2, (size - nh) // 2, nw, nh


def letterbox(frames: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, size, size, 3) float32 in [0, 1]: bilinear
    resize (antialiased when it shrinks), gray 114 border."""
    _, H, W, _ = frames.shape
    _, px, py, nw, nh = letterbox_geometry(H, W, size)
    x = frames.permute(0, 3, 1, 2).to(torch.float32)
    if (nh, nw) != (H, W):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                          antialias=nh < H or nw < W)
    canvas = torch.full((x.shape[0], 3, size, size), PAD_VALUE, dtype=torch.float32,
                        device=x.device)
    canvas[:, :, py:py + nh, px:px + nw] = x
    return (canvas / 255.0).permute(0, 2, 3, 1)


def unletterbox(boxes: torch.Tensor, src_h: int, src_w: int, size: int) -> torch.Tensor:
    """Canvas xyxy -> source-frame px, clamped to the frame."""
    scale, px, py, _, _ = letterbox_geometry(src_h, src_w, size)
    x1 = ((boxes[..., 0] - px) / scale).clamp(0, src_w)
    y1 = ((boxes[..., 1] - py) / scale).clamp(0, src_h)
    x2 = ((boxes[..., 2] - px) / scale).clamp(0, src_w)
    y2 = ((boxes[..., 3] - py) / scale).clamp(0, src_h)
    return torch.stack([x1, y1, x2, y2], -1)


def xywhn(boxes: torch.Tensor, src_h: int, src_w: int) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2 / src_w, (y1 + y2) / 2 / src_h, (x2 - x1) / src_w,
                        (y2 - y1) / src_h], -1)


# -- top-down pose -----------------------------------------------------------------


def crops(images: torch.Tensor, boxes: torch.Tensor, S: int, pad_frac: float = 0.25):
    """Bilinear S x S crops of each box grown by ``pad_frac`` (edge pixels
    repeated outside the image) -> (crops (B, M, S, S, 3), origin (B, M, 2),
    step (B, M, 2)): image px = origin + crop px * step."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    w = (x2 - x1).clamp(min=1.0) * (1 + pad_frac)
    h = (y2 - y1).clamp(min=1.0) * (1 + pad_frac)
    ox, oy = (x1 + x2) / 2 - w / 2, (y1 + y2) / 2 - h / 2
    sx, sy = w / S, h / S
    t = torch.arange(S, dtype=torch.float32, device=images.device) + 0.5
    xs = ox[..., None] + t * sx[..., None] - 0.5  # sample centres, pixel-centre convention
    ys = oy[..., None] + t * sy[..., None] - 0.5
    H, W = images.shape[1], images.shape[2]
    x0f, y0f = torch.floor(xs), torch.floor(ys)
    fx = (xs - x0f.clamp(0, W - 1)).clamp(0, 1)
    fy = (ys - y0f.clamp(0, H - 1)).clamp(0, 1)
    x0 = x0f.long().clamp(0, W - 1)
    y0 = y0f.long().clamp(0, H - 1)
    x1i, y1i = (x0 + 1).clamp(0, W - 1), (y0 + 1).clamp(0, H - 1)
    b = torch.arange(images.shape[0], device=images.device)[:, None, None, None]

    def px(yy, xx):
        return images[b, yy[..., :, None], xx[..., None, :]]  # (B, M, S, S, 3)

    fy_, fx_ = fy[..., :, None, None], fx[..., None, :, None]
    top = px(y0, x0) * (1 - fy_) + px(y1i, x0) * fy_
    bot = px(y0, x1i) * (1 - fy_) + px(y1i, x1i) * fy_
    out = top * (1 - fx_) + bot * fx_
    return out, torch.stack([ox, oy], -1), torch.stack([sx, sy], -1)


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """'SAME' padding, the smaller half before."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def pose_net(ctx: Ctx, x: torch.Tensor) -> torch.Tensor:
    """(N, S, S, 3) crops -> (N, S/4, S/4, K) heatmap logits."""
    x = x.permute(0, 3, 1, 2)
    for i, s in enumerate((1, 2, 1, 2, 1, 1)):
        x = conv(ctx, f"Conv_{i}", _same_pad(x, 3, s), s)
        x = silu(batch_norm(ctx, f"BatchNorm_{i}", x))
    return conv(ctx, "Conv_6", x, bias=True).permute(0, 2, 3, 1)


def soft_argmax(heat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, h, w, K) logits -> (expected (x, y) in [0, 1] (N, K, 2), peak probability (N, K))."""
    N, h, w, K = heat.shape
    prob = torch.softmax(heat.reshape(N, h * w, K), dim=1)
    gx = ((torch.arange(w, device=heat.device, dtype=torch.float32) + 0.5) / w).repeat(h)
    gy = ((torch.arange(h, device=heat.device, dtype=torch.float32) + 0.5) / h
          ).repeat_interleave(w)
    x = (prob * gx[None, :, None]).sum(1)
    y = (prob * gy[None, :, None]).sum(1)
    return torch.stack([x, y], -1), prob.amax(1)


def topdown_pose(ctx: Ctx, td: dict, images: torch.Tensor, boxes: torch.Tensor,
                 block: int = 4096) -> torch.Tensor:
    """Canvas images (B, S, S, 3) and canvas boxes (B, M, 4) -> keypoints
    (B, M, K, 3) in canvas px, the pose net run ``block`` crops at a time."""
    S = int(td.get("crop_size", 64))
    B, M = boxes.shape[:2]
    cr, origin, step = crops(images, boxes, S)
    cr = cr.reshape(B * M, S, S, 3)
    parts = [soft_argmax(pose_net(ctx, cr[i:i + block])) for i in range(0, B * M, block)]
    xy = torch.cat([p[0] for p in parts]).reshape(B, M, -1, 2)
    peak = torch.cat([p[1] for p in parts]).reshape(B, M, -1)
    xy = origin[:, :, None, :] + xy * (S * step[:, :, None, :])
    return torch.cat([xy, peak[..., None]], -1)


# -- the whole path -------------------------------------------------------------------


def detect(ctx: Ctx, det: dict, frames: torch.Tensor, pose_ctx: Optional[Ctx] = None):
    """uint8 frames (B, H, W, 3) -> a dict of the path's outputs: per-anchor
    ``cand_boxes`` / ``cand_scores`` / ``cand_kpts`` (canvas px), ``canvas``,
    and the served ``boxes`` (source px), ``xywhn``, ``scores``, ``valid``,
    ``kpts`` (canvas px) after NMS, as the configuration states them."""
    _, H, W, _ = frames.shape
    size = int(det["img_size"])
    canvas = letterbox(frames, size)
    if ctx.fp8:
        canvas = fp8_round(canvas)
    cb, cs, ck = detect_candidates(ctx, det, canvas)
    boxes_lb, scores, valid, anchors, kpts = postprocess(det, cb, cs, ck)
    if det.get("pose_mode") == "topdown" and pose_ctx is not None:
        kpts = topdown_pose(pose_ctx, det.get("pose_topdown") or {}, canvas, boxes_lb)
    boxes = unletterbox(boxes_lb, H, W, size)
    return {"cand_boxes": cb, "cand_scores": cs, "cand_kpts": ck, "canvas": canvas,
            "boxes_lb": boxes_lb, "boxes": boxes, "xywhn": xywhn(boxes, H, W),
            "scores": scores, "valid": valid, "anchors": anchors, "kpts": kpts}
