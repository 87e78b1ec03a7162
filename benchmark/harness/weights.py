"""Weights made on the device from the seed, in a few large calls.

One ``torch.Generator`` on the device draws one flat normal vector for
every parameter of a spec (``reference.detector.param_spec``); each
parameter is a slice of it, scaled by its kind. The same dict goes to the
program and to the reference."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str]]
# BatchNorm scale. A deep stack of random convolutions keeps its activations
# at one size only where the scale makes up for what SiLU takes away: below
# that they fade with depth and every score ties, above it they grow. At
# 1.5 they settle, whatever the input, and a rounding of the input moves the
# head maps by about a percent.
BN_GAIN = 1.5
DFL_SLOPE = 0.5


def make_params(spec: Spec, seed: int, device, dtype=torch.float32,
                stream: int = 0) -> Dict[str, torch.Tensor]:
    """{name: tensor} for ``spec`` from ``seed`` (and ``stream``, which
    separates two nets of one seed). Convolution weights are lecun-normal
    (std 1/sqrt(fan_in)); their biases N(0, 0.1); BatchNorm scales
    BN_GAIN x (1 + N(0, 0.1)), shifts N(0, 0.1), running means N(0, 0.05),
    running variances 1 + |N(0, 0.1)|; the DFL head's bins as
    ``dfl_bias`` says. Made in float32, then rounded to ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + 7919 * int(stream)) % (2 ** 63))
    total = sum(math.prod(shape) for _, shape, _ in spec)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        x = flat[off:off + n].view(shape)
        off += n
        if kind == "conv":
            x = x * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif kind == "bn_scale":
            x = BN_GAIN * (1.0 + 0.1 * x)
        elif kind == "bn_bias":
            x = 0.1 * x
        elif kind == "dfl_bias":
            # the DFL bins' logits fall by DFL_SLOPE a bin: expected
            # distances of ~2 bins, boxes of a few strides, as a trained
            # head's (flat logits put every box at 7.5 bins a side)
            reg_max = n // 4
            x = 0.1 * x - DFL_SLOPE * torch.arange(reg_max, device=device).repeat(4)
        elif kind == "bn_var":
            x = 1.0 + 0.1 * x.abs()
        elif kind == "bn_mean":
            x = 0.05 * x
        else:  # conv_bias
            x = 0.1 * x
        out[name] = x.to(dtype)
    return out


@torch.no_grad()
def calibrated(det: dict, seed: int, frames: torch.Tensor, dtype=torch.float32):
    """The detector's (and, with a top-down pose net, the pose net's) params
    from ``seed``, each output convolution set by one float32 pass of the
    reference over ``frames`` (uint8, on the device; ``Ctx.calibrate``) so
    that its channels centre on their random biases within a bounded reach,
    then rounded to ``dtype`` (the pose net stays float32, as it is
    served). So scores, box sizes and keypoints spread as a trained head's
    do, at any width and depth."""
    from reference import detector as R

    R.float32_math()
    device = frames.device
    params = make_params(R.param_spec(det), seed, device)
    ctx = R.Ctx(params, calibrate=True)
    canvas = R.letterbox(frames, int(det["img_size"]))
    R.detector_forward(ctx, det, canvas)
    det_params = {k: v.to(dtype) for k, v in params.items()}
    pose_params = None
    if det.get("pose_mode") == "topdown":
        td = det.get("pose_topdown") or {}
        pose_params = make_params(R.pose_param_spec(td), seed, device, stream=1)
        ref = R.detect(R.Ctx(det_params), det, frames)
        R.topdown_pose(R.Ctx(pose_params, calibrate=True), td, ref["canvas"], ref["boxes_lb"],
                       block=1 << 30)
    return det_params, pose_params

