"""The detection step's share of the card's bf16 peak, %: the convolution
FLOPs (every frame's detector forward, both passes with flip TTA, and the
top-down pose net once for each valid box served) over the seconds, over
989 TFLOP/s; in a traced run, over the window's first half, before the
profiler starts."""

from flops import PEAK_BF16_FLOPS, detect_frame_flops, pose_flops


def read(ctx):
    if ctx["kind"] != "detect":
        return None
    det, run = ctx["det"], ctx["run"]
    run = run.get("untraced") or run
    if not run["frames"]:
        return None
    flops = detect_frame_flops(det) * run["frames"]
    if det.get("pose_mode") == "topdown":
        flops += pose_flops(det.get("pose_topdown") or {}) * run["valid_boxes"]
    return 100.0 * flops / run["window_s"] / PEAK_BF16_FLOPS
