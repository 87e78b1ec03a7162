"""``csrc/nms_fixpoint.cu``'s share of its roofline, %: the least time of
a launch, the larger of its bytes (its candidates' boxes and alive flags
read once, its keep mask written once) over the card's 3.35 TB/s and its
upper triangle of IoUs over the FP32 peak, over the kernel's mean device
time in the trace. Each launch is the batch's B x 256 candidates that
``batched_nms`` keeps for NMS."""

from harness.trace import kernel_times
from flops import PEAK_FP32_FLOPS, PEAK_HBM_BYTES, nms_bytes, nms_fixpoint_flops

PRE_TOPK = 256


def read(ctx):
    times = kernel_times(ctx.get("trace"), "nms_fixpoint_kernel")
    if not times:
        return None
    b = int(ctx["traffic"]["batch"])
    bound = max(nms_bytes(b, PRE_TOPK, 1) / PEAK_HBM_BYTES,
                nms_fixpoint_flops(b, PRE_TOPK) / PEAK_FP32_FLOPS)
    return 100.0 * bound / (sum(times) / len(times))
