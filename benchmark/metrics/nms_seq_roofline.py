"""``csrc/nms_seq.cu``'s share of its roofline, %: the least time of a
launch (its candidates' boxes and alive flags read once and its float32
keep mask written once, over the card's 3.35 TB/s) over the kernel's mean
device time in the trace. Each launch is the batch's B x 256 candidates
that ``batched_nms`` keeps for NMS."""

from harness.trace import kernel_times
from flops import PEAK_HBM_BYTES, nms_bytes

PRE_TOPK = 256


def read(ctx):
    times = kernel_times(ctx.get("trace"), "nms_seq_kernel")
    if not times:
        return None
    bound = nms_bytes(int(ctx["traffic"]["batch"]), PRE_TOPK, 4) / PEAK_HBM_BYTES
    return 100.0 * bound / (sum(times) / len(times))
