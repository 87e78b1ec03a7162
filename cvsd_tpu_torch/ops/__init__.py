from cvsd_tpu_torch.ops.iou import box_iou_matrix, xywh_to_xyxy, xyxy_to_xywh, xyxy_to_xywhn  # noqa: F401
from cvsd_tpu_torch.ops.letterbox import (  # noqa: F401
    PAD_VALUE,
    letterbox_batch,
    letterbox_params,
    unletterbox_boxes,
)
from cvsd_tpu_torch.ops.nms import (  # noqa: F401
    batched_nms,
    nms_fixpoint,
    nms_fixpoint_cuda,
    nms_fixpoint_torch,
    nms_seq,
    nms_seq_cuda,
    nms_seq_multi,
    nms_seq_multi_cuda,
    nms_seq_multi_torch,
    nms_seq_torch,
    nms_torch,
    suppress_torch,
)
