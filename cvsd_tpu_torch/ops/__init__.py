from cvsd_tpu_torch.ops.iou import box_iou_matrix, xywh_to_xyxy, xyxy_to_xywh, xyxy_to_xywhn  # noqa: F401
from cvsd_tpu_torch.ops.letterbox import letterbox_batch, letterbox_params  # noqa: F401
from cvsd_tpu_torch.ops.nms import batched_nms  # noqa: F401
