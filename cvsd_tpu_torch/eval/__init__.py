from cvsd_tpu_torch.eval.detection import detection_pr, evaluate_detector, keypoint_rms  # noqa: F401
from cvsd_tpu_torch.eval.streaming_eval import StreamingEvalResult, evaluate_streaming  # noqa: F401
from cvsd_tpu_torch.eval.evaluate import (  # noqa: F401
    ShopformerScorer,
    evaluate_checkpoint,
    evaluate_frame_level,
    evaluate_video_level,
    load_model,
)
