from cvsd_tpu_torch.pipeline.pose_export import export_poselift_dataset, extract_pose_data  # noqa: F401
from cvsd_tpu_torch.pipeline.preprocess import (  # noqa: F401
    DetectionPipeline,
    preprocess_ucf_crime,
    process_video,
)
from cvsd_tpu_torch.pipeline.streaming import ScoreEvent, StreamingPipeline  # noqa: F401
