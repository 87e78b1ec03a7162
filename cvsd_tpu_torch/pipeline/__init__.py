from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline  # noqa: F401
from cvsd_tpu_torch.pipeline.streaming import (  # noqa: F401
    ArraySource,
    RoundRobinReader,
    ScoreEvent,
    StreamingPipeline,
    VideoFileSource,
)
