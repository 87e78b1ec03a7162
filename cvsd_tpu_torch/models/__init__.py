from cvsd_tpu_torch.models.detector import (  # noqa: F401
    PersonDetector,
    build_detector,
    decode_predictions,
    make_detect_fn,
)
from cvsd_tpu_torch.models.shopformer import Shopformer, build_shopformer  # noqa: F401
