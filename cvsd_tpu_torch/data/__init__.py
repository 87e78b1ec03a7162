from cvsd_tpu_torch.data.augment import (  # noqa: F401
    COCO_KEYPOINT_FLIP_PAIRS,
    PoseAugmentor,
    affine_matrix,
    apply_affine,
    batched_augment,
    flip_keypoints,
)
from cvsd_tpu_torch.data.datamodule import PoseLiftDataModule, batch_iterator  # noqa: F401
from cvsd_tpu_torch.data.poselift import PoseLiftDataset, add_neck_keypoint, normalize_sequence  # noqa: F401
from cvsd_tpu_torch.data.synthetic import SyntheticPoseLiftDataset  # noqa: F401
