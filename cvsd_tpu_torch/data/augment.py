"""COCO left/right keypoint swap (the part of ``cvsd_tpu/data/augment.py``
that inference needs: flip-TTA mirrors keypoints with it). The batched pose
augmentation for training is not ported yet (ROADMAP.md, module queue:
Shopformer training and evaluation)."""

from __future__ import annotations

import numpy as np

COCO_KEYPOINT_FLIP_PAIRS = (
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16),
)


def flip_permutation(num_keypoints: int) -> np.ndarray:
    """Index permutation implementing the left/right keypoint swap.
    The neck (17) is central and maps to itself."""
    perm = np.arange(num_keypoints)
    for l, r in COCO_KEYPOINT_FLIP_PAIRS:
        if l < num_keypoints and r < num_keypoints:
            perm[l], perm[r] = r, l
    return perm
