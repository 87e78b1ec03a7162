"""Pose-window preparation shared by the streaming scorer (the port's copy
of the numpy helpers in ``cvsd_tpu/data/poselift.py``): synthetic neck
keypoint, per-sequence normalization, frame-gap continuity."""

from __future__ import annotations

from typing import Sequence

import numpy as np

LEFT_SHOULDER_IDX = 5
RIGHT_SHOULDER_IDX = 6


def add_neck_keypoint(keypoints: np.ndarray) -> np.ndarray:
    """Append a synthetic neck (index 17) = shoulder midpoint; falls back to the
    present shoulder when one is missing, zeros when both are
    (reference: shopformer_2/data/poselift_dataset.py:57-91)."""
    if keypoints.shape[0] < 17:
        pad = np.zeros((17 - keypoints.shape[0], keypoints.shape[1]), dtype=keypoints.dtype)
        keypoints = np.vstack([keypoints, pad])
    ls, rs = keypoints[LEFT_SHOULDER_IDX], keypoints[RIGHT_SHOULDER_IDX]
    ls_missing = np.allclose(ls[:2], 0)
    rs_missing = np.allclose(rs[:2], 0)
    if ls_missing and rs_missing:
        neck = np.zeros_like(ls)
    elif ls_missing:
        neck = rs.copy()
    elif rs_missing:
        neck = ls.copy()
    else:
        neck = (ls + rs) / 2.0
    return np.vstack([keypoints[:17], neck.reshape(1, -1)])


def normalize_sequence(sequence: np.ndarray) -> np.ndarray:
    """Center a (T, V, C>=2) sequence on its valid-keypoint mean and scale to
    [-1, 1] by the max |centered| coordinate
    (reference: shopformer_2/data/poselift_dataset.py:545-576)."""
    sequence = sequence.copy()
    coords = sequence[:, :, :2]
    valid = np.any(coords != 0, axis=-1)
    if valid.sum() > 0:
        center = coords[valid].mean(axis=0)
        centered = coords - center
        scale = np.abs(centered[valid]).max() + 1e-6
    else:
        center = np.zeros(2, dtype=coords.dtype)
        scale = 1.0
    out = (coords - center) / scale
    sequence[:, :, :2] = np.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)
    return sequence


def check_continuity(frame_indices: Sequence[int], max_gap: int) -> bool:
    """Reject windows containing a frame gap > max_gap
    (reference: shopformer/data/poselift_dataset.py:325-329)."""
    fi = np.asarray(frame_indices)
    return bool(fi.size < 2 or np.all(np.diff(fi) <= max_gap))
