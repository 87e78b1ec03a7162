"""Synthetic PoseLift fixture — the deterministic fake-data backend (the
port's copy of ``cvsd_tpu/data/synthetic.py``, numpy only, so the same seed
gives the same arrays bit for bit).

Procedural COCO-17 skeletons with per-frame motion noise; anomalies get 4x
larger motion noise and, after mid-sequence, wrists pulled toward hips
("concealment"). Used by tests and by every CLI through
``data.dataset=synthetic``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from cvsd_tpu_torch.data.poselift import add_neck_keypoint, normalize_sequence

# Canonical upright COCO-17 skeleton in [0,1]^2 image coordinates
# (nose, eyes, ears, shoulders, elbows, wrists, hips, knees, ankles).
_BASE_SKELETON = np.array(
    [
        [0.5, 0.1], [0.48, 0.08], [0.52, 0.08], [0.45, 0.1], [0.55, 0.1],
        [0.4, 0.25], [0.6, 0.25], [0.35, 0.4], [0.65, 0.4], [0.3, 0.55],
        [0.7, 0.55], [0.45, 0.55], [0.55, 0.55], [0.43, 0.75], [0.57, 0.75],
        [0.42, 0.95], [0.58, 0.95],
    ],
    dtype=np.float64,
)

LEFT_WRIST, RIGHT_WRIST = 9, 10
LEFT_HIP, RIGHT_HIP = 11, 12


class SyntheticPoseLiftDataset:
    """Deterministic synthetic pose sequences with injectable anomalies."""

    def __init__(
        self,
        num_samples: int = 256,
        seq_len: int = 12,
        num_keypoints: int = 17,
        num_channels: int = 2,
        anomaly_ratio: float = 0.3,
        seed: int = 0,
        normalize: bool = False,
    ):
        self.num_samples = int(num_samples)
        self.seq_len = int(seq_len)
        self.num_keypoints = int(num_keypoints)
        self.num_channels = int(num_channels)
        rng = np.random.default_rng(seed)

        poses = np.empty((num_samples, seq_len, num_keypoints, num_channels), np.float32)
        labels = np.empty((num_samples,), np.int32)
        for i in range(num_samples):
            is_anomaly = rng.random() < anomaly_ratio
            base = _BASE_SKELETON + rng.normal(0, 0.02, _BASE_SKELETON.shape)
            seq = self._generate_sequence(rng, base, is_anomaly)
            if num_keypoints == 18:
                seq = np.stack([add_neck_keypoint(fr) for fr in seq])
            else:
                seq = seq[:, :num_keypoints]
            if num_channels == 3:
                seq = np.concatenate([seq, np.ones((*seq.shape[:2], 1))], axis=-1)
            if normalize:
                seq = normalize_sequence(seq.astype(np.float32))
            poses[i] = seq
            labels[i] = 1 if is_anomaly else 0
        self.poses = poses
        self.labels = labels
        self.video_ids = [f"synthetic_{i // 16}" for i in range(num_samples)]
        self.frame_indices = [list(range(seq_len)) for _ in range(num_samples)]

    def _generate_sequence(self, rng: np.random.Generator, base: np.ndarray, is_anomaly: bool) -> np.ndarray:
        motion = 0.08 if is_anomaly else 0.02
        frames = []
        for t in range(self.seq_len):
            pose = base + rng.normal(0, motion, base.shape)
            if is_anomaly and t > self.seq_len // 2:
                # concealment: wrists move toward hips
                pose[LEFT_WRIST] = pose[LEFT_WRIST] * 0.7 + pose[LEFT_HIP] * 0.3
                pose[RIGHT_WRIST] = pose[RIGHT_WRIST] * 0.7 + pose[RIGHT_HIP] * 0.3
            frames.append(pose)
        return np.asarray(frames)

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        return self.poses[idx], int(self.labels[idx])

    def get_video_info(self, idx: int) -> Dict[str, Any]:
        return {
            "video_id": self.video_ids[idx],
            "frame_indices": self.frame_indices[idx],
            "label": int(self.labels[idx]),
        }

    @classmethod
    def from_config(cls, config: Dict[str, Any], split: str = "train") -> "SyntheticPoseLiftDataset":
        d = config["data"]
        m = config["model"]
        s = d.get("synthetic", {})
        train = split == "train"
        return cls(
            num_samples=int(s.get("num_train" if train else "num_test", 256)),
            seq_len=int(d.get("seq_len", 12)),
            num_keypoints=int(m.get("num_keypoints", 17)),
            num_channels=int(m.get("in_channels", 2)),
            anomaly_ratio=float(s.get("train_anomaly_ratio" if train else "test_anomaly_ratio", 0.0 if train else 0.3)),
            seed=int(config.get("experiment", {}).get("seed", 0)) + (0 if train else 1),
        )
