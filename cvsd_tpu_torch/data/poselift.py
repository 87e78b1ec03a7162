"""PoseLift pose-sequence ingestion (host side; the port's copy of
``cvsd_tpu/data/poselift.py``, numpy only).

- pickle ingestion of ``{frame: {person_id: [bbox, (17,3) keypoints]}}``
  plus ``GT/*.npy`` frame labels for the test split
- NaN/inf keypoint filtering at load
- per-person sliding windows (seq_len, stride) with a continuity check
  (max frame gap) and per-sequence majority-vote labels
- per-sequence normalization: center on the valid-keypoint mean, scale by
  the max |centered| coordinate
- optional synthetic 18th "neck" keypoint (shoulder midpoint with
  missing-shoulder fallbacks) for the paper's 144-dim embedding
- per-sample video_id / frame_indices metadata for video-level eval

Samples are materialized once into one dense ``(N, T, V, C) float32`` array;
the streaming scorer shares the window helpers.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


class PoseLiftDataset:
    """In-memory PoseLift dataset producing dense (N, T, V, C) float32 arrays."""

    def __init__(
        self,
        data_dir: str,
        split: str = "train",
        seq_len: int = 12,
        stride: int = 6,
        num_keypoints: int = 18,
        normalize: bool = True,
        include_confidence: bool = False,
        max_gap: int = 5,
        verbose: bool = True,
    ):
        self.data_dir = Path(data_dir)
        self.split = split
        self.seq_len = int(seq_len)
        self.stride = int(stride)
        self.num_keypoints = int(num_keypoints)
        self.normalize = normalize
        self.include_confidence = include_confidence
        self.num_channels = 3 if include_confidence else 2
        self.max_gap = int(max_gap)

        samples: List[np.ndarray] = []
        labels: List[int] = []
        video_ids: List[str] = []
        frame_indices: List[List[int]] = []

        split_folder = "Train" if split == "train" else "Test"
        pose_dir = self.data_dir / "Pickle_files" / split_folder
        if not pose_dir.exists():
            raise FileNotFoundError(f"Pose directory not found: {pose_dir}")
        label_dir = self.data_dir / "Pickle_files" / "GT" if split == "test" else None

        for pkl_file in sorted(pose_dir.glob("*.pkl")):
            video_name = pkl_file.stem
            with open(pkl_file, "rb") as f:
                pose_data = pickle.load(f)
            frame_labels = None
            if label_dir is not None:
                lf = label_dir / f"{video_name}.npy"
                if lf.exists():
                    frame_labels = np.load(lf)
            self._extract_sequences(pose_data, frame_labels, video_name, samples, labels, video_ids, frame_indices)

        self.poses = (
            np.stack(samples).astype(np.float32)
            if samples
            else np.zeros((0, self.seq_len, self.num_keypoints, self.num_channels), np.float32)
        )
        self.labels = np.asarray(labels, dtype=np.int32)
        self.video_ids = video_ids
        self.frame_indices = frame_indices
        if verbose:
            print(f"Loaded {len(self)} sequences from {split_folder} split")
            if split == "test":
                n_anom = int(self.labels.sum())
                print(f"  Normal: {len(self) - n_anom}, Anomaly: {n_anom}")

    # -- windowing ---------------------------------------------------------

    def _extract_sequences(self, pose_data, frame_labels, video_name, samples, labels, video_ids, frame_indices_out):
        person_poses: Dict[Any, Dict[int, np.ndarray]] = {}
        for frame_num, frame_data in pose_data.items():
            if not frame_data or not isinstance(frame_data, dict):
                continue
            for person_id, person_data in frame_data.items():
                if not isinstance(person_data, (list, tuple)) or len(person_data) < 2:
                    continue
                kpts = np.asarray(person_data[1], dtype=np.float64)
                if kpts.size == 0 or np.any(np.isnan(kpts)) or np.any(np.isinf(kpts)):
                    continue
                person_poses.setdefault(person_id, {})[int(frame_num)] = kpts

        for _person_id, frames in person_poses.items():
            sorted_frames = sorted(frames.keys())
            if len(sorted_frames) < self.seq_len:
                continue
            for start in range(0, len(sorted_frames) - self.seq_len + 1, self.stride):
                window = sorted_frames[start : start + self.seq_len]
                if not check_continuity(window, self.max_gap):
                    continue
                seq = self._build_sequence(frames, window)
                if seq is None:
                    continue
                if frame_labels is not None:
                    votes = [int(frame_labels[min(f, len(frame_labels) - 1)]) for f in window]
                    label = 1 if sum(votes) > len(votes) // 2 else 0
                else:
                    label = 0  # training split is all-normal
                samples.append(seq)
                labels.append(label)
                video_ids.append(video_name)
                frame_indices_out.append(list(window))

    def _build_sequence(self, frames: Dict[int, np.ndarray], window: Sequence[int]) -> Optional[np.ndarray]:
        seq = []
        for f in window:
            kpts = frames.get(f)
            if kpts is None:
                return None
            if kpts.ndim == 1:
                kpts = kpts.reshape(-1, 3)
            if kpts.shape[0] < 17:
                kpts = np.vstack([kpts, np.zeros((17 - kpts.shape[0], kpts.shape[1]))])
            if self.num_keypoints == 18:
                kpts = add_neck_keypoint(kpts)
            else:
                kpts = kpts[: self.num_keypoints]
            pose = kpts[:, : self.num_channels]
            if pose.shape[1] < self.num_channels:
                pose = np.hstack([pose, np.zeros((pose.shape[0], self.num_channels - pose.shape[1]))])
            seq.append(pose)
        out = np.asarray(seq, dtype=np.float32)  # (T, V, C)
        if self.normalize:
            out = normalize_sequence(out)
        return out

    # -- container protocol --------------------------------------------------

    def __len__(self) -> int:
        return int(self.poses.shape[0])

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        return self.poses[idx], int(self.labels[idx])

    def get_video_info(self, idx: int) -> Dict[str, Any]:
        """Sample metadata for video-level eval
        (reference: shopformer_2/data/poselift_dataset.py:591-597)."""
        return {
            "video_id": self.video_ids[idx],
            "frame_indices": self.frame_indices[idx],
            "label": int(self.labels[idx]),
        }

    @classmethod
    def from_config(cls, config: Dict[str, Any], split: str = "train", verbose: bool = True) -> "PoseLiftDataset":
        d = config["data"]
        m = config["model"]
        return cls(
            data_dir=d["data_dir"],
            split=split,
            seq_len=int(d.get("seq_len", m.get("seq_len", 12))),
            stride=int(d.get("stride", 6)),
            num_keypoints=int(m.get("num_keypoints", 18)),
            normalize=bool(d.get("normalize", True)),
            include_confidence=bool(d.get("include_confidence", False)),
            max_gap=int(d.get("max_gap", 5)),
            verbose=verbose,
        )
