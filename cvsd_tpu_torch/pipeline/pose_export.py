"""Pose-dataset generation: videos -> PoseLift-format pickle and GT files
(PyTorch port of ``cvsd_tpu/pipeline/pose_export.py``).

The detector's pose head (or the top-down pose net) runs over videos and
writes the layout the PoseLift data layer reads
(``data/poselift.py``): ``Pickle_files/{split}/<video>.pkl`` holding
``{frame: {person_id: [bbox_xyxy, (17, 3) keypoints]}}`` in source pixels,
and for the Test split ``Pickle_files/GT/<video>.npy``, the per-frame labels
of the UCF-Crime temporal annotations. Videos are decoded with cv2.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional, Sequence

import numpy as np

from cvsd_tpu_torch.data.ucf_crime import TemporalAnnotation
from cvsd_tpu_torch.data.video import VideoBatcher
from cvsd_tpu_torch.ops.letterbox import letterbox_params
from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline
from cvsd_tpu_torch.track import make_tracker


def extract_pose_data(pipeline: DetectionPipeline, video_path: str) -> Dict[int, Dict[int, list]]:
    """One video -> ``{frame: {person_id: [bbox_xyxy, (17, 3) keypoints]}}``
    in source-pixel coordinates (float64, the PoseLift convention); frames
    with no track are left out."""
    if not (pipeline.model.num_keypoints or pipeline.pose_model is not None):
        raise ValueError("a keypoint source is required (detector.pose_head=true or "
                         "pose_mode='topdown')")
    tracker = make_tracker(pipeline.config.get("detector"))
    out: Dict[int, Dict[int, list]] = {}
    batcher = VideoBatcher(video_path, batch_size=pipeline.batch_size)
    src_h, src_w = batcher.info.height, batcher.info.width
    size = pipeline._canvas_size(src_h, src_w)
    scale, pad_x, pad_y, _, _ = letterbox_params(src_h, src_w, size)
    for batch in batcher:
        boxes_src, _xywhn, scores, valid, kpts = pipeline.detect_frames(batch.frames)
        for b in range(batch.frames.shape[0]):
            if not batch.mask[b]:
                continue
            v = valid[b]
            tracked = tracker.update_with_indices(boxes_src[b][v], scores[b][v])
            if not tracked:
                continue
            det_kpts = kpts[b][v]
            frame_entry: Dict[int, list] = {}
            for track_id, box, _s, di in tracked:
                k = det_kpts[di].astype(np.float64).copy()  # (17, 3) x, y, conf
                k[:, 0] = (k[:, 0] - pad_x) / scale
                k[:, 1] = (k[:, 1] - pad_y) / scale
                frame_entry[int(track_id)] = [np.asarray(box, np.float64), k]
            out[int(batch.frame_numbers[b])] = frame_entry
    return out


def export_poselift_dataset(
    pipeline: DetectionPipeline,
    videos: Sequence[str],
    output_dir: str,
    split: str = "Train",
    annotations: Optional[Dict[str, TemporalAnnotation]] = None,
    verbose: bool = True,
) -> Dict[str, Any]:
    """Write Pickle_files/{split}/<video>.pkl (and GT/<video>.npy for Test)
    in the PoseLift directory layout; returns {'videos', 'frames', 'persons'}."""
    pose_dir = os.path.join(output_dir, "Pickle_files", split)
    os.makedirs(pose_dir, exist_ok=True)
    gt_dir = None
    if split == "Test":
        gt_dir = os.path.join(output_dir, "Pickle_files", "GT")
        os.makedirs(gt_dir, exist_ok=True)
    stats = {"videos": 0, "frames": 0, "persons": set()}
    for path in videos:
        name = os.path.splitext(os.path.basename(path))[0]
        data = extract_pose_data(pipeline, path)
        with open(os.path.join(pose_dir, f"{name}.pkl"), "wb") as f:
            pickle.dump(data, f)
        if gt_dir is not None:
            n_frames = max(data.keys(), default=0)
            ann = (annotations or {}).get(name)
            gt = np.array([ann.frame_label(i + 1) if ann else 0 for i in range(n_frames)],
                          dtype=np.float64)
            np.save(os.path.join(gt_dir, f"{name}.npy"), gt)
        stats["videos"] += 1
        stats["frames"] += len(data)
        for fr in data.values():
            stats["persons"].update(fr.keys())
        if verbose:
            print(f"exported {name}: {len(data)} frames")
    stats["persons"] = len(stats["persons"])
    return stats
