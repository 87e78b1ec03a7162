"""Multi-object track association (host side): persistent track IDs over
per-frame detections.

Replaces ultralytics' built-in tracker invoked by
``model.track(frame, persist=True, classes=[0])`` in the original pipeline,
whose persistent IDs become the BBox 'person' column. The
association itself is O(tracks x detections) host work on a handful of boxes
per frame — deliberately kept off-device so the device pipeline never blocks on
data-dependent shapes.

Algorithm: Hungarian assignment (scipy linear_sum_assignment) on the IoU
matrix with an IoU gate, greedy fallback when scipy is unavailable; tracks
survive `max_misses` missed frames before retiring (SORT-style, minus the
Kalman smoothing which the tiny inter-frame motion here doesn't need).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

try:
    from scipy.optimize import linear_sum_assignment

    _HAS_SCIPY = True
except Exception:  # pragma: no cover
    _HAS_SCIPY = False


def iou_matrix_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, (N,4) x (M,4) xyxy -> (N,M)."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return (inter / np.maximum(union, 1e-9)).astype(np.float32)


@dataclass
class Track:
    track_id: int
    box: np.ndarray  # xyxy
    score: float
    age: int = 1
    misses: int = 0
    hits: int = 1


class IoUTracker:
    """Persistent-ID tracker over per-frame detections."""

    def __init__(self, iou_threshold: float = 0.3, max_misses: int = 30, min_hits: int = 1):
        self.iou_threshold = iou_threshold
        self.max_misses = max_misses
        self.min_hits = min_hits
        self.tracks: List[Track] = []
        self._next_id = 1

    def reset(self) -> None:
        """New video -> fresh IDs (the reference re-instantiates per run;
        persist=True keeps state within one video)."""
        self.tracks = []
        self._next_id = 1

    def update(self, boxes: np.ndarray, scores: Optional[np.ndarray] = None) -> List[Tuple[int, np.ndarray, float]]:
        """Associate this frame's detections; returns [(track_id, box_xyxy, score)]
        for currently-confirmed tracks matched this frame.
        `update_with_indices` additionally reports each match's detection row."""
        return [(tid, box, score) for tid, box, score, _di in self.update_with_indices(boxes, scores)]

    def update_with_indices(
        self, boxes: np.ndarray, scores: Optional[np.ndarray] = None
    ) -> List[Tuple[int, np.ndarray, float, int]]:
        """Like update(), but each entry is (track_id, box, score, det_index) so
        callers can join auxiliary per-detection data (e.g. pose keypoints)."""
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        scores = np.asarray(scores, np.float32).reshape(-1) if scores is not None else np.ones(len(boxes), np.float32)
        track_boxes = np.stack([t.box for t in self.tracks]) if self.tracks else np.zeros((0, 4), np.float32)
        iou = iou_matrix_np(track_boxes, boxes)

        matched_tracks, matched_dets = self._assign(iou)
        out: List[Tuple[int, np.ndarray, float, int]] = []
        det_taken = set()
        for ti, di in zip(matched_tracks, matched_dets):
            t = self.tracks[ti]
            t.box = boxes[di]
            t.score = float(scores[di])
            t.hits += 1
            t.age += 1
            t.misses = 0
            det_taken.add(di)
            if t.hits >= self.min_hits:
                out.append((t.track_id, t.box.copy(), t.score, int(di)))

        # unmatched tracks age out
        matched_set = set(matched_tracks)
        survivors: List[Track] = []
        for i, t in enumerate(self.tracks):
            if i in matched_set:
                survivors.append(t)
            else:
                t.misses += 1
                t.age += 1
                if t.misses <= self.max_misses:
                    survivors.append(t)
        self.tracks = survivors

        # unmatched detections spawn new tracks
        for di in range(len(boxes)):
            if di in det_taken:
                continue
            t = Track(self._next_id, boxes[di].copy(), float(scores[di]))
            self._next_id += 1
            self.tracks.append(t)
            if t.hits >= self.min_hits:
                out.append((t.track_id, t.box.copy(), t.score, int(di)))
        return out

    def _assign(self, iou: np.ndarray) -> Tuple[List[int], List[int]]:
        if iou.size == 0:
            return [], []
        if _HAS_SCIPY:
            rows, cols = linear_sum_assignment(-iou)
            pairs = [(r, c) for r, c in zip(rows, cols) if iou[r, c] >= self.iou_threshold]
        else:  # greedy
            pairs = []
            m = iou.copy()
            while True:
                r, c = np.unravel_index(np.argmax(m), m.shape)
                if m[r, c] < self.iou_threshold:
                    break
                pairs.append((r, c))
                m[r, :] = -1
                m[:, c] = -1
        return [p[0] for p in pairs], [p[1] for p in pairs]
