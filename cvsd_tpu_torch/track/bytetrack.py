"""ByteTrack-style tracker: Kalman motion + two-stage association.

The original pipeline's `model.track(frame, persist=True)` runs
ultralytics' default BoT-SORT/ByteTrack tracker — a
Kalman constant-velocity motion model with two-stage association (high-
confidence detections first, then the low-confidence leftovers rescue
occluded tracks; Zhang et al., ByteTrack, ECCV 2022). IoUTracker
(track/tracker.py) covers the association core; this adds the motion model
and the byte second stage, so fast movers and detector-confidence dips keep
their IDs — the 'person' column of the BBox schema and the per-track pose
windows both depend on ID stability.

API-compatible with IoUTracker (update / update_with_indices / reset);
select via config `detector.tracker: iou|byte` (track/__init__.py::
make_tracker). Host-side by design, like the rest of the association code.
Measured host cost (4 persons/frame): ~0.30 ms/frame vs the IoU tracker's
~0.05 — opt-in because the streaming steady state is host-bound; choose it
when ID stability through occlusion matters more than ~10-15% throughput.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from cvsd_tpu_torch.track.tracker import iou_matrix_np

try:
    from scipy.optimize import linear_sum_assignment

    _HAS_SCIPY = True
except Exception:  # pragma: no cover
    _HAS_SCIPY = False


class _Kalman:
    """Constant-velocity Kalman filter on (cx, cy, w, h) + velocities.

    Noise scales follow the ByteTrack convention: position std ~ h/20,
    velocity std ~ h/160 (scale-adaptive, so large boxes tolerate larger
    absolute motion)."""

    _POS_W = 1.0 / 20.0
    _VEL_W = 1.0 / 160.0

    def __init__(self, box_cxcywh: np.ndarray):
        self.x = np.zeros(8, np.float64)
        self.x[:4] = box_cxcywh
        h = max(float(box_cxcywh[3]), 1.0)
        self.P = np.diag(np.square([
            2 * self._POS_W * h, 2 * self._POS_W * h,
            2 * self._POS_W * h, 2 * self._POS_W * h,
            10 * self._VEL_W * h, 10 * self._VEL_W * h,
            10 * self._VEL_W * h, 10 * self._VEL_W * h,
        ]))
        self.F = np.eye(8)
        self.F[:4, 4:] = np.eye(4)
        self.H = np.eye(4, 8)

    def predict(self) -> np.ndarray:
        h = max(float(self.x[3]), 1.0)
        q = np.square([self._POS_W * h] * 4 + [self._VEL_W * h] * 4)
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + np.diag(q)
        return self.x[:4].copy()

    def update(self, z: np.ndarray) -> None:
        h = max(float(self.x[3]), 1.0)
        R = np.diag(np.square([self._POS_W * h] * 4))
        S = self.H @ self.P @ self.H.T + R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ (np.asarray(z, np.float64) - self.H @ self.x)
        self.P = (np.eye(8) - K @ self.H) @ self.P


def _to_cxcywh(b: np.ndarray) -> np.ndarray:
    return np.array([(b[0] + b[2]) / 2, (b[1] + b[3]) / 2,
                     b[2] - b[0], b[3] - b[1]], np.float64)


def _to_xyxy(c: np.ndarray) -> np.ndarray:
    return np.array([c[0] - c[2] / 2, c[1] - c[3] / 2,
                     c[0] + c[2] / 2, c[1] + c[3] / 2], np.float32)


class _BTrack:
    def __init__(self, track_id: int, box: np.ndarray, score: float):
        self.track_id = track_id
        self.kf = _Kalman(_to_cxcywh(box))
        self.box = np.asarray(box, np.float32)
        self.score = float(score)
        self.hits = 1
        self.misses = 0

    def predict(self) -> np.ndarray:
        self.box = _to_xyxy(self.kf.predict())
        return self.box

    def update(self, box: np.ndarray, score: float) -> None:
        self.kf.update(_to_cxcywh(box))
        self.box = _to_xyxy(self.kf.x[:4])
        self.score = float(score)
        self.hits += 1
        self.misses = 0


class ByteTracker:
    """Two-stage Kalman tracker, IoUTracker-API-compatible.

    high_thresh: detections >= this associate in stage 1 and may spawn
    tracks; low_thresh..high_thresh detections only RESCUE existing tracks
    (stage 2) — ByteTrack's core idea: an occluded person usually still
    produces a low-confidence box.
    """

    def __init__(self, iou_threshold: float = 0.2, max_misses: int = 30,
                 min_hits: int = 1, high_thresh: float = 0.5,
                 low_thresh: float = 0.1):
        self.iou_threshold = float(iou_threshold)
        self.max_misses = int(max_misses)
        self.min_hits = int(min_hits)
        self.high_thresh = float(high_thresh)
        self.low_thresh = float(low_thresh)
        self.tracks: List[_BTrack] = []
        self._next_id = 1

    def reset(self) -> None:
        self.tracks = []
        self._next_id = 1

    def _assign(self, iou: np.ndarray, gate: float) -> Tuple[List[int], List[int]]:
        if iou.size == 0:
            return [], []
        if _HAS_SCIPY:
            rows, cols = linear_sum_assignment(-iou)
            pairs = [(r, c) for r, c in zip(rows, cols) if iou[r, c] >= gate]
        else:
            pairs = []
            m = iou.copy()
            while True:
                r, c = np.unravel_index(np.argmax(m), m.shape)
                if m[r, c] < gate:
                    break
                pairs.append((r, c))
                m[r, :] = -1
                m[:, c] = -1
        return [p[0] for p in pairs], [p[1] for p in pairs]

    def update(self, boxes: np.ndarray, scores: Optional[np.ndarray] = None):
        return [(tid, box, score)
                for tid, box, score, _di in self.update_with_indices(boxes, scores)]

    def update_with_indices(
        self, boxes: np.ndarray, scores: Optional[np.ndarray] = None
    ) -> List[Tuple[int, np.ndarray, float, int]]:
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        scores = (np.asarray(scores, np.float32).reshape(-1)
                  if scores is not None else np.ones(len(boxes), np.float32))

        # motion-predict every track to THIS frame before associating
        pred = (np.stack([t.predict() for t in self.tracks])
                if self.tracks else np.zeros((0, 4), np.float32))

        hi = np.where(scores >= self.high_thresh)[0]
        lo = np.where((scores >= self.low_thresh)
                      & (scores < self.high_thresh))[0]

        out: List[Tuple[int, np.ndarray, float, int]] = []
        matched_tracks: set = set()
        det_taken: set = set()

        def associate(track_idx: List[int], det_idx: np.ndarray, gate: float):
            if not len(track_idx) or not len(det_idx):
                return
            iou = iou_matrix_np(pred[track_idx], boxes[det_idx])
            trs, dts = self._assign(iou, gate)
            for tr, dt in zip(trs, dts):
                ti, di = track_idx[tr], int(det_idx[dt])
                t = self.tracks[ti]
                t.update(boxes[di], scores[di])
                matched_tracks.add(ti)
                det_taken.add(di)
                if t.hits >= self.min_hits:
                    # report the DETECTED box (what downstream geometry uses),
                    # not the smoothed state
                    out.append((t.track_id, boxes[di].copy(),
                                float(scores[di]), di))

        # stage 1: all tracks x high-confidence detections
        associate(list(range(len(self.tracks))), hi, self.iou_threshold)
        # stage 2 (byte): leftover tracks x low-confidence detections —
        # stricter gate, since low boxes are noisy
        remaining = [i for i in range(len(self.tracks)) if i not in matched_tracks]
        associate(remaining, lo, max(self.iou_threshold, 0.3))

        survivors: List[_BTrack] = []
        for i, t in enumerate(self.tracks):
            if i in matched_tracks:
                survivors.append(t)
            else:
                t.misses += 1
                if t.misses <= self.max_misses:
                    survivors.append(t)
        self.tracks = survivors

        # only HIGH-confidence leftovers spawn tracks (ByteTrack rule)
        for di in hi:
            di = int(di)
            if di in det_taken:
                continue
            t = _BTrack(self._next_id, boxes[di], float(scores[di]))
            self._next_id += 1
            self.tracks.append(t)
            if t.hits >= self.min_hits:
                out.append((t.track_id, boxes[di].copy(), float(scores[di]), di))
        return out
