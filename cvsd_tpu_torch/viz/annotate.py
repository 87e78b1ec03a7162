"""Annotated-video output: boxes, track IDs, pose skeletons, anomaly scores
(PyTorch port of ``cvsd_tpu/viz/annotate.py``).

``annotate_video`` streams a video through detect -> track -> pose ->
Shopformer scoring and writes an mp4 with the detections and each track's
anomaly score drawn in. It makes two passes over the video: pass 1 streams
(device work; the detections of every frame come from
``StreamingPipeline.stream_video(on_frame=...)``), pass 2 decodes again and
draws with the whole score timeline, so every frame of a scored window
shows its window's score. ``annotate_video_detections`` draws the
detector's tracked boxes alone. Drawing is cv2 on the host, imported where
it is needed (an error names it where it is missing): an offline surface,
not the serving path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from cvsd_tpu_torch.data.video import _cv2
from cvsd_tpu_torch.models.graph import _COCO_EDGES

# Stable, distinguishable per-track colors (BGR).
_PALETTE = (
    (80, 175, 76), (184, 126, 55), (28, 26, 228), (163, 78, 152),
    (0, 127, 255), (51, 255, 255), (40, 86, 166), (191, 129, 247),
    (153, 153, 153), (14, 201, 255),
)


def _track_color(track_id: int) -> Tuple[int, int, int]:
    return _PALETTE[int(track_id) % len(_PALETTE)]


def _score_color(score: float, threshold: float) -> Tuple[int, int, int]:
    """Green below threshold -> red above (BGR), saturating at 2x threshold."""
    t = float(np.clip(score / max(2.0 * threshold, 1e-9), 0.0, 1.0))
    return (0, int(round(255 * (1.0 - t))), int(round(255 * t)))


def draw_detections(
    frame_bgr: np.ndarray,
    dets: Sequence[Dict[str, Any]],
    anomaly: Optional[Dict[int, float]] = None,
    threshold: float = 0.5,
    banner: Optional[str] = None,
) -> np.ndarray:
    """Draw tracked detections onto one BGR frame (in place; also returned).

    dets: [{'track_id', 'box' (4,) xyxy px, 'score', 'kpts' (17, >=2) px | None}]
    anomaly: optional {track_id: latest window anomaly score}, shown in the
    label and as the box color (green -> red around ``threshold``).
    """
    cv2 = _cv2()
    anomaly = anomaly or {}
    for d in dets:
        tid = int(d["track_id"])
        x1, y1, x2, y2 = (int(round(v)) for v in np.asarray(d["box"])[:4])
        a = anomaly.get(tid)
        color = _score_color(a, threshold) if a is not None else _track_color(tid)
        cv2.rectangle(frame_bgr, (x1, y1), (x2, y2), color, 2)
        label = f"id{tid} {d.get('score', 0.0):.2f}"
        if a is not None:
            label += f" a={a:.2f}"
        (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.45, 1)
        ty = y1 - 4 if y1 - th - 6 >= 0 else y2 + th + 4
        cv2.rectangle(frame_bgr, (x1, ty - th - 3), (x1 + tw + 2, ty + 2), color, -1)
        cv2.putText(frame_bgr, label, (x1 + 1, ty - 1), cv2.FONT_HERSHEY_SIMPLEX,
                    0.45, (255, 255, 255), 1, cv2.LINE_AA)
        k = d.get("kpts")
        if k is not None:
            k = np.asarray(k)
            for i, j in _COCO_EDGES:
                if i < len(k) and j < len(k):
                    cv2.line(frame_bgr,
                             (int(round(k[i, 0])), int(round(k[i, 1]))),
                             (int(round(k[j, 0])), int(round(k[j, 1]))),
                             color, 1, cv2.LINE_AA)
            for p in k:
                cv2.circle(frame_bgr, (int(round(p[0])), int(round(p[1]))), 2,
                           (255, 255, 255), -1, cv2.LINE_AA)
    if banner:
        cv2.putText(frame_bgr, banner, (6, 16), cv2.FONT_HERSHEY_SIMPLEX,
                    0.45, (255, 255, 255), 1, cv2.LINE_AA)
    return frame_bgr


def _write_annotated(video_path: str, out_path: str, fourcc: str, draw) -> int:
    """Decode ``video_path`` again, ``draw(frame_bgr, frame_no)`` on each
    frame (1-based), write the mp4; returns the frames written."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not writer.isOpened():
        cap.release()
        raise RuntimeError(f"cannot open writer for {out_path}")
    n = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            draw(frame, n + 1)  # CAP_PROP_POS_FRAMES convention (1-based)
            writer.write(frame)
            n += 1
    finally:
        writer.release()
        cap.release()
    return n


def annotate_video_detections(detection, video_path: str, out_path: str,
                              fourcc: str = "mp4v") -> Dict[str, Any]:
    """Detector-only annotation: boxes and persistent track IDs (and
    skeletons where the model has a keypoint source), no anomaly model.
    Returns {'frames', 'detections', 'out_path'}."""
    from cvsd_tpu_torch.data.video import VideoBatcher
    from cvsd_tpu_torch.ops.letterbox import letterbox_params
    from cvsd_tpu_torch.track import make_tracker

    _cv2()
    tracker = make_tracker(detection.config.get("detector"))
    batcher = VideoBatcher(video_path, batch_size=detection.batch_size)
    src_h, src_w = batcher.info.height, batcher.info.width
    size = detection._canvas_size(src_h, src_w)
    scale, pad_x, pad_y, _, _ = letterbox_params(src_h, src_w, size)
    per_frame: Dict[int, List[Dict[str, Any]]] = {}
    n_dets = 0
    for batch in batcher:
        outs = detection.detect_frames(batch.frames)
        boxes_src, _xywhn, scores, valid = outs[:4]
        kpts = outs[4] if len(outs) > 4 else None
        for b in range(batch.frames.shape[0]):
            if not batch.mask[b]:
                continue
            v = valid[b]
            tracked = tracker.update_with_indices(boxes_src[b][v], scores[b][v])
            dets = []
            for tid, box, sc, di in tracked:
                k = None
                if kpts is not None:
                    k = kpts[b][v][di][:, :2].copy()
                    k[:, 0] = (k[:, 0] - pad_x) / scale
                    k[:, 1] = (k[:, 1] - pad_y) / scale
                dets.append({"track_id": tid, "box": np.asarray(box, np.float32),
                             "score": float(sc), "kpts": k})
            per_frame[int(batch.frame_numbers[b])] = dets
            n_dets += len(dets)

    n = _write_annotated(video_path, out_path, fourcc, lambda frame, no: draw_detections(
        frame, per_frame.get(no, []), banner=f"f{no}"))
    return {"frames": n, "detections": n_dets, "out_path": out_path}


def annotate_video(pipeline, video_path: str, out_path: str, threshold: float = 0.5,
                   fourcc: str = "mp4v", video_name: Optional[str] = None) -> Dict[str, Any]:
    """Stream ``video_path`` through the pipeline and write an annotated mp4.

    Pass 1 runs ``StreamingPipeline.stream_video`` with the per-frame hook,
    collecting detections and scored windows; each window's score is then
    assigned to every (track, frame) it covers (later windows win: the
    latest evidence). Pass 2 decodes again and draws.

    Returns {'events', 'frames', 'out_path', 'max_score'}."""
    _cv2()
    per_frame: Dict[int, List[Dict[str, Any]]] = {}
    stamps: Dict[int, float] = {}

    def on_frame(frame_no: int, stamp: float, dets: List[Dict[str, Any]]) -> None:
        per_frame[frame_no] = dets or []
        stamps[frame_no] = stamp

    events = list(pipeline.stream_video(video_path, video_name=video_name, on_frame=on_frame))

    # score timeline: (track_id, frame) -> window score, later windows win
    score_at: Dict[Tuple[int, int], float] = {}
    for e in sorted(events, key=lambda e: e.frame_end):
        for fr in e.frames:
            score_at[(e.track_id, fr)] = e.score

    max_score = 0.0

    def draw(frame, frame_no: int) -> None:
        nonlocal max_score
        dets = per_frame.get(frame_no, [])
        anomaly = {int(d["track_id"]): score_at[(int(d["track_id"]), frame_no)]
                   for d in dets if (int(d["track_id"]), frame_no) in score_at}
        banner = f"f{frame_no} t={stamps.get(frame_no, 0.0):.0f}ms"
        if anomaly:
            top = max(anomaly.values())
            max_score = max(max_score, top)
            banner += f" anomaly={top:.2f}" + (" !" if top >= threshold else "")
        draw_detections(frame, dets, anomaly, threshold, banner)

    n = _write_annotated(video_path, out_path, fourcc, draw)
    return {"events": [dataclasses.asdict(e) for e in events], "frames": n,
            "out_path": out_path, "max_score": max_score}
