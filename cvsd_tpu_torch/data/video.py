"""Video ingestion: fixed-shape RGB frame batches with a prefetch thread
(the port's copy of ``cvsd_tpu/data/video.py`` without the native decode and
ring-buffer paths, which are not ported yet). ``cv2`` is imported only where
a video file is opened: the machine with the card may not have it.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:  # pragma: no cover - depends on the host
        raise RuntimeError("OpenCV (cv2) is needed to read video files") from e
    return cv2


@dataclass
class VideoInfo:
    width: int
    height: int
    fps: float
    num_frames: int


def video_info(path: str) -> VideoInfo:
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video {path}")
        return VideoInfo(
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=float(cap.get(cv2.CAP_PROP_FPS)),
            num_frames=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        )
    finally:
        cap.release()


@dataclass
class FrameBatch:
    frames: np.ndarray        # (B, H, W, 3) RGB uint8
    frame_numbers: np.ndarray  # (B,) int32, 1-based (CAP_PROP_POS_FRAMES after read)
    mask: np.ndarray          # (B,) bool, False on tail padding
    timestamps_ms: np.ndarray  # (B,) float64


class VideoBatcher:
    """Iterate a video as fixed-shape RGB frame batches; a producer thread
    decodes ahead into a bounded queue (cv2 releases the GIL while decoding)."""

    def __init__(self, path: str, batch_size: int = 32, prefetch: int = 2,
                 bgr_to_rgb: bool = True, use_native_ring: Optional[bool] = None,
                 use_native_decode: Optional[bool] = None, frame_stride: int = 1):
        if use_native_ring or use_native_decode:
            raise NotImplementedError(
                "native decode / ring buffer is not ported yet: ROADMAP.md, deferred items")
        self.path = path
        self.batch_size = int(batch_size)
        self.prefetch = int(prefetch)
        self.bgr_to_rgb = bgr_to_rgb
        # frame_stride=N yields source frames 1, 1+N, 2N+1, ...; skipped
        # frames are cap.grab()'d (codec advances, no convert/copy)
        self.frame_stride = max(1, int(frame_stride))
        self.info = video_info(path)

    def __iter__(self) -> Iterator[FrameBatch]:
        q: "queue.Queue[Optional[FrameBatch]]" = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._producer, args=(q,), daemon=True)
        t.start()
        while True:
            batch = q.get()
            if batch is None:
                break
            yield batch
        t.join()

    def _producer(self, q: "queue.Queue[Optional[FrameBatch]]") -> None:
        cv2 = _cv2()
        cap = cv2.VideoCapture(self.path)
        H, W = self.info.height, self.info.width
        B = self.batch_size
        try:
            if not cap.isOpened():
                return
            frames = np.zeros((B, H, W, 3), np.uint8)
            numbers = np.zeros(B, np.int32)
            stamps = np.zeros(B, np.float64)
            k = 0
            frame_no = 0
            while True:
                ok = True
                if frame_no > 0:  # frame_stride: advance via grab()
                    for _ in range(self.frame_stride - 1):
                        if not cap.grab():
                            ok = False
                            break
                if ok:
                    ok, frame = cap.read()
                if not ok:
                    break
                frame_no = 1 if frame_no == 0 else frame_no + self.frame_stride
                if frame.shape[:2] != (H, W):  # defensive: some codecs lie
                    frame = cv2.resize(frame, (W, H))
                frames[k] = frame[..., ::-1] if self.bgr_to_rgb else frame
                numbers[k] = frame_no
                stamps[k] = cap.get(cv2.CAP_PROP_POS_MSEC)
                k += 1
                if k == B:
                    mask = np.ones(B, bool)
                    q.put(FrameBatch(frames.copy(), numbers.copy(), mask, stamps.copy()))
                    k = 0
            if k > 0:
                mask = np.zeros(B, bool)
                mask[:k] = True
                frames[k:] = 0  # deterministic padding
                numbers[k:] = 0
                stamps[k:] = 0.0
                q.put(FrameBatch(frames.copy(), numbers.copy(), mask, stamps.copy()))
        finally:
            cap.release()
            q.put(None)


def write_test_video(path: str, num_frames: int = 48, width: int = 320, height: int = 240,
                     fps: float = 30.0, seed: int = 0) -> str:
    """Write a small mp4 (moving bright rectangles on noise), the stand-in
    for UCF-Crime clips in tests and on the card; the same frames and codec
    as the JAX package's ``write_test_video``."""
    cv2 = _cv2()
    rng = np.random.default_rng(seed)
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    w = cv2.VideoWriter(path, fourcc, fps, (width, height))
    try:
        for t in range(num_frames):
            frame = rng.integers(0, 60, (height, width, 3)).astype(np.uint8)
            x = int((t / max(num_frames - 1, 1)) * (width - 60))
            frame[40:140, x : x + 50] = (220, 180, 120)
            frame[height - 120 : height - 30, width - 90 : width - 40] = (120, 220, 160)
            w.write(frame)
    finally:
        w.release()
    return path
