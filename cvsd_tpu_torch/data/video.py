"""Video ingestion: fixed-shape RGB frame batches with a prefetch thread
(the port's copy of ``cvsd_tpu/data/video.py``), decoded by cv2 or by the
native multi-stream decoder and staged through a Python queue or the native
ring buffer (``cvsd_tpu_torch/native/``). ``cv2`` is imported only where a
video file is opened: the machine with the card may not have it.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

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
    decodes ahead (cv2 and the native decoder release the GIL while they
    decode).

    The host path follows the reference's rule, each part on its own flag:
    unset, native exactly when its library builds; ``True`` builds it or
    raises; ``False`` is the Python path.
    - ``use_native_decode``: the native multi-stream decoder
      (``csrc/host/video_decode.cpp``, where opencv4 is installed) fills a
      whole batch in one call; RGB only (``bgr_to_rgb``).
    - ``use_native_ring``: batches are staged through the native ring buffer
      (``csrc/host/ring_buffer.cpp``): the producer decodes straight into a
      preallocated slot, the consumer copies it out and releases it (bounded
      memory, no Python-queue churn).
    The frames and frame numbers are the same on every path (the stamps are
    the decoder's: see ``native/video.py``)."""

    def __init__(self, path: str, batch_size: int = 32, prefetch: int = 2,
                 bgr_to_rgb: bool = True, use_native_ring: Optional[bool] = None,
                 use_native_decode: Optional[bool] = None, frame_stride: int = 1):
        from cvsd_tpu_torch import native
        from cvsd_tpu_torch.native import video as native_video

        self.path = path
        self.batch_size = int(batch_size)
        self.prefetch = int(prefetch)
        self.bgr_to_rgb = bgr_to_rgb
        # frame_stride=N yields source frames 1, 1+N, 2N+1, ...; skipped
        # frames are cap.grab()'d (codec advances, no convert/copy)
        self.frame_stride = max(1, int(frame_stride))
        self.info = video_info(path)
        # the decoder converts to RGB: a BGR batcher decodes with cv2
        self.use_native_decode = bool(bgr_to_rgb) and native_video.use_native_decode(
            use_native_decode)
        self.use_native_ring = native.use_native_ring(use_native_ring)

    @property
    def host_path(self) -> Dict[str, str]:
        """Which host path each part takes: {'decode', 'ring'} -> 'native' | 'python'."""
        return {"decode": "native" if self.use_native_decode else "python",
                "ring": "native" if self.use_native_ring else "python"}

    def __iter__(self) -> Iterator[FrameBatch]:
        if self.use_native_ring:
            yield from self._iter_native_ring()
            return
        q: "queue.Queue[Optional[FrameBatch]]" = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._producer, args=(q,), daemon=True)
        t.start()
        while True:
            batch = q.get()
            if batch is None:
                break
            yield batch
        t.join()

    def _open_native_decoder(self):
        from cvsd_tpu_torch.native.video import MODE_RAW, MultiStreamDecoder

        return MultiStreamDecoder([self.path], 1, (self.info.height, self.info.width),
                                  MODE_RAW, frame_stride=self.frame_stride)

    def _fill_cv2(self, cap, frames: np.ndarray, numbers: np.ndarray, stamps: np.ndarray,
                  frame_no: int) -> Tuple[int, int]:
        """Read up to len(frames) frames into the buffers -> (k read, the
        last frame number)."""
        cv2 = _cv2()
        H, W = self.info.height, self.info.width
        k = 0
        while k < frames.shape[0]:
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
        return k, frame_no

    def _iter_native_ring(self) -> Iterator[FrameBatch]:
        from cvsd_tpu_torch import native

        H, W, B = self.info.height, self.info.width, self.batch_size
        rb = native.NativeRingBuffer(slots=self.prefetch + 1, shape=(B, H, W, 3),
                                     dtype=np.uint8)
        meta: Dict[int, Any] = {}  # per slot: (numbers, stamps, mask), None at the end
        error: List[BaseException] = []

        def commit(slot: int, frames: np.ndarray, numbers, stamps, k: int) -> bool:
            """Publish one slot; False once the source is done."""
            if k == 0:
                meta[slot] = None
                rb.commit_write(slot)
                return False
            mask = np.zeros(B, bool)
            mask[:k] = True
            frames[k:] = 0  # deterministic padding (slots are reused)
            meta[slot] = (numbers, stamps, mask)
            rb.commit_write(slot)
            return k == B

        def producer_native() -> None:
            # construct inside the try: a failure must still close the ring,
            # or the consumer blocks forever
            dec = None
            try:
                dec = self._open_native_decoder()
                while True:
                    slot = rb.acquire_write()
                    if slot < 0:
                        return
                    frames = rb.slot(slot)
                    numbers, stamps, k = dec.next_batch_into(frames)
                    if not commit(slot, frames, numbers, stamps, k):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                error.append(e)
            finally:
                if dec is not None:
                    dec.close()
                rb.close()

        def producer_cv2() -> None:
            cap = None
            try:
                cap = _cv2().VideoCapture(self.path)
                if not cap.isOpened():
                    return
                frame_no = 0
                while True:
                    slot = rb.acquire_write()
                    if slot < 0:
                        return
                    frames = rb.slot(slot)
                    numbers = np.zeros(B, np.int32)
                    stamps = np.zeros(B, np.float64)
                    k, frame_no = self._fill_cv2(cap, frames, numbers, stamps, frame_no)
                    if not commit(slot, frames, numbers, stamps, k):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                error.append(e)
            finally:
                if cap is not None:
                    cap.release()
                rb.close()

        t = threading.Thread(target=producer_native if self.use_native_decode
                             else producer_cv2, daemon=True)
        t.start()
        try:
            while True:
                slot = rb.acquire_read()
                if slot < 0:
                    break
                m = meta.pop(slot, None)
                if m is None:
                    rb.release_read(slot)
                    continue
                numbers, stamps, mask = m
                batch = FrameBatch(rb.slot(slot).copy(), numbers, mask, stamps)
                rb.release_read(slot)
                yield batch
        finally:
            rb.close()  # a consumer that stops early unblocks the producer
            t.join()
            rb.destroy()
        if error:
            raise error[0]

    def _producer(self, q: "queue.Queue[Optional[FrameBatch]]") -> None:
        B = self.batch_size
        H, W = self.info.height, self.info.width
        if self.use_native_decode:
            dec = None
            try:
                dec = self._open_native_decoder()
                while True:
                    frames = np.zeros((B, H, W, 3), np.uint8)
                    numbers, stamps, k = dec.next_batch_into(frames)
                    if k == 0:
                        break
                    mask = np.zeros(B, bool)
                    mask[:k] = True
                    q.put(FrameBatch(frames, numbers, mask, stamps))
                    if k < B:
                        break
            finally:
                if dec is not None:
                    dec.close()
                q.put(None)
            return
        cap = _cv2().VideoCapture(self.path)
        try:
            if not cap.isOpened():
                return
            frame_no = 0
            while True:
                frames = np.zeros((B, H, W, 3), np.uint8)
                numbers = np.zeros(B, np.int32)
                stamps = np.zeros(B, np.float64)
                k, frame_no = self._fill_cv2(cap, frames, numbers, stamps, frame_no)
                if k == 0:
                    break
                mask = np.zeros(B, bool)
                mask[:k] = True
                q.put(FrameBatch(frames, numbers, mask, stamps))
                if k < B:
                    break
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
