"""Streaming end-to-end inference: decode -> detect(+pose) -> track ->
pose-window tokenize -> Shopformer anomaly score (PyTorch port of
``cvsd_tpu/pipeline/streaming.py``).

The multiplexed loop is split at a frame-source seam: ``run_stream`` runs
detect -> track -> window -> score on any ``read_batch() -> (frames, meta,
k)``. ``RoundRobinReader`` builds such a reader over frame sources, filling
each detector batch round-robin across up to ``max_streams`` live streams;
``VideoFileSource`` reads a video file through cv2 and ``ArraySource`` reads
frames already in memory, so the loop runs without cv2 and gives the same
events for the same frames. ``NativeDecodeReader`` is a reader of the same
protocol over video files through the native multi-stream decoder
(``detector.native_decode``, see ``StreamingPipeline``). A ``VideoFileSource``'s ``on_frame(frame_no,
timestamp_ms, dets)`` hook, where given, fires for each of its frames as
``run_stream`` tracks it (see ``StreamingPipeline.stream_video``); the
native reader takes the same hook per path.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from cvsd_tpu_torch.data.poselift import add_neck_keypoint, normalize_sequence
from cvsd_tpu_torch.eval.evaluate import ShopformerScorer
from cvsd_tpu_torch.native.video import use_native_decode
from cvsd_tpu_torch.ops.letterbox import PAD_VALUE, letterbox_params
from cvsd_tpu_torch.pipeline._decode_ahead import make_next_batch
from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline, _native_decode_flag
from cvsd_tpu_torch.track import make_tracker
from cvsd_tpu_torch.utils.device import DeviceLike
from cvsd_tpu_torch.utils.hostmem import malloc_trim
from cvsd_tpu_torch.utils.metrics import AGGREGATORS


@dataclass
class ScoreEvent:
    """One scored pose window for one tracked person."""

    video: str
    track_id: int
    frame_end: int          # last frame of the window (1-based)
    timestamp_ms: float     # CAP_PROP_POS_MSEC of the last frame
    score: float
    frames: List[int] = field(default_factory=list)


class _TrackWindow:
    """Per-track ring buffer of keypoints feeding the tokenizer; a frame gap
    > max_gap restarts the window (PoseLift continuity semantics)."""

    def __init__(self, seq_len: int, stride: int, max_gap: int = 5):
        self.seq_len = seq_len
        self.stride = stride
        self.max_gap = int(max_gap)
        self.kpts: deque = deque(maxlen=seq_len)
        self.frames: deque = deque(maxlen=seq_len)
        self.stamps: deque = deque(maxlen=seq_len)
        self._since_emit = 0

    def push(self, kpts: np.ndarray, frame_no: int, stamp: float) -> Optional[Dict[str, Any]]:
        if self.frames and frame_no - self.frames[-1] > self.max_gap:
            self.kpts.clear()
            self.frames.clear()
            self.stamps.clear()
            self._since_emit = 0
        self.kpts.append(kpts)
        self.frames.append(frame_no)
        self.stamps.append(stamp)
        self._since_emit += 1
        if len(self.kpts) == self.seq_len and self._since_emit >= self.stride:
            self._since_emit = 0
            return {
                "window": np.stack(self.kpts),  # (T, V, 2)
                "frames": list(self.frames),
                "stamp": self.stamps[-1],
            }
        return None


# ---------------------------------------------------------------------------
# frame sources and the round-robin batch reader


class VideoFileSource:
    """A video file read through cv2: RGB frames and CAP_PROP_POS_MSEC stamps.
    With frame_stride N, the N-1 frames between reads are only grab()'d."""

    def __init__(self, path: str, frame_stride: int = 1, name: Optional[str] = None,
                 on_frame: Optional[Callable] = None):
        self.path = path
        self.on_frame = on_frame
        self.name = name or path.rsplit("/", 1)[-1]
        self.frame_stride = max(1, int(frame_stride))
        self._cap = None
        self._started = False
        self.height = self.width = 0

    def open(self) -> bool:
        import cv2

        self._cap = cv2.VideoCapture(self.path)
        if not self._cap.isOpened():
            return False
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        return True

    def read(self, shape: Tuple[int, int]) -> Tuple[bool, Optional[np.ndarray], float]:
        import cv2

        cap = self._cap
        if self._started:
            for _ in range(self.frame_stride - 1):
                if not cap.grab():
                    return False, None, 0.0
        self._started = True
        ok, frame = cap.read()
        if not ok:
            return False, None, 0.0
        if frame.shape[:2] != shape:  # defensive: some codecs lie
            frame = cv2.resize(frame, (shape[1], shape[0]))
        return True, frame[..., ::-1], float(cap.get(cv2.CAP_PROP_POS_MSEC))

    def release(self) -> None:
        if self._cap is not None:
            self._cap.release()


class ArraySource:
    """Frames already in memory: (N, H, W, 3) RGB uint8 and per-frame stamps
    in ms (default: frame_index * 1000 / fps)."""

    def __init__(self, name: str, frames: np.ndarray, stamps_ms: Optional[np.ndarray] = None,
                 fps: float = 30.0, frame_stride: int = 1):
        self.name = name
        self.frames = frames
        self.stamps = (np.asarray(stamps_ms, np.float64) if stamps_ms is not None
                       else np.arange(len(frames), dtype=np.float64) * 1000.0 / fps)
        self.frame_stride = max(1, int(frame_stride))
        self.height, self.width = int(frames.shape[1]), int(frames.shape[2])
        self._next = 0

    def open(self) -> bool:
        return True

    def read(self, shape: Tuple[int, int]) -> Tuple[bool, Optional[np.ndarray], float]:
        if (self.height, self.width) != tuple(shape):
            raise ValueError(f"{self.name}: frames are {self.height}x{self.width}, "
                             f"the group resolution is {shape[0]}x{shape[1]}")
        i = self._next
        if i >= len(self.frames):
            return False, None, 0.0
        self._next = i + self.frame_stride
        return True, self.frames[i], float(self.stamps[i])

    def release(self) -> None:
        pass


class RoundRobinReader:
    """``read_batch() -> (frames, meta, k)`` over frame sources of one
    resolution: each call fills one detector batch round-robin across up to
    ``max_streams`` live streams, opening the next source when one ends.
    ``meta[b] = (stream_state, frame_no, stamp_ms)``; the stream-state dict
    carries the stream's tracker and pose windows, so a stream that has
    ended stays processable."""

    def __init__(self, pipeline: "StreamingPipeline", sources: Sequence[Any],
                 resolution: Tuple[int, int], max_streams: int):
        self.pipeline = pipeline
        self.queue = list(sources)
        self.resolution = resolution
        self.max_streams = max_streams
        det = pipeline.detection
        self.B = det.batch_size
        self.size = det._canvas_size(*resolution)
        self.host_lb = det.host_letterbox
        self.lb_content = det.host_lb_content
        self.lb = letterbox_params(*resolution, self.size)
        self.active: Dict[int, Dict[str, Any]] = {}
        self.n_frames = 0
        self.n_opened = 0  # sources actually read (unopenable ones skipped)
        while len(self.active) < max_streams and self._open_next():
            pass

    def _open_next(self) -> bool:
        while self.queue:
            src = self.queue.pop(0)
            if not src.open():
                continue
            self.n_opened += 1
            scale, pad_x, pad_y, _, _ = letterbox_params(src.height, src.width, self.size)
            self.active[id(src)] = {
                "source": src,
                "tracker": make_tracker(self.pipeline.config.get("detector")),
                "windows": {},
                "frame_no": 0, "scale": scale, "pad": (pad_x, pad_y),
                "name": src.name, "resolution": self.resolution,
                "on_frame": getattr(src, "on_frame", None),
            }
            return True
        return False

    def __call__(self) -> Tuple[np.ndarray, List, int]:
        B = self.B
        h, w = self.resolution
        _scale, px, py, nw, nh = self.lb
        if self.host_lb:
            if self.lb_content:  # content-only upload; the device adds the padding
                frames = np.zeros((B, nh, nw, 3), np.uint8)
            else:
                frames = np.full((B, self.size, self.size, 3), PAD_VALUE, np.uint8)
        else:
            frames = np.zeros((B, h, w, 3), np.uint8)
        meta: List[Optional[Tuple[Dict[str, Any], int, float]]] = [None] * B
        stride = self.pipeline.frame_stride
        k = 0
        order = list(self.active.keys())
        i = 0
        while k < B and self.active:
            key = order[i % len(order)] if order else None
            if key is None or key not in self.active:
                order = list(self.active.keys())
                if not order:
                    break
                i = 0
                continue
            st = self.active[key]
            ok, frame, stamp = st["source"].read((h, w))
            if not ok:
                st["source"].release()
                del self.active[key]
                order = list(self.active.keys())
                if self._open_next():
                    order = list(self.active.keys())
                continue
            st["frame_no"] = 1 if st["frame_no"] == 0 else st["frame_no"] + stride
            if self.host_lb:
                import cv2

                r = cv2.resize(np.ascontiguousarray(frame), (nw, nh),
                               interpolation=cv2.INTER_LINEAR)
                if self.lb_content:
                    frames[k] = r
                else:
                    frames[k, py:py + nh, px:px + nw] = r
            else:
                frames[k] = frame
            meta[k] = (st, st["frame_no"], stamp)
            k += 1
            i += 1
            self.n_frames += 1
        return frames, meta, k


class NativeDecodeReader:
    """``read_batch() -> (frames, meta, k)`` over video files of one
    resolution through the native multi-stream decoder
    (``native/video.py``): one C++ call fills a detector batch round-robin
    across up to ``max_streams`` live streams, decoding, resizing and
    converting (the host-letterbox canvas or content rows, or source-size
    frames) with the GIL released. The same protocol as
    ``RoundRobinReader``, the same frames in the same order, so the same
    events; the stamps are the decoder's (see ``native/video.py``).
    ``names`` and ``on_frames`` (per path) are the ``VideoFileSource``
    options."""

    def __init__(self, pipeline: "StreamingPipeline", paths: Sequence[str],
                 resolution: Tuple[int, int], max_streams: int,
                 names: Optional[Sequence[Optional[str]]] = None,
                 on_frames: Optional[Sequence[Optional[Callable]]] = None):
        from cvsd_tpu_torch.native.video import (MODE_CANVAS, MODE_CONTENT, MODE_RAW,
                                                 MultiStreamDecoder)

        self.pipeline = pipeline
        self.paths = [str(p) for p in paths]
        self.names = [n or p.rsplit("/", 1)[-1]
                      for n, p in zip(names or [None] * len(self.paths), self.paths)]
        self.on_frames = list(on_frames or [None] * len(self.paths))
        self.resolution = resolution
        det = pipeline.detection
        self.B = det.batch_size
        size = det._canvas_size(*resolution)
        self.scale, px, py, nw, nh = letterbox_params(*resolution, size)
        self.pad = (px, py)
        stride = pipeline.frame_stride
        if det.host_letterbox and det.host_lb_content:
            self.dec = MultiStreamDecoder(self.paths, max_streams, (nh, nw), MODE_CONTENT,
                                          (nh, nw), frame_stride=stride)
        elif det.host_letterbox:
            self.dec = MultiStreamDecoder(self.paths, max_streams, (size, size), MODE_CANVAS,
                                          (nh, nw), (px, py), frame_stride=stride)
        else:
            self.dec = MultiStreamDecoder(self.paths, max_streams, tuple(resolution),
                                          MODE_RAW, frame_stride=stride)
        self.states: Dict[int, Dict[str, Any]] = {}
        self.n_frames = 0
        self.n_opened = 0  # streams that gave a frame

    def __call__(self) -> Tuple[np.ndarray, List, int]:
        frames, sidx, fno, stamp, k = self.dec.next_batch(self.B)
        meta: List[Optional[Tuple[Dict[str, Any], int, float]]] = [None] * self.B
        for b in range(k):
            si = int(sidx[b])
            st = self.states.get(si)
            if st is None:
                self.n_opened += 1
                st = self.states[si] = {
                    "tracker": make_tracker(self.pipeline.config.get("detector")),
                    "windows": {}, "scale": self.scale, "pad": self.pad,
                    "name": self.names[si], "resolution": self.resolution,
                    "on_frame": self.on_frames[si],
                }
            meta[b] = (st, int(fno[b]), float(stamp[b]))
        self.n_frames += k
        if k == 0:  # every stream has ended: nothing reads the decoder again
            self.dec.close()
        return frames, meta, k


class StreamingPipeline:
    """decode -> detect(+pose) -> track -> window -> score, batched throughout.

    Video files are decoded per ``detector.native_decode``, as in the
    reference: unset, by the native multi-stream decoder where it builds
    (``NativeDecodeReader``), else by cv2 (``VideoFileSource`` under
    ``RoundRobinReader``); ``True`` builds the decoder or raises. Both
    readers feed the one ``run_stream`` loop."""

    def __init__(self, config: Dict[str, Any], scorer: ShopformerScorer,
                 detector_state_dict: Optional[Dict[str, Any]] = None, seed: int = 0,
                 device: DeviceLike = None, pose_model: Optional[Any] = None,
                 mesh_config: Optional[Any] = None):
        cfg = dict(config)
        # own copy of the detector subtree: streaming needs keypoints, and
        # setting pose_head must not leak into the caller's config
        cfg["detector"] = dict(cfg.get("detector") or {})
        if cfg["detector"].get("pose_mode", "head") != "topdown":
            cfg["detector"]["pose_head"] = True
        self.config = cfg
        self.detection = DetectionPipeline(cfg, state_dict=detector_state_dict, seed=seed,
                                           device=device, pose_model=pose_model,
                                           mesh_config=mesh_config)
        self.scorer = scorer
        m = scorer.config["model"]
        self.seq_len = int(m.get("seq_len", 12))
        self.num_keypoints = int(m.get("num_keypoints", 18))
        self.stride = int(scorer.config.get("data", {}).get("stride", self.seq_len // 2))
        self.max_gap = int(scorer.config.get("data", {}).get("max_gap", 5))
        self.score_batch = int(scorer.config.get("data", {}).get("batch_size", 32))
        self.stream_depth = max(1, int(cfg["detector"].get("stream_depth", 3)))
        # frame_stride=N: detect every Nth source frame; window gap tolerance
        # scales by N so continuity matches the stride-1 training windows
        self.frame_stride = max(1, int(cfg["detector"].get("frame_stride", 1)))
        self.score_depth = max(1, int(cfg["detector"].get(
            "score_stream_depth", self.stream_depth)))
        self._stage_seconds = {"read": 0.0, "detect": 0.0, "track": 0.0, "score": 0.0}
        # an explicit true builds the decoder now, so a missing opencv4 raises here
        self.native_decode = use_native_decode(_native_decode_flag(cfg))

    def _video_reader(self, paths: Sequence[str], resolution: Tuple[int, int],
                      max_streams: int, name: Optional[str] = None,
                      on_frame: Optional[Callable] = None):
        """The frame reader of one resolution group of video files."""
        if self.native_decode:
            return NativeDecodeReader(self, paths, resolution, max_streams,
                                      names=[name] * len(paths), on_frames=[on_frame] * len(paths))
        return RoundRobinReader(
            self, [VideoFileSource(p, self.frame_stride, name=name, on_frame=on_frame)
                   for p in paths], resolution, max_streams)

    def _prepare_window(self, window: np.ndarray) -> np.ndarray:
        """(T, 17, 2) detector keypoints -> normalized (T, V, C) model input."""
        if self.num_keypoints == 18:
            window = np.stack([add_neck_keypoint(fr) for fr in window])
        else:
            window = window[:, : self.num_keypoints]
        return normalize_sequence(window.astype(np.float32))

    def _new_window(self) -> _TrackWindow:
        return _TrackWindow(self.seq_len, self.stride, self.max_gap * self.frame_stride)

    def stream_video(self, video_path: str, video_name: Optional[str] = None,
                     on_frame: Optional[Callable] = None) -> Iterator[ScoreEvent]:
        """ScoreEvents of one video: ``run_stream`` over that file alone (the
        events come once the video is done; ``run_stream``'s ``on_event``
        fires as each is scored).

        ``on_frame(frame_no, timestamp_ms, dets)`` fires for every decoded
        frame, in order, frame numbers from 1, with the tracked detections
        in source pixels: ``dets`` is a list of {'track_id', 'box' (4,)
        xyxy, 'score', 'kpts' (17, 2) or None}, ``kpts`` None where the
        frame has no keypoints or no tracks (the annotation writer,
        ``viz/annotate.py``, reads it)."""
        from cvsd_tpu_torch.data.video import video_info

        info = video_info(video_path)
        yield from self.run_stream(self._video_reader(
            [video_path], (info.height, info.width), 1, name=video_name, on_frame=on_frame))

    def stream_videos(self, video_paths: Sequence[str]) -> Dict[str, Any]:
        """Stream the videos one after another; returns the events and
        throughput stats (frames as each file's header counts them)."""
        from cvsd_tpu_torch.data.video import video_info

        t0 = time.perf_counter()
        events: List[ScoreEvent] = []
        n_frames = 0
        for path in video_paths:
            events.extend(self.stream_video(path))
            n_frames += video_info(path).num_frames
        dt = time.perf_counter() - t0
        return {
            "events": events, "videos": len(video_paths), "frames": n_frames,
            "seconds": dt, "fps": n_frames / dt if dt > 0 else 0.0,
            "videos_per_hour": len(video_paths) / dt * 3600 if dt > 0 else 0.0,
        }

    def stream_videos_concurrent(self, video_paths: Sequence[str], max_streams: int = 8,
                                 on_event=None) -> Dict[str, Any]:
        """Multiplex frames from up to ``max_streams`` same-resolution videos
        into shared detector batches; per-video tracker/window state is kept
        apart, so events equal sequential streaming. Mixed resolutions run as
        one group per resolution. ``on_event(ScoreEvent)`` fires as each
        scored window is fetched. The result's ``host_path['decode']`` is
        'native' or 'python' (the class docstring)."""
        from cvsd_tpu_torch.data.video import video_info

        t0 = time.perf_counter()
        self._stage_seconds = {"read": 0.0, "detect": 0.0, "track": 0.0, "score": 0.0}
        groups: Dict[Tuple[int, int], List[str]] = {}
        for p in video_paths:
            try:
                info = video_info(p)
            except (FileNotFoundError, RuntimeError):
                continue
            groups.setdefault((info.height, info.width), []).append(p)
        events: List[ScoreEvent] = []
        n_frames = 0
        n_videos = 0
        for resolution, paths in groups.items():
            reader = self._video_reader(paths, resolution, max_streams)
            events.extend(self.run_stream(reader, on_event))
            n_frames += reader.n_frames
            n_videos += reader.n_opened
        malloc_trim()  # return freed arena pages once per pass (utils/hostmem.py)
        dt = time.perf_counter() - t0
        return {
            "events": events, "videos": n_videos, "frames": n_frames,
            "skipped": len(video_paths) - n_videos,
            "seconds": dt, "fps": n_frames / dt if dt > 0 else 0.0,
            "videos_per_hour": n_videos / dt * 3600 if dt > 0 else 0.0,
            "stage_seconds": dict(self._stage_seconds),
            "host_path": {"decode": "native" if self.native_decode else "python"},
        }

    def run_stream(self, read_batch: Callable[[], Tuple[np.ndarray, List, int]],
                   on_event=None) -> List[ScoreEvent]:
        """detect -> track -> window -> score over every batch ``read_batch``
        yields (see RoundRobinReader for the protocol) until it returns k=0.

        Detection keeps ``stream_depth`` batches in flight beyond the group
        being fetched, and scoring keeps ``score_depth`` batches in flight, so
        device work overlaps host decode, tracking and windowing."""
        events: List[ScoreEvent] = []
        stage = self._stage_seconds
        pending: List[Dict[str, Any]] = []
        pending_video: List[str] = []

        def process(outs, meta, k: int) -> None:
            boxes_src, _xywhn, scores, valid = outs[:4]
            kpts = outs[4] if len(outs) > 4 else None
            for b in range(k):
                st, frame_no, stamp = meta[b]
                v = valid[b]
                tracked = st["tracker"].update_with_indices(boxes_src[b][v], scores[b][v])
                on_frame = st["on_frame"]
                if kpts is None or not tracked:
                    if on_frame is not None:
                        on_frame(frame_no, stamp, [
                            {"track_id": tid, "box": np.asarray(bx, np.float32),
                             "score": float(sc), "kpts": None} for tid, bx, sc, _di in tracked])
                    continue
                det_kpts = kpts[b][v]
                pad_x, pad_y = st["pad"]
                frame_dets = []
                for track_id, box, score, di in tracked:
                    kp = det_kpts[di][:, :2].copy()
                    kp[:, 0] = (kp[:, 0] - pad_x) / st["scale"]
                    kp[:, 1] = (kp[:, 1] - pad_y) / st["scale"]
                    if on_frame is not None:
                        frame_dets.append({"track_id": track_id,
                                           "box": np.asarray(box, np.float32),
                                           "score": float(score), "kpts": kp})
                    tw = st["windows"].setdefault(track_id, self._new_window())
                    done = tw.push(kp, frame_no, stamp)
                    if done is not None:
                        pending.append({"track_id": track_id, **done})
                        pending_video.append(st["name"])
                if on_frame is not None:
                    on_frame(frame_no, stamp, frame_dets)

        inflight: deque = deque()
        score_inflight: deque = deque()

        def fetch_oldest_scores() -> None:
            dev, chunk, pv, k = score_inflight.popleft()
            s = self.scorer.fetch_scores(dev)[:k]
            fresh = [ScoreEvent(video=v, track_id=int(p["track_id"]),
                                frame_end=int(p["frames"][-1]),
                                timestamp_ms=float(p["stamp"]), score=float(sc),
                                frames=[int(f) for f in p["frames"]])
                     for p, v, sc in zip(chunk, pv, s)]
            events.extend(fresh)
            if on_event is not None:
                for e in fresh:
                    on_event(e)

        def dispatch_scores(flush: bool = False) -> None:
            SB = self.score_batch
            while len(pending) >= SB or (flush and pending):
                chunk = pending[:SB]
                pv = pending_video[:SB]
                del pending[:SB]
                del pending_video[:SB]
                arr = np.stack([self._prepare_window(p["window"]) for p in chunk])
                if arr.shape[0] < SB:  # final partial chunk: pad to the static batch
                    pad = np.zeros((SB - arr.shape[0],) + arr.shape[1:], arr.dtype)
                    arr = np.concatenate([arr, pad])
                score_inflight.append((self.scorer.score_async(arr), chunk, pv, len(chunk)))
                while len(score_inflight) > self.score_depth:
                    fetch_oldest_scores()

        # decode-ahead thread (detector.decode_thread, default on); a single
        # producer keeps batch order, so events are identical either way
        next_batch = make_next_batch(
            read_batch, stage, self.stream_depth,
            bool(self.config.get("detector", {}).get("decode_thread", True)))
        host_lb = self.detection.host_letterbox
        eof = False
        group = max(1, self.detection.fetch_group)
        dispatch_ahead = self.stream_depth + group - 1
        while True:
            while not eof and len(inflight) < dispatch_ahead:
                frames, meta, k = next_batch()
                if k:
                    t1 = time.perf_counter()
                    if host_lb:  # frames are canvas-size already
                        dev = self.detection.detect_canvas_async(
                            frames, *meta[0][0]["resolution"])
                    else:
                        dev = self.detection.detect_frames_async(frames)
                    inflight.append((dev, meta, k))
                    stage["detect"] += time.perf_counter() - t1
                else:
                    eof = True
            if not inflight:
                break
            g = [inflight.popleft() for _ in range(min(group, len(inflight)))]
            t2 = time.perf_counter()
            outs_list = self.detection.fetch_detections_group([x[0] for x in g])
            t3 = time.perf_counter()
            stage["detect"] += t3 - t2
            for (_dev, m, kk), outs in zip(g, outs_list):
                process(outs, m, kk)
            stage["track"] += time.perf_counter() - t3
            t4 = time.perf_counter()
            dispatch_scores()
            stage["score"] += time.perf_counter() - t4
        t5 = time.perf_counter()
        dispatch_scores(flush=True)
        while score_inflight:
            fetch_oldest_scores()
        stage["score"] += time.perf_counter() - t5
        return events

    @staticmethod
    def aggregate_events(events: Sequence[ScoreEvent],
                         aggregations=("max", "mean", "percentile_95")) -> Dict[str, Dict[str, float]]:
        """Per-video anomaly scores from streaming events (max/mean/p95)."""
        by_video: Dict[str, List[float]] = {}
        for e in events:
            by_video.setdefault(e.video, []).append(e.score)
        return {video: {agg: AGGREGATORS[agg](np.asarray(scores)) for agg in aggregations}
                for video, scores in by_video.items()}
