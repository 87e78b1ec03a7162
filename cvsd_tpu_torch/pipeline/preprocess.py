"""Batched detection pipeline and the UCF-Crime preprocess driver (PyTorch
port of ``cvsd_tpu/pipeline/preprocess.py``).

``DetectionPipeline``: uint8 frames -> letterbox -> detector (with optional
flip-TTA) -> decode -> kernel NMS -> boxes in source pixels + normalized
xywh [+ keypoints from the detector's pose head or, with
``detector.pose_mode: topdown``, from the top-down crop pose net].
Three input modes, as in the reference:
  device  — (B, H, W, 3) source frames, letterboxed on the device (default)
  canvas  — ``detector.host_letterbox: true``: frames resized and padded to
            the canvas on the host (cv2 INTER_LINEAR)
  content — ``detector.host_letterbox: content``: only the resized content is
            uploaded, the constant padding is added on the device

``preprocess_ucf_crime`` (Pipeline A's first half): the videos of an
``Anomaly_Train.txt`` list -> batched detection -> a tracker per video ->
BBox rows appended to the anomaly or the normal CSV. Clip ids are 1-based
over the full list (skipped lines counted), frame numbers are the 1-based
post-read frame positions, boxes are normalized xywh. ``process_video``
runs one video at a time; ``process_videos_multiplexed`` fills shared
detector batches from up to ``max_streams`` videos of one resolution and
writes the same bytes. Videos are decoded with cv2 (imported where a video
is opened); the native decoder is not ported (ROADMAP.md, deferred items).
"""

from __future__ import annotations

import os
import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cvsd_tpu_torch.data.bbox_schema import BBox, append_bboxes
from cvsd_tpu_torch.data.ucf_crime import DEFAULT_CATEGORY_FILTER, read_train_list, route_csv
from cvsd_tpu_torch.data.video import VideoBatcher, _cv2, video_info
from cvsd_tpu_torch.models.detector import PersonDetector, build_detector, make_detect_fn
from cvsd_tpu_torch.models.pose_topdown import (TopDownPoseNet, build_pose_topdown,
                                                load_pose_topdown_checkpoint, pose_from_boxes)
from cvsd_tpu_torch.ops.iou import xyxy_to_xywhn
from cvsd_tpu_torch.ops.nms import check_nms_method
from cvsd_tpu_torch.ops.letterbox import (PAD_VALUE, letterbox_batch, letterbox_params,
                                          unletterbox_boxes)
from cvsd_tpu_torch.pipeline._decode_ahead import make_next_batch
from cvsd_tpu_torch.track import IoUTracker, make_tracker
from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device, use_float32_math
from cvsd_tpu_torch.utils.hostmem import malloc_trim


class DetectionPipeline:
    """Detector + fused pre/postprocess on one device.

    ``pose_model``: a TopDownPoseNet carrying its weights; its keypoints
    replace the detector head's. ``detector.pose_mode: topdown`` without one
    loads ``detector.pose_topdown_checkpoint`` (a ``TopDownPoseTrainer.save``
    file) or, with none set, builds a seeded random net (``seed + 1``) and
    warns, as the reference does."""

    def __init__(self, config: Dict[str, Any], state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, device: DeviceLike = None,
                 mesh_config: Optional[Any] = None,
                 pose_model: Optional[TopDownPoseNet] = None):
        if mesh_config is not None:
            raise NotImplementedError(
                "mesh_config (data-parallel detection) is not ported yet: ROADMAP.md, "
                "module queue: Parallel")
        d = config.get("detector", {})
        nms_method = str(d.get("nms_method", "pallas_fixpoint"))
        check_nms_method(nms_method)
        pose_mode = str(d.get("pose_mode", "head"))
        self.config = config
        self.device = resolve_device(device)
        # the top-down pose net and float32 detectors run in float32
        use_float32_math()
        self.model: PersonDetector = build_detector(config, self.device, seed, state_dict)
        if pose_model is not None:
            pose_model = pose_model.to(self.device).eval()
        elif pose_mode == "topdown" and d.get("pose_topdown_checkpoint"):
            pose_model = load_pose_topdown_checkpoint(d["pose_topdown_checkpoint"], self.device)
        elif pose_mode == "topdown":
            warnings.warn(
                "detector.pose_mode='topdown' with no pose_topdown_checkpoint and no "
                "pose_model: instantiating a RANDOMLY-INITIALIZED TopDownPoseNet — keypoints "
                "will be garbage. Set detector.pose_topdown_checkpoint or pass pose_model "
                "(a TopDownPoseNet carrying its weights).", RuntimeWarning)
            pose_model = build_pose_topdown(config, self.device, seed + 1)
        self.pose_model = pose_model
        self.conf = float(d.get("conf_threshold", 0.25))
        if str(d.get("tracker", "iou")) == "byte":
            # ByteTrack's stage-2 rescue needs the LOW-confidence boxes the
            # NMS prefilter would otherwise drop (see track/__init__.py)
            self.conf = min(self.conf, float(d.get("tracker_low_thresh", 0.1)))
        self.iou = float(d.get("iou_threshold", 0.45))
        self.max_det = int(d.get("max_detections", 128))
        self.batch_size = int(d.get("batch_size", 32))
        # auto_size: detect at the source's native scale (stride-64 canvas)
        self.auto_size = bool(d.get("auto_size", False))
        _hlb = d.get("host_letterbox", False)
        self.host_letterbox = bool(_hlb)
        self.host_lb_content = _hlb == "content"
        # batches kept in flight by the pipelined loops before the oldest
        # is fetched, and batches fetched together
        self.stream_depth = max(1, int(d.get("stream_depth", 3)))
        self.fetch_group = max(1, int(d.get("fetch_group", 4)))
        self.tta_flip = bool(d.get("tta_flip", False))
        self._detect = make_detect_fn(self.model, self.conf, self.iou, self.max_det,
                                      nms_method=nms_method, tta_flip=self.tta_flip)

    def _canvas_size(self, src_h: int, src_w: int) -> int:
        if not self.auto_size:
            return self.model.img_size
        s = max(src_h, src_w)
        return int(min(max(-(-s // 64) * 64, 256), self.model.img_size))

    @torch.no_grad()
    def _full(self, frames: torch.Tensor, src_h: int, src_w: int):
        """uint8 frames on the device -> (boxes_src, xywhn, scores, valid[, kpts])."""
        size = self._canvas_size(src_h, src_w)
        dtype = self.model.dtype
        if self.host_lb_content:
            # content-only frames (B, nh, nw, 3); pad the constant border here
            _s, px, py, nw, nh = letterbox_params(src_h, src_w, size)
            canvas = F.pad(frames.permute(0, 3, 1, 2),
                           (px, size - px - nw, py, size - py - nh), value=PAD_VALUE)
            images = (canvas.to(torch.float32) * (1.0 / 255.0)).to(dtype).permute(0, 2, 3, 1)
        elif self.host_letterbox:
            images = (frames.to(torch.float32) * (1.0 / 255.0)).to(dtype)
        else:
            images = letterbox_batch(frames, size=size, dtype=dtype)
        out = self._detect(images)
        boxes_lb, scores, valid = out[0], out[1], out[2]
        boxes_src = unletterbox_boxes(boxes_lb, src_h, src_w, size)
        xywhn = xyxy_to_xywhn(boxes_src, float(src_w), float(src_h))
        res = (boxes_src, xywhn, scores, valid)
        if self.pose_model is not None:
            # top-down pose on the canvas crops: the crops sample the canvas
            # the detector saw (already rounded to its dtype), in float32
            kpts, _ = pose_from_boxes(self.pose_model, images.to(torch.float32),
                                      boxes_lb.to(torch.float32))
            return res + (kpts,)
        return res + tuple(out[3:])

    def _host_letterbox_batch(self, frames: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 source frames -> canvas (or content) uint8 on the
        host, cv2 INTER_LINEAR (the reference's own host preprocessing)."""
        import cv2

        B, H, W, _ = frames.shape
        size = self._canvas_size(H, W)
        _scale, px, py, nw, nh = letterbox_params(H, W, size)
        if self.host_lb_content:
            out = np.empty((B, nh, nw, 3), np.uint8)
            for b in range(B):
                out[b] = cv2.resize(frames[b], (nw, nh), interpolation=cv2.INTER_LINEAR)
            return out
        out = np.full((B, size, size, 3), PAD_VALUE, np.uint8)
        for b in range(B):
            out[b, py:py + nh, px:px + nw] = cv2.resize(
                frames[b], (nw, nh), interpolation=cv2.INTER_LINEAR)
        return out

    def _upload(self, frames) -> torch.Tensor:
        if isinstance(frames, torch.Tensor):
            return frames.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    def detect_frames(self, frames: np.ndarray):
        """(B, H, W, 3) uint8 -> host numpy (boxes_xyxy, xywhn, scores, valid[, kpts])."""
        return self.fetch_detections(self.detect_frames_async(frames))

    def detect_frames_async(self, frames):
        """Enqueue detection and return device tensors without waiting; pair
        with ``fetch_detections`` so device work overlaps host work. ``frames``
        is a (B, H, W, 3) uint8 numpy array, or (device mode) a uint8 tensor
        that may already lie on the device."""
        B, H, W, _ = frames.shape
        if self.host_letterbox:
            if isinstance(frames, torch.Tensor):
                raise TypeError("host_letterbox takes numpy frames (cv2 resizes them)")
            return self.detect_canvas_async(self._host_letterbox_batch(frames), H, W)
        return self._full(self._upload(frames), H, W)

    def detect_canvas_async(self, canvas_frames: np.ndarray, src_h: int, src_w: int):
        """Enqueue pre-letterboxed canvas (or content) frames for a source of
        (src_h, src_w)."""
        return self._full(self._upload(canvas_frames), src_h, src_w)

    @staticmethod
    def fetch_detections_group(outs: Sequence[Tuple[torch.Tensor, ...]]):
        """Bring several enqueued batches' outputs to the host together."""
        return [tuple(o.cpu().numpy() for o in out) for out in outs]

    @staticmethod
    def fetch_detections(out: Tuple[torch.Tensor, ...]):
        return tuple(o.cpu().numpy() for o in out)


# ---------------------------------------------------------------------------
# the UCF-Crime preprocess driver (Pipeline A: videos -> BBox CSVs)


def _refuse_native_decode(config: Dict[str, Any]) -> None:
    if (config.get("detector") or {}).get("native_decode"):
        raise NotImplementedError(
            "detector.native_decode is not ported yet: ROADMAP.md, deferred items")


def _write_rows(csv_path: str, rows: List[BBox]) -> None:
    """Append one video's rows to its CSV. The reference writes them with
    its native buffered writer when built, which gives the bytes of this
    pure-Python writer; the rows carry their clip, name and label."""
    append_bboxes(csv_path, rows)


def _tracked_rows(tracker: IoUTracker, boxes: np.ndarray, scores: np.ndarray, frame_no: int,
                  src_w: int, src_h: int, clip: int, name: str, is_anomaly: bool,
                  label: str) -> List[BBox]:
    """One frame's detections (xyxy in source pixels) through its video's
    tracker -> one row per tracked person, normalized xywh computed on the
    host."""
    rows = []
    for track_id, box, _score in tracker.update(boxes, scores):
        cx = (box[0] + box[2]) / 2.0 / src_w
        cy = (box[1] + box[3]) / 2.0 / src_h
        w = (box[2] - box[0]) / src_w
        h = (box[3] - box[1]) / src_h
        rows.append(BBox(clip=clip, name=name, frame=frame_no, person=float(track_id),
                         left=float(cx), top=float(cy), width=float(w), height=float(h),
                         is_anomaly=is_anomaly, anomaly=label))
    return rows


def process_video(
    pipeline: DetectionPipeline,
    video_path: str,
    clip: int,
    label: str,
    name: str,
    csv_path: str,
    is_anomaly: bool,
    tracker: Optional[IoUTracker] = None,
) -> Dict[str, Any]:
    """One video through decode -> batched detect -> track -> CSV append.
    Up to ``stream_depth`` detection batches stay in flight, so the card
    works while the host tracks the previous batch; batches are fetched in
    order, so the rows equal a synchronous loop's. Returns {frames,
    detections, rows, seconds, fps}."""
    if tracker is None:
        tracker = make_tracker(pipeline.config.get("detector"))
    tracker.reset()
    rows: List[BBox] = []
    n_frames = 0
    t0 = time.perf_counter()
    batcher = VideoBatcher(video_path, batch_size=pipeline.batch_size)
    src_w, src_h = batcher.info.width, batcher.info.height
    inflight: deque = deque()

    def drain_one() -> None:
        nonlocal n_frames
        dev, batch = inflight.popleft()
        boxes_src, _xywhn, scores, valid = pipeline.fetch_detections(dev)[:4]
        for b in range(batch.frames.shape[0]):
            if not batch.mask[b]:
                continue
            n_frames += 1
            v = valid[b]
            rows.extend(_tracked_rows(tracker, boxes_src[b][v], scores[b][v],
                                      int(batch.frame_numbers[b]), src_w, src_h, clip, name,
                                      is_anomaly, label))

    for batch in batcher:
        inflight.append((pipeline.detect_frames_async(batch.frames), batch))
        if len(inflight) >= pipeline.stream_depth:
            drain_one()
    while inflight:
        drain_one()
    if rows:
        _write_rows(csv_path, rows)
    dt = time.perf_counter() - t0
    return {"frames": n_frames, "detections": len(rows), "rows": len(rows), "seconds": dt,
            "fps": n_frames / dt if dt > 0 else 0.0}


def process_videos_multiplexed(
    pipeline: DetectionPipeline,
    items: Sequence[Tuple[str, int, str, str, str, bool]],
    max_streams: int = 16,
) -> Dict[str, Any]:
    """Frames of up to ``max_streams`` videos of one source resolution,
    round-robin, in SHARED detector batches: a short video alone fills a
    batch or two and drains the in-flight queue at its end, so the card
    idles at every video boundary; multiplexed, every batch is full until
    the last. Each video keeps its own tracker and frame order, so its rows
    equal ``process_video``'s; rows are buffered per item and returned in
    ``items`` order, for one write in entry order.

    items: (video_path, clip, label, name, csv_path, is_anomaly) per video.
    Returns {rows_by_item, frames, detections, seconds, stage_seconds}."""
    _refuse_native_decode(pipeline.config)
    cv2 = _cv2()
    t0 = time.perf_counter()
    B = pipeline.batch_size
    depth = max(1, pipeline.stream_depth)
    host_lb = pipeline.host_letterbox
    content = pipeline.host_lb_content
    queue_items = list(items)
    rows_by_item: List[List[BBox]] = [[] for _ in items]
    active: List[Dict[str, Any]] = []
    src_h = src_w = None
    lb = None  # (size, scale, px, py, nw, nh) once the resolution is known
    n_frames = 0
    n_dets = 0

    def open_next() -> bool:
        nonlocal src_h, src_w, lb
        while queue_items:
            it = queue_items.pop(0)
            cap = cv2.VideoCapture(it[0])
            if not cap.isOpened():
                continue
            h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            if src_h is None:
                src_h, src_w = h, w
                if host_lb:
                    size = pipeline._canvas_size(h, w)
                    lb = (size,) + letterbox_params(h, w, size)
            elif (h, w) != (src_h, src_w):
                cap.release()
                raise ValueError(
                    f"{it[0]}: {h}x{w} differs from group resolution {src_h}x{src_w}; "
                    "group videos by resolution before multiplexing")
            active.append({
                "cap": cap,
                "tracker": make_tracker(pipeline.config.get("detector")),
                "frame_no": 0,
                "rows": rows_by_item[len(items) - len(queue_items) - 1],
                "clip": it[1], "label": it[2], "name": it[3], "anom": it[5],
            })
            return True
        return False

    while len(active) < max_streams and open_next():
        pass
    if not active:
        return {"rows_by_item": rows_by_item, "frames": 0, "detections": 0,
                "seconds": time.perf_counter() - t0, "stage_seconds": {}}

    def read_batch():
        """Fill one detector batch round-robin across the live streams; meta
        holds (stream state, frame number) per slot."""
        nonlocal n_frames
        if host_lb:
            size, _scale, px, py, nw, nh = lb
            if content:
                frames = np.zeros((B, nh, nw, 3), np.uint8)
            else:
                frames = np.full((B, size, size, 3), PAD_VALUE, np.uint8)
        else:
            frames = np.zeros((B, src_h, src_w, 3), np.uint8)
        meta: List[Optional[Tuple[Dict[str, Any], int]]] = [None] * B
        k = 0
        i = 0
        while k < B and active:
            st = active[i % len(active)]
            ok, frame = st["cap"].read()
            if not ok:
                st["cap"].release()
                active.remove(st)
                open_next()
                continue
            st["frame_no"] += 1
            if host_lb:
                r = cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_LINEAR)
                if content:
                    frames[k] = r[..., ::-1]
                else:
                    frames[k, py:py + nh, px:px + nw] = r[..., ::-1]
            else:
                if frame.shape[:2] != (src_h, src_w):  # defensive: some codecs lie
                    frame = cv2.resize(frame, (src_w, src_h))
                frames[k] = frame[..., ::-1]
            meta[k] = (st, st["frame_no"])
            k += 1
            i += 1
        n_frames += k
        return frames, meta, k

    def process(outs, meta, k: int) -> None:
        nonlocal n_dets
        boxes_src, _xywhn, scores, valid = outs[:4]
        for b in range(k):
            st, frame_no = meta[b]
            v = valid[b]
            rows = _tracked_rows(st["tracker"], boxes_src[b][v], scores[b][v], frame_no,
                                 src_w, src_h, st["clip"], st["name"], st["anom"], st["label"])
            n_dets += len(rows)
            st["rows"].extend(rows)

    # a decode-ahead thread and an in-flight queue (one producer: batch order
    # and therefore the rows are deterministic)
    stage = {"read": 0.0, "dispatch": 0.0, "fetch": 0.0, "track": 0.0}
    next_batch = make_next_batch(
        read_batch, stage, depth,
        bool(pipeline.config.get("detector", {}).get("decode_thread", True)))
    inflight: deque = deque()
    eof = False
    group = max(1, pipeline.fetch_group)
    # keep `depth` batches computing beyond the group being fetched
    dispatch_ahead = depth + group
    try:
        while True:
            while not eof and len(inflight) < dispatch_ahead:
                frames, meta, k = next_batch()
                if k:
                    t1 = time.perf_counter()
                    if host_lb:
                        dev = pipeline.detect_canvas_async(frames, src_h, src_w)
                    else:
                        dev = pipeline.detect_frames_async(frames)
                    inflight.append((dev, meta, k))
                    stage["dispatch"] += time.perf_counter() - t1
                else:
                    eof = True
            if not inflight:
                break
            g = [inflight.popleft() for _ in range(min(group, len(inflight)))]
            t1 = time.perf_counter()
            outs_list = pipeline.fetch_detections_group([x[0] for x in g])
            t2 = time.perf_counter()
            for (_dev, m, kk), outs in zip(g, outs_list):
                process(outs, m, kk)
            stage["fetch"] += t2 - t1
            stage["track"] += time.perf_counter() - t2
    finally:
        for st in active:
            st["cap"].release()
    return {"rows_by_item": rows_by_item, "frames": n_frames, "detections": n_dets,
            "seconds": time.perf_counter() - t0, "stage_seconds": stage}


def preprocess_ucf_crime(
    config: Dict[str, Any],
    dataset_dir: str,
    output_dir: Optional[str] = None,
    category_filter: Sequence[str] = DEFAULT_CATEGORY_FILTER,
    train_list: str = "Anomaly_Train.txt",
    limit: Optional[int] = None,
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
    mesh_config: Optional[Any] = None,
    verbose: bool = True,
    pipeline: Optional[DetectionPipeline] = None,
    max_streams: int = 1,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """The preprocess driver: each listed video of the filtered categories
    that exists under ``dataset_dir`` -> rows in ``output_dir``'s anomaly or
    normal CSV (appended). ``state_dict``: the detector's weights (seeded
    random without); ``device``: the default is the CUDA card, raising
    without one. Pass ``pipeline`` to reuse a built one. ``max_streams`` > 1
    multiplexes that many videos into shared detector batches, one pass per
    source resolution, and writes the same bytes. Returns {videos, frames,
    rows, skipped, seconds, fps[, stage_seconds]}."""
    if mesh_config is not None:
        raise NotImplementedError(
            "mesh_config (data-parallel detection) is not ported yet: ROADMAP.md, "
            "module queue: Parallel")
    _refuse_native_decode(config)
    if pipeline is None:  # first, so a missing card is reported before any file
        pipeline = DetectionPipeline(config, state_dict=state_dict, device=device)
    output_dir = output_dir or dataset_dir
    entries = read_train_list(os.path.join(dataset_dir, train_list), category_filter)
    if limit:
        entries = entries[:limit]
    stats: Dict[str, Any] = {"videos": 0, "frames": 0, "rows": 0, "skipped": [], "seconds": 0.0}

    present = []
    for entry in entries:
        video_path = os.path.join(dataset_dir, entry.path)
        if not os.path.exists(video_path):
            if verbose:
                print(f"Failed to load video: {entry.path}")
            stats["skipped"].append(entry.path)
        else:
            present.append((entry, video_path))

    if max_streams > 1:
        t0 = time.perf_counter()
        # one multiplexed pass per source resolution (entry order kept within
        # a group); then one write of every video's rows in entry order
        groups: Dict[Tuple[int, int], List[Tuple[Any, str]]] = {}
        for entry, video_path in present:
            info = video_info(video_path)
            groups.setdefault((info.height, info.width), []).append((entry, video_path))
        rows_for_entry: Dict[int, List[BBox]] = {}
        stats["stage_seconds"] = {}
        for group in groups.values():
            items = []
            for entry, video_path in group:
                csv_path, is_anomaly = route_csv(entry.label, output_dir)
                items.append((video_path, entry.index, entry.label, entry.name,
                              csv_path, is_anomaly))
            r = process_videos_multiplexed(pipeline, items, max_streams=max_streams)
            for (entry, _vp), rows in zip(group, r["rows_by_item"]):
                rows_for_entry[entry.index] = rows
            stats["frames"] += r["frames"]
            stats["videos"] += len(group)
            for k, v in r["stage_seconds"].items():
                stats["stage_seconds"][k] = stats["stage_seconds"].get(k, 0.0) + v
        for entry, _video_path in present:
            rows = rows_for_entry.get(entry.index, [])
            stats["rows"] += len(rows)
            if rows:
                _write_rows(route_csv(entry.label, output_dir)[0], rows)
        stats["seconds"] = time.perf_counter() - t0
    else:
        tracker = make_tracker(pipeline.config.get("detector"))
        for entry, video_path in present:
            csv_path, is_anomaly = route_csv(entry.label, output_dir)
            if verbose:
                print(f"Processing video {entry.index}: {entry.path}")
            r = process_video(pipeline, video_path, entry.index, entry.label, entry.name,
                              csv_path, is_anomaly, tracker)
            stats["videos"] += 1
            stats["frames"] += r["frames"]
            stats["rows"] += r["rows"]
            stats["seconds"] += r["seconds"]
            if verbose:
                print(f"  {r['frames']} frames, {r['rows']} rows, {r['fps']:.1f} fps")
    stats["fps"] = stats["frames"] / stats["seconds"] if stats["seconds"] else 0.0
    malloc_trim()  # return the batch driver's freed arenas to the OS
    return stats
