"""Batched detection pipeline: uint8 frames -> letterbox -> detector (with
optional flip-TTA) -> decode -> kernel NMS -> boxes in source pixels +
normalized xywh [+ keypoints from the detector's pose head or, with
``detector.pose_mode: topdown``, from the top-down crop pose net] (PyTorch
port of ``DetectionPipeline`` in ``cvsd_tpu/pipeline/preprocess.py``).

Three input modes, as in the reference:
  device  — (B, H, W, 3) source frames, letterboxed on the device (default)
  canvas  — ``detector.host_letterbox: true``: frames resized and padded to
            the canvas on the host (cv2 INTER_LINEAR)
  content — ``detector.host_letterbox: content``: only the resized content is
            uploaded, the constant padding is added on the device
The UCF-Crime CSV preprocessing of the reference module is not ported yet
(ROADMAP.md module queue, item 9).
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cvsd_tpu_torch.models.detector import PersonDetector, build_detector, make_detect_fn
from cvsd_tpu_torch.models.pose_topdown import (TopDownPoseNet, build_pose_topdown,
                                                load_pose_topdown_checkpoint, pose_from_boxes)
from cvsd_tpu_torch.ops.iou import xyxy_to_xywhn
from cvsd_tpu_torch.ops.nms import check_nms_method
from cvsd_tpu_torch.ops.letterbox import (PAD_VALUE, letterbox_batch, letterbox_params,
                                          unletterbox_boxes)
from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device


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
                "mesh_config (data-parallel detection) is not ported yet: ROADMAP.md "
                "module queue, item 14")
        d = config.get("detector", {})
        nms_method = str(d.get("nms_method", "pallas_fixpoint"))
        check_nms_method(nms_method)
        pose_mode = str(d.get("pose_mode", "head"))
        self.config = config
        self.device = resolve_device(device)
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
