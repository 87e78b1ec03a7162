from typing import Any, Dict, Optional

from cvsd_tpu_torch.track.bytetrack import ByteTracker  # noqa: F401
from cvsd_tpu_torch.track.tracker import IoUTracker, Track  # noqa: F401


def make_tracker(detector_cfg: Optional[Dict[str, Any]] = None):
    """Config-driven tracker factory: `detector.tracker: iou|byte`.

    'iou' (default) = Hungarian IoU association (track/tracker.py);
    'byte' = Kalman motion + two-stage ByteTrack association
    (track/bytetrack.py — what the reference's ultralytics model.track
    default actually runs).

    Byte-mode thresholds: tracks spawn / stage-1-associate at >= high_thresh;
    scores in [low_thresh, high_thresh) can only rescue existing tracks, but
    a rescued box IS reported, so byte mode emits rows down to low_thresh.
    Unless tracker_high_thresh is set explicitly, high_thresh is raised to
    the configured detector.conf_threshold when that exceeds the ByteTrack
    default (0.5), so a user-raised confidence floor keeps gating which
    detections may start tracks."""
    d = detector_cfg or {}
    kind = str(d.get("tracker", "iou"))
    kw = {}
    for k in ("iou_threshold", "max_misses", "min_hits"):
        if f"tracker_{k}" in d:
            kw[k] = d[f"tracker_{k}"]
    if kind == "byte":
        for k in ("high_thresh", "low_thresh"):
            if f"tracker_{k}" in d:
                kw[k] = d[f"tracker_{k}"]
        if "high_thresh" not in kw and "conf_threshold" in d:
            kw["high_thresh"] = max(0.5, float(d["conf_threshold"]))
        return ByteTracker(**kw)
    if kind != "iou":
        raise ValueError(f"unknown detector.tracker '{kind}' (iou|byte)")
    return IoUTracker(**kw)
