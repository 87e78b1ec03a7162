"""Synthetic person renderer: pose skeletons drawn into frames (the port's
numpy copy of ``cvsd_tpu/data/render.py``; the same seed gives the same
frames, boxes and keypoints bit for bit).

``SyntheticPoseLiftDataset`` generates pose sequences; this module renders
them into RGB frames (bright joints and limb segments on noise, or textured
multi-person scenes with occlusion), with ground-truth boxes and keypoints
per frame. The detector trainer, the top-down pose trainer and the card's
smoke run train on them; no real dataset is needed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from cvsd_tpu_torch.data.synthetic import SyntheticPoseLiftDataset
from cvsd_tpu_torch.models.graph import get_skeleton_adjacency

_EDGES = np.argwhere(np.triu(get_skeleton_adjacency(17, "coco") - np.eye(17)) > 0)


def _joint_palette() -> np.ndarray:
    """17 visually distinct bright colors (uint8). Identical-colored joints
    make left/right keypoints visually indistinguishable — a flip-symmetric
    pose is then irreducibly ambiguous and keypoint RMS floors at ~15% of
    box size. Distinct colors make the estimation task well-posed (the stand-in
    for the left/right visual asymmetries of real clothing/lighting)."""
    colors = np.empty((17, 3), np.float32)
    for j in range(17):
        h = (j * 0.61803398875) % 1.0  # golden-ratio hue spacing
        i = int(h * 6)
        f = h * 6 - i
        p, q, t = 0.25, 1 - 0.75 * f, 0.25 + 0.75 * f
        rgb = [(1, t, p), (q, 1, p), (p, 1, t), (p, q, 1), (t, p, 1), (1, p, q)][i % 6]
        colors[j] = rgb
    return (colors * 255).astype(np.uint8)


_JOINT_COLORS = _joint_palette()


def render_pose_frame(
    pose: np.ndarray,  # (17, 2) in [0,1] canonical coordinates
    height: int,
    width: int,
    rng: np.random.Generator,
    scale: float = 0.7,
    offset: Tuple[float, float] = (0.15, 0.15),
    joint_radius: int = 3,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render one skeleton -> (frame (H,W,3) uint8, box xyxy px, kpts (17,2) px)."""
    frame = rng.integers(0, 50, (height, width, 3)).astype(np.uint8)
    pts = np.empty((17, 2), np.float32)
    pts[:, 0] = (offset[0] + pose[:, 0] * scale) * width
    pts[:, 1] = (offset[1] + pose[:, 1] * scale) * height
    # limbs: line segments tinted by the average of the endpoint joint colors
    for a, b in _EDGES:
        limb_color = (0.6 * (_JOINT_COLORS[a].astype(np.float32)
                             + _JOINT_COLORS[b].astype(np.float32)) / 2).astype(np.uint8)
        for t in np.linspace(0, 1, 12):
            x = pts[a, 0] * (1 - t) + pts[b, 0] * t
            y = pts[a, 1] * (1 - t) + pts[b, 1] * t
            xi, yi = int(round(x)), int(round(y))
            if 0 <= yi < height - 1 and 0 <= xi < width - 1:
                frame[yi : yi + 2, xi : xi + 2] = limb_color
    # joints: per-index distinct-colored disks (see _joint_palette)
    for j, (x, y) in enumerate(pts):
        xi, yi = int(round(x)), int(round(y))
        y0, y1 = max(yi - joint_radius, 0), min(yi + joint_radius + 1, height)
        x0, x1 = max(xi - joint_radius, 0), min(xi + joint_radius + 1, width)
        if y0 < y1 and x0 < x1:
            frame[y0:y1, x0:x1] = _JOINT_COLORS[j]
    pad = 6.0
    box = np.array([pts[:, 0].min() - pad, pts[:, 1].min() - pad,
                    pts[:, 0].max() + pad, pts[:, 1].max() + pad], np.float32)
    box = np.clip(box, 0, [width, height, width, height])
    return frame, box, pts


def rendered_detection_batch(
    rng: np.random.Generator, batch: int, img_size: int, seq_source: Optional[np.ndarray] = None,
    joint_jitter: float = 0.10,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Training batch for the detector+pose head: rendered skeletons with GT
    (images in [0,1] f32, boxes (B,1,4), valid (B,1), kpts (B,1,17,2)).

    joint_jitter: per-joint canonical-coordinate noise added BEFORE rendering
    (GT moves with it). Without it every training pose is a small perturbation
    of the one dataset base pose, and the keypoint head converges to the
    scale-mapped MEAN pose — an RMS floor equal to the pose-noise magnitude
    (~0.15 box-normalized, measured) while ignoring the pixels. Jitter
    destroys that shortcut and forces visual localization."""
    if seq_source is None:
        ds = SyntheticPoseLiftDataset(num_samples=max(batch // 4, 2), seq_len=8,
                                      anomaly_ratio=0.5, seed=int(rng.integers(1 << 30)))
        seq_source = ds.poses.reshape(-1, 17, 2)
    images = np.empty((batch, img_size, img_size, 3), np.float32)
    boxes = np.zeros((batch, 1, 4), np.float32)
    valid = np.ones((batch, 1), bool)
    kpts = np.zeros((batch, 1, 17, 2), np.float32)
    for b in range(batch):
        pose = seq_source[rng.integers(len(seq_source))]
        if joint_jitter:
            pose = pose + rng.normal(0.0, joint_jitter, pose.shape)
        scale = rng.uniform(0.4, 0.8)
        off = (rng.uniform(0.02, 0.5), rng.uniform(0.02, 0.5))
        frame, box, pts = render_pose_frame(pose, img_size, img_size, rng, scale, off)
        images[b] = frame / 255.0
        boxes[b, 0] = box
        kpts[b, 0] = pts
    return images, boxes, valid, kpts


def _textured_background(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """Low-frequency textured background + clutter rectangles, float [0,1]."""
    gh, gw = height // 16 + 2, width // 16 + 2
    coarse = rng.uniform(0.05, 0.55, (gh, gw, 3)).astype(np.float32)
    # np.kron(coarse, ones((16, 16, 1)))'s values (each times 1.0), by copies
    up = coarse.repeat(16, axis=0).repeat(16, axis=1)[:height, :width]
    # cheap smoothing: average of 4 shifted copies
    sm = (up + np.roll(up, 5, 0) + np.roll(up, 5, 1) + np.roll(up, (5, 5), (0, 1))) / 4
    # horizontal brightness gradient (lighting)
    grad = np.linspace(rng.uniform(0.7, 1.0), rng.uniform(0.7, 1.0), width, dtype=np.float32)
    frame = sm * grad[None, :, None]
    # clutter: textured rectangles (shelves/fixtures — non-person negatives)
    for _ in range(int(rng.integers(3, 9))):
        rw = int(rng.integers(width // 10, width // 3))
        rh = int(rng.integers(height // 10, height // 2))
        x0 = int(rng.integers(0, max(width - rw, 1)))
        y0 = int(rng.integers(0, max(height - rh, 1)))
        color = rng.uniform(0.1, 0.9, 3).astype(np.float32)
        tex = rng.uniform(0.85, 1.15, (rh, rw, 1)).astype(np.float32)
        frame[y0:y0 + rh, x0:x0 + rw] = np.clip(color * tex, 0, 1)
    frame += rng.normal(0, 0.02, frame.shape).astype(np.float32)
    return np.clip(frame, 0.0, 1.0)


_DISK_MASKS: dict = {}


def _disk_mask(r: int) -> np.ndarray:
    """The (2r+1, 2r+1) mask dy^2 + dx^2 <= r^2, built once per radius."""
    m = _DISK_MASKS.get(r)
    if m is None:
        d = np.arange(-r, r + 1) ** 2
        m = _DISK_MASKS[r] = d[:, None] + d[None, :] <= r * r
    return m


_LIMB_WIDTH = {  # relative to person scale: torso fat, fingers thin
    (5, 6): 2.2, (5, 11): 2.4, (6, 12): 2.4, (11, 12): 2.2,  # torso box
    (5, 7): 1.2, (7, 9): 1.0, (6, 8): 1.2, (8, 10): 1.0,      # arms
    (11, 13): 1.5, (13, 15): 1.2, (12, 14): 1.5, (14, 16): 1.2,  # legs
}


def _draw_person(
    frame: np.ndarray,  # (H, W, 3) float, mutated
    owner: np.ndarray,  # (H, W) int, mutated — painter's pixel-owner map
    pid: int,
    pose: np.ndarray,  # (17, 2) canonical [0,1]
    rng: np.random.Generator,
    scale: float,
    offset: Tuple[float, float],
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Draw one textured person; returns (box xyxy, kpts px, drawn pixel count)."""
    height, width = frame.shape[:2]
    pts = np.empty((17, 2), np.float32)
    pts[:, 0] = (offset[0] + pose[:, 0] * scale) * width
    pts[:, 1] = (offset[1] + pose[:, 1] * scale) * height
    body_r = max(1.5, 2.8 * scale * min(height, width) / 64.0)
    shirt = rng.uniform(0.15, 0.95, 3).astype(np.float32)
    pants = rng.uniform(0.1, 0.85, 3).astype(np.float32)
    skin = np.array([0.85, 0.65, 0.5], np.float32) * rng.uniform(0.6, 1.1)
    drawn = 0

    def disk(x: float, y: float, r: float, color: np.ndarray):
        nonlocal drawn
        xi, yi, ri = int(round(x)), int(round(y)), max(int(round(r)), 1)
        y0, y1 = max(yi - ri, 0), min(yi + ri + 1, height)
        x0, x1 = max(xi - ri, 0), min(xi + ri + 1, width)
        if y0 >= y1 or x0 >= x1:
            return
        # the window's part of the disk (y - yi)^2 + (x - xi)^2 <= ri^2
        m = _disk_mask(ri)[y0 - yi + ri:y1 - yi + ri, x0 - xi + ri:x1 - xi + ri]
        tex = rng.uniform(0.85, 1.15)
        frame[y0:y1, x0:x1][m] = np.clip(color * tex, 0, 1)
        owner[y0:y1, x0:x1][m] = pid
        drawn += int(m.sum())

    # limbs back-to-front: legs, torso, arms, head
    order = [(11, 13), (13, 15), (12, 14), (14, 16),
             (5, 11), (6, 12), (11, 12), (5, 6),
             (5, 7), (7, 9), (6, 8), (8, 10)]
    for a, b in order:
        wfac = _LIMB_WIDTH.get((a, b), _LIMB_WIDTH.get((b, a), 1.0))
        color = pants if a >= 11 else shirt
        # left/right shading asymmetry (COCO: odd joints = left side) — the
        # visual cue real clothing/lighting provides; without it flip-symmetric
        # poses make left/right keypoints irreducibly ambiguous
        if a > 0:
            color = color * (1.18 if a % 2 == 1 else 0.82)
        seg = np.linalg.norm(pts[a] - pts[b])
        n = max(int(seg / max(body_r * 0.7, 1.0)) + 1, 2)
        for t in np.linspace(0, 1, n):
            p = pts[a] * (1 - t) + pts[b] * t
            disk(p[0], p[1], body_r * wfac, color)
    # hands/feet + head
    for j in (9, 10):
        disk(pts[j, 0], pts[j, 1], body_r * 0.9, skin * (1.18 if j % 2 == 1 else 0.82))
    head_c = (pts[0] + (pts[1] + pts[2]) / 2) / 2
    disk(head_c[0], head_c[1], body_r * 2.0, skin)
    for j in (0, 1, 2, 3, 4):
        disk(pts[j, 0], pts[j, 1], body_r * 0.5, skin * 0.9)

    pad = body_r * 2.4
    box = np.array([pts[:, 0].min() - pad, pts[:, 1].min() - pad,
                    pts[:, 0].max() + pad, pts[:, 1].max() + pad], np.float32)
    box = np.clip(box, 0, [width, height, width, height])
    return box, pts, drawn


def render_scene(
    rng: np.random.Generator,
    height: int,
    width: int,
    max_persons: int = 4,
    seq_source: Optional[np.ndarray] = None,
    min_scale: float = 0.12,
    max_scale: float = 0.75,
    occluder_prob: float = 0.3,
    min_visibility: float = 0.3,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Hard multi-person scene: textured background/clutter, 1..max_persons
    textured bodies at varied scales drawn back-to-front (real occlusion),
    optional foreground occluder.

    Returns (frame (H,W,3) f32 [0,1], boxes (max_persons,4), valid
    (max_persons,), kpts (max_persons,17,2), visibility (max_persons,)).
    `valid` is visibility >= min_visibility; heavily-occluded people keep
    their geometry but are masked out of the loss/eval.
    """
    if seq_source is None:
        ds = SyntheticPoseLiftDataset(num_samples=4, seq_len=8, anomaly_ratio=0.5,
                                      seed=int(rng.integers(1 << 30)))
        seq_source = ds.poses.reshape(-1, 17, 2)
    frame = _textured_background(rng, height, width)
    owner = np.full((height, width), -1, np.int32)
    n = int(rng.integers(1, max_persons + 1))
    scales = np.sort(rng.uniform(min_scale, max_scale, n))  # small (far) first
    boxes = np.zeros((max_persons, 4), np.float32)
    kpts = np.zeros((max_persons, 17, 2), np.float32)
    vis = np.zeros(max_persons, np.float32)
    drawn_counts = np.zeros(max_persons, np.int64)
    for i in range(n):
        pose = seq_source[rng.integers(len(seq_source))]
        s = float(scales[i])
        off = (rng.uniform(-0.1, 1.0 - s * 0.8), rng.uniform(-0.05, 1.0 - s * 0.9))
        boxes[i], kpts[i], _ = _draw_person(frame, owner, i, pose, rng, s, off)
        # unique footprint BEFORE later (nearer) people/occluders draw over it
        drawn_counts[i] = int((owner == i).sum())
    # foreground occluder: a textured pillar/crate over everything
    if rng.uniform() < occluder_prob:
        ow = int(rng.integers(width // 12, width // 4))
        oh = int(rng.integers(height // 3, height))
        x0 = int(rng.integers(0, max(width - ow, 1)))
        y0 = int(rng.integers(0, max(height - oh, 1)))
        color = rng.uniform(0.2, 0.8, 3).astype(np.float32)
        tex = rng.uniform(0.9, 1.1, (oh, ow, 1)).astype(np.float32)
        frame[y0:y0 + oh, x0:x0 + ow] = np.clip(color * tex, 0, 1)
        owner[y0:y0 + oh, x0:x0 + ow] = -2
    for i in range(n):
        if drawn_counts[i] > 0:
            vis[i] = float((owner == i).sum()) / float(drawn_counts[i])
    valid = vis >= min_visibility
    return frame, boxes, valid, kpts, vis


def rendered_scene_batch(
    rng: np.random.Generator,
    batch: int,
    img_size: int,
    max_persons: int = 4,
    seq_source: Optional[np.ndarray] = None,
    **scene_kwargs,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Batch of hard scenes for detector training/eval:
    (images (B,S,S,3) f32, boxes (B,P,4), valid (B,P), kpts (B,P,17,2))."""
    if seq_source is None:
        ds = SyntheticPoseLiftDataset(num_samples=max(batch // 2, 4), seq_len=8,
                                      anomaly_ratio=0.5, seed=int(rng.integers(1 << 30)))
        seq_source = ds.poses.reshape(-1, 17, 2)
    images = np.empty((batch, img_size, img_size, 3), np.float32)
    boxes = np.zeros((batch, max_persons, 4), np.float32)
    valid = np.zeros((batch, max_persons), bool)
    kpts = np.zeros((batch, max_persons, 17, 2), np.float32)
    for b in range(batch):
        images[b], boxes[b], valid[b], kpts[b], _ = render_scene(
            rng, img_size, img_size, max_persons, seq_source, **scene_kwargs)
    return images, boxes, valid, kpts


def render_pose_video(
    path: str,
    poses: np.ndarray,  # (T, 17, 2) canonical
    width: int = 320,
    height: int = 240,
    fps: float = 30.0,
    seed: int = 0,
    scale: float = 0.7,
    offset: Tuple[float, float] = (0.15, 0.15),
) -> str:
    """Render a pose sequence as an mp4 (one moving person); needs cv2."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("render_pose_video writes the video with cv2 (OpenCV), "
                           "which is not installed") from e

    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
    try:
        for pose in poses:
            frame, _box, _pts = render_pose_frame(pose, height, width, rng, scale, offset)
            writer.write(frame[..., ::-1])  # RGB -> BGR
    finally:
        writer.release()
    return path


def rendered_pose_crop_batch(
    rng: np.random.Generator, batch: int, frame_size: int = 96,
    joint_jitter: float = 0.10, box_jitter: float = 0.08,
    seq_source: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Training batch for the TOP-DOWN pose net: single-person frames with
    box-jittered GT boxes (simulating imperfect detections) and keypoints.
    Returns (frames (B, S, S, 3) f32 in [0,1], boxes (B, 4) xyxy px,
    kpts (B, 17, 2) px)."""
    if seq_source is None:
        ds = SyntheticPoseLiftDataset(num_samples=max(batch // 4, 2), seq_len=8,
                                      anomaly_ratio=0.5, seed=int(rng.integers(1 << 30)))
        seq_source = ds.poses.reshape(-1, 17, 2)
    frames = np.empty((batch, frame_size, frame_size, 3), np.float32)
    boxes = np.zeros((batch, 4), np.float32)
    kpts = np.zeros((batch, 17, 2), np.float32)
    for b in range(batch):
        pose = seq_source[rng.integers(len(seq_source))]
        if joint_jitter:
            pose = pose + rng.normal(0.0, joint_jitter, pose.shape)
        scale = rng.uniform(0.4, 0.85)
        off = (rng.uniform(0.02, 0.5), rng.uniform(0.02, 0.5))
        frame, box, pts = render_pose_frame(pose, frame_size, frame_size, rng, scale, off)
        frames[b] = frame / 255.0
        w, h = box[2] - box[0], box[3] - box[1]
        jit = rng.normal(0.0, box_jitter, 4) * np.array([w, h, w, h], np.float32)
        boxes[b] = np.clip(box + jit, 0, [frame_size] * 4)
        kpts[b] = pts
    return frames, boxes, kpts
