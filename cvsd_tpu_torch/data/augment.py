"""Pose augmentation (PyTorch port of ``cvsd_tpu/data/augment.py``).

- The numpy per-sequence ``PoseAugmentor`` and its helpers
  (``affine_matrix``, ``apply_affine``, ``flip_keypoints``) are copied: the
  same seed gives the same arrays bit for bit.
- The batched path augments a whole (B, T, V, C) batch on its device,
  drawing from one explicit ``torch.Generator`` (on the batch's device), in
  the JAX order: per-sample affine (flip, scale, rotation, shear,
  translation), the flip-pair swap, coordinate jitter, temporal dropout,
  keypoint dropout, the adjacent-frame time warp, then mixup. It matches
  JAX's distributions, not its bits: ``jax.random`` and torch's generators
  draw different numbers.

COCO keypoint flip pairs are also what flip-TTA mirrors keypoints with.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

COCO_KEYPOINT_FLIP_PAIRS = (
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16),
)


def flip_permutation(num_keypoints: int) -> np.ndarray:
    """Index permutation implementing the left/right keypoint swap.
    The neck (17) is central and maps to itself."""
    perm = np.arange(num_keypoints)
    for l, r in COCO_KEYPOINT_FLIP_PAIRS:
        if l < num_keypoints and r < num_keypoints:
            perm[l], perm[r] = r, l
    return perm


def affine_matrix(
    sx: float = 1.0,
    sy: float = 1.0,
    tx: float = 0.0,
    ty: float = 0.0,
    rot: float = 0.0,
    shearx: float = 0.0,
    sheary: float = 0.0,
    flip: bool = False,
) -> np.ndarray:
    """3x3 affine transform (reference: shopformer_2/data/poselift_dataset.py:94-131)."""
    cos_r = math.cos(math.radians(rot))
    sin_r = math.sin(math.radians(rot))
    f = -1.0 if flip else 1.0
    return np.array(
        [
            [sx * f * cos_r - sheary * sy * sin_r, shearx * sx * f * cos_r - sy * sin_r, tx * cos_r - ty * sin_r],
            [sx * f * sin_r + sheary * sy * cos_r, shearx * sx * f * sin_r + sy * cos_r, tx * sin_r + ty * cos_r],
            [0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )


def apply_affine(pose_seq: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Apply a 3x3 affine to a (T, V, C>=2) sequence; extra channels untouched
    (reference: shopformer_2/data/poselift_dataset.py:134-155)."""
    out = pose_seq.copy()
    coords = pose_seq[:, :, :2]
    coords_h = np.concatenate([coords, np.ones((*coords.shape[:2], 1), coords.dtype)], axis=-1)
    out[:, :, :2] = np.einsum("tvc,dc->tvd", coords_h, mat[:2, :])
    return out


def flip_keypoints(pose_seq: np.ndarray, num_keypoints: int = 17) -> np.ndarray:
    """Left/right pair swap after horizontal flip
    (reference: shopformer_2/data/poselift_dataset.py:158-167)."""
    return pose_seq[:, flip_permutation(num_keypoints)]


class PoseAugmentor:
    """NumPy per-sequence augmentor (host path; the golden reference for the
    batched version). Same knobs as the reference PoseAugmentor
    (shopformer_2/data/poselift_dataset.py:170-285)."""

    def __init__(
        self,
        flip_prob: float = 0.5,
        jitter_std: float = 0.02,
        scale_range: Tuple[float, float] = (0.9, 1.1),
        rotation_range: float = 10.0,
        shear_range: float = 0.1,
        translation_range: float = 0.1,
        temporal_dropout_prob: float = 0.1,
        keypoint_dropout_prob: float = 0.0,
        num_keypoints: int = 17,
        seed: int = 0,
    ):
        self.flip_prob = flip_prob
        self.jitter_std = jitter_std
        self.scale_range = tuple(scale_range)
        self.rotation_range = rotation_range
        self.shear_range = shear_range
        self.translation_range = translation_range
        self.temporal_dropout_prob = temporal_dropout_prob
        self.keypoint_dropout_prob = keypoint_dropout_prob
        self.num_keypoints = num_keypoints
        self.rng = np.random.default_rng(seed)

    @classmethod
    def from_config(cls, config: Dict[str, Any], seed: int = 0) -> "PoseAugmentor":
        a = config.get("data", {}).get("augment", {})
        rot = a.get("rotation_range", 10.0)
        rot = max(abs(rot[0]), abs(rot[1])) if isinstance(rot, (list, tuple)) else rot
        shear = a.get("shear_range", 0.0)
        shear = max(abs(shear[0]), abs(shear[1])) if isinstance(shear, (list, tuple)) else shear
        trans = a.get("translate_range", 0.0)
        trans = max(abs(trans[0]), abs(trans[1])) if isinstance(trans, (list, tuple)) else trans
        return cls(
            flip_prob=a.get("flip_prob", 0.5),
            jitter_std=a.get("jitter_std", 0.02),
            scale_range=tuple(a.get("scale_range", [0.9, 1.1])),
            rotation_range=rot,
            shear_range=shear,
            translation_range=trans,
            temporal_dropout_prob=a.get("temporal_dropout_prob", 0.1),
            keypoint_dropout_prob=a.get("keypoint_dropout_prob", 0.0),
            num_keypoints=config.get("model", {}).get("num_keypoints", 17),
            seed=seed,
        )

    def __call__(self, pose_seq: np.ndarray) -> np.ndarray:
        rng = self.rng
        do_flip = rng.random() < self.flip_prob
        scale = rng.uniform(*self.scale_range)
        rot = rng.uniform(-self.rotation_range, self.rotation_range)
        shearx = rng.uniform(-self.shear_range, self.shear_range)
        sheary = rng.uniform(-self.shear_range, self.shear_range)
        tx = rng.uniform(-self.translation_range, self.translation_range)
        ty = rng.uniform(-self.translation_range, self.translation_range)
        mat = affine_matrix(scale, scale, tx, ty, rot, shearx, sheary, do_flip)
        out = apply_affine(pose_seq, mat)
        if do_flip:
            out = flip_keypoints(out, self.num_keypoints)
        if self.jitter_std > 0:
            out[:, :, :2] += rng.normal(0, self.jitter_std, out[:, :, :2].shape)
        if self.temporal_dropout_prob > 0:
            tmask = rng.random(out.shape[0]) < self.temporal_dropout_prob
            out[tmask] = 0
        if self.keypoint_dropout_prob > 0:
            kmask = rng.random(out.shape[:2]) < self.keypoint_dropout_prob
            out[kmask] = 0
        return out.astype(pose_seq.dtype)


# ---------------------------------------------------------------- batched, on the device


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, like: torch.Tensor) -> torch.Tensor:
    """U[lo, hi) as jax.random.uniform draws it: u * (hi - lo) + lo."""
    u = torch.rand(shape, generator=gen, device=like.device, dtype=like.dtype)
    return u * (hi - lo) + lo


def _bernoulli(gen: torch.Generator, p: float, shape, device) -> torch.Tensor:
    """True with probability p (jax.random.bernoulli: uniform < p)."""
    return torch.rand(shape, generator=gen, device=device) < p


def time_warp_permutation(gen: torch.Generator, batch: int, seq_len: int, prob: float,
                          device=None) -> torch.Tensor:
    """(B, T) frame-index permutations of the v1 adjacent-frame time warp:
    with probability ``prob`` per sample, swap 1-2 random adjacent frame
    pairs, applied one after the other (so overlapping draws compose like
    the reference's in-place swaps)."""
    warp = _bernoulli(gen, prob, (batch,), device) & (seq_len > 2)
    num_swaps = torch.randint(1, 3, (batch,), generator=gen, device=device)  # 1 or 2
    idx1 = torch.randint(0, max(seq_len - 1, 1), (batch,), generator=gen, device=device)
    idx2 = torch.randint(0, max(seq_len - 1, 1), (batch,), generator=gen, device=device)
    t = torch.arange(seq_len, device=device)
    perm = t.expand(batch, seq_len)

    def apply_swap(perm, idx, active):
        at_i = t[None, :] == idx[:, None]
        at_i1 = t[None, :] == (idx[:, None] + 1)
        val_i = torch.gather(perm, 1, idx[:, None])
        val_i1 = torch.gather(perm, 1, torch.clamp(idx[:, None] + 1, max=seq_len - 1))
        swapped = torch.where(at_i, val_i1, torch.where(at_i1, val_i, perm))
        return torch.where(active[:, None], swapped, perm)

    perm = apply_swap(perm, idx1, warp)
    return apply_swap(perm, idx2, warp & (num_swaps == 2))


def batched_time_warp(gen: torch.Generator, poses: torch.Tensor, prob: float) -> torch.Tensor:
    """The adjacent-frame time warp on a (B, T, V, C) batch."""
    B, T = poses.shape[:2]
    perm = time_warp_permutation(gen, B, T, prob, poses.device)
    return torch.gather(poses, 1, perm[:, :, None, None].expand_as(poses))


def _standard_gamma(gen: torch.Generator, alpha: float, device, tries: int = 32) -> torch.Tensor:
    """One Gamma(alpha, 1) draw on ``device`` from ``gen``, without a host
    round trip: Marsaglia-Tsang's squeeze on ``tries`` candidates at once,
    the first accepted one taken (each is accepted with probability > 0.95,
    so all 32 rejected has probability < 1e-41); alpha < 1 boosts
    Gamma(alpha + 1) by U^(1/alpha)."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    x = torch.randn(tries, generator=gen, device=device, dtype=torch.float64)
    u = torch.rand(tries, generator=gen, device=device, dtype=torch.float64)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(torch.clamp(v, min=1e-300)))
    g = d * v[torch.argmax(ok.to(torch.int8))]
    if alpha < 1.0:
        g = g * torch.rand((), generator=gen, device=device, dtype=torch.float64) ** (1.0 / alpha)
    return g


def batched_mixup(gen: torch.Generator, poses: torch.Tensor, alpha: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch-level mixup: one lam ~ Beta(alpha, alpha) per batch, blended
    with a random permutation of the batch. Returns (mixed, lam, perm)."""
    g1 = _standard_gamma(gen, alpha, poses.device)
    g2 = _standard_gamma(gen, alpha, poses.device)
    lam = (g1 / (g1 + g2)).to(poses.dtype)
    perm = torch.randperm(poses.shape[0], generator=gen, device=poses.device)
    mixed = lam * poses + (1.0 - lam) * poses[perm]
    return mixed, lam, perm


def batched_augment(
    gen: torch.Generator,
    poses: torch.Tensor,  # (B, T, V, C)
    flip_prob: float = 0.5,
    jitter_std: float = 0.01,
    scale_range: Tuple[float, float] = (0.9, 1.1),
    rotation_range: float = 10.0,
    shear_range: float = 0.0,
    translation_range: float = 0.0,
    temporal_dropout_prob: float = 0.1,
    keypoint_dropout_prob: float = 0.05,
    time_warp_prob: float = 0.0,
    mixup_alpha: float = 0.0,
) -> torch.Tensor:
    """Whole-batch augmentation on the batch's device: a per-sample affine
    (flip, scale, rotation, shear, translation), the flip-pair swap,
    coordinate jitter, temporal and keypoint dropout, the time warp and
    mixup, in that order."""
    B, T, V, C = poses.shape
    dev = poses.device
    flip = _bernoulli(gen, flip_prob, (B,), dev)
    scale = _uniform(gen, (B,), scale_range[0], scale_range[1], poses)
    rot = torch.deg2rad(_uniform(gen, (B,), -rotation_range, rotation_range, poses))
    shearx = _uniform(gen, (B,), -shear_range, shear_range, poses)
    sheary = _uniform(gen, (B,), -shear_range, shear_range, poses)
    txy = _uniform(gen, (B, 2), -translation_range, translation_range, poses)

    cos_r, sin_r = torch.cos(rot), torch.sin(rot)
    f = torch.where(flip, -1.0, 1.0).to(poses.dtype)
    sx = sy = scale
    m00 = sx * f * cos_r - sheary * sy * sin_r
    m01 = shearx * sx * f * cos_r - sy * sin_r
    m02 = txy[:, 0] * cos_r - txy[:, 1] * sin_r
    m10 = sx * f * sin_r + sheary * sy * cos_r
    m11 = shearx * sx * f * sin_r + sy * cos_r
    m12 = txy[:, 0] * sin_r + txy[:, 1] * cos_r
    mat = torch.stack([torch.stack([m00, m01, m02], -1), torch.stack([m10, m11, m12], -1)], 1)

    coords_h = torch.cat([poses[..., :2], torch.ones((B, T, V, 1), dtype=poses.dtype, device=dev)],
                         dim=-1)
    new_coords = torch.einsum("btvc,bdc->btvd", coords_h, mat)

    # the flip-pair swap where flipped
    perm = torch.from_numpy(flip_permutation(V)).to(dev)
    new_coords = torch.where(flip[:, None, None, None], new_coords[:, :, perm], new_coords)

    if jitter_std > 0:
        new_coords = new_coords + jitter_std * torch.randn(
            new_coords.shape, generator=gen, device=dev, dtype=poses.dtype)

    out = torch.cat([new_coords, poses[..., 2:]], dim=-1) if C > 2 else new_coords
    zero = torch.zeros((), dtype=poses.dtype, device=dev)
    if temporal_dropout_prob > 0:
        tmask = _bernoulli(gen, temporal_dropout_prob, (B, T), dev)
        out = torch.where(tmask[:, :, None, None], zero, out)
    if keypoint_dropout_prob > 0:
        kmask = _bernoulli(gen, keypoint_dropout_prob, (B, T, V), dev)
        out = torch.where(kmask[..., None], zero, out)
    # the v1 batch-level extras, in the reference's order: warp, then mixup
    if time_warp_prob > 0:
        out = batched_time_warp(gen, out, time_warp_prob)
    if mixup_alpha > 0 and B > 1:
        out, _, _ = batched_mixup(gen, out, mixup_alpha)
    return out


def batched_augment_from_config(gen: torch.Generator, poses: torch.Tensor,
                                config: Dict[str, Any]) -> torch.Tensor:
    a = config.get("data", {}).get("augment", {})

    def sym(v, default=0.0):
        v = a.get(v, default)
        return max(abs(v[0]), abs(v[1])) if isinstance(v, (list, tuple)) else abs(v)

    return batched_augment(
        gen,
        poses,
        flip_prob=a.get("flip_prob", 0.5),
        jitter_std=a.get("jitter_std", 0.01),
        scale_range=tuple(a.get("scale_range", [0.9, 1.1])),
        rotation_range=sym("rotation_range", 10.0),
        shear_range=sym("shear_range", 0.0),
        translation_range=sym("translate_range", 0.0),
        temporal_dropout_prob=a.get("temporal_dropout_prob", 0.1),
        keypoint_dropout_prob=a.get("keypoint_dropout_prob", 0.05),
        time_warp_prob=a.get("time_warp_prob", 0.0),
        mixup_alpha=a.get("mixup_alpha", 0.0),
    )
