"""Skeleton graph layouts and normalized adjacency (static constants).

Capability parity with the original Shopformer code's
get_skeleton_adjacency/normalize_adjacency (coco/openpose layouts in v1;
the coco_with_neck layout and symmetric D^-1/2 (A+I) D^-1/2 normalization
in v2).

The port's own copy of ``cvsd_tpu/models/graph.py`` (numpy only); the
torch GCAE holds these tables as constant buffers.
"""

from __future__ import annotations

import numpy as np

# COCO-17: 0 nose, 1/2 eyes, 3/4 ears, 5/6 shoulders, 7/8 elbows, 9/10 wrists,
# 11/12 hips, 13/14 knees, 15/16 ankles.
_COCO_EDGES = (
    (0, 1), (0, 2), (1, 3), (2, 4),          # head
    (0, 5), (0, 6),                          # nose -> shoulders
    (5, 7), (7, 9), (6, 8), (8, 10),         # arms
    (5, 11), (6, 12), (11, 12),              # torso
    (11, 13), (13, 15), (12, 14), (14, 16),  # legs
)

# COCO-17 + synthetic neck at index 17: nose->neck->shoulders replaces nose->shoulders.
_COCO_NECK_EDGES = (
    (0, 1), (0, 2), (1, 3), (2, 4),
    (0, 17), (17, 5), (17, 6),
    (5, 7), (7, 9), (6, 8), (8, 10),
    (5, 11), (6, 12), (11, 12),
    (11, 13), (13, 15), (12, 14), (14, 16),
)

# OpenPose-18 (BODY_18): 1 is the neck hub.
_OPENPOSE_EDGES = (
    (0, 1), (0, 14), (0, 15), (14, 16), (15, 17),
    (1, 2), (2, 3), (3, 4),
    (1, 5), (5, 6), (6, 7),
    (1, 8), (8, 9), (9, 10),
    (1, 11), (11, 12), (12, 13),
)

_LAYOUTS = {
    "coco": (_COCO_EDGES, 17),
    "coco_with_neck": (_COCO_NECK_EDGES, 18),
    "openpose": (_OPENPOSE_EDGES, 18),
}


def get_skeleton_adjacency(num_keypoints: int = 17, layout: str = "coco") -> np.ndarray:
    """Binary adjacency with self-loops for the given skeleton layout."""
    if layout not in _LAYOUTS:
        # v2 fallback: 18 keypoints with an unspecified layout means coco_with_neck
        if num_keypoints == 18:
            layout = "coco_with_neck"
        else:
            raise ValueError(f"unknown skeleton layout {layout!r}")
    edges, _ = _LAYOUTS[layout]
    adj = np.zeros((num_keypoints, num_keypoints), dtype=np.float64)
    for i, j in edges:
        if i < num_keypoints and j < num_keypoints:
            adj[i, j] = adj[j, i] = 1.0
    return adj + np.eye(num_keypoints)


def normalize_adjacency(adj: np.ndarray) -> np.ndarray:
    """Symmetric normalization D^-1/2 A D^-1/2 (zeros for isolated nodes)."""
    d = adj.sum(axis=1)
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.power(d, -0.5)
    d_inv_sqrt[~np.isfinite(d_inv_sqrt)] = 0.0
    return (adj * d_inv_sqrt[None, :]) * d_inv_sqrt[:, None]


def normalized_skeleton_adjacency(num_keypoints: int = 17, layout: str = "coco") -> np.ndarray:
    return normalize_adjacency(get_skeleton_adjacency(num_keypoints, layout)).astype(np.float32)


def compute_strides(seq_len: int, num_tokens: int, num_layers: int) -> list:
    """Per-layer temporal strides reducing seq_len -> num_tokens: prime-factorize
    the reduction, distribute factors, sort descending; callers adaptive-pool
    any remainder (reference: shopformer_2/models/gcae.py:331-373)."""
    strides = [1] * num_layers
    remaining = max(seq_len // max(num_tokens, 1), 1)
    factors = []
    for p in (2, 3, 5, 7):
        while remaining % p == 0 and remaining > 1:
            factors.append(p)
            remaining //= p
    if remaining > 1:
        factors.append(remaining)
    factors.sort()
    for i, f in enumerate(factors):
        if i < num_layers:
            strides[i] = f
    strides.sort(reverse=True)
    return strides


def compute_strides_v1(seq_len: int, num_tokens: int, num_layers: int) -> list:
    """The v1 reference's greedy halving strides (shopformer/models/
    gcae.py:317-329): halve while it stays >= num_tokens, one layer at a
    time. Unlike compute_strides, may NOT land exactly on num_tokens
    (e.g. 12 -> 6 -> 3 with tokens=2); v1 simply emits that many tokens.
    Used by the checkpoint importer (utils/shopformer_import.py) to mirror
    v1 architectures exactly."""
    strides = [1] * num_layers
    current = seq_len
    for i in range(num_layers):
        if current > num_tokens and current // 2 >= num_tokens:
            strides[i] = 2
            current //= 2
    return strides


def adaptive_pool_matrix(in_len: int, out_len: int) -> np.ndarray:
    """(out_len, in_len) row-stochastic matrix implementing AdaptiveAvgPool1d
    semantics (window [floor(i*L/O), ceil((i+1)*L/O))) as a single matmul —
    the matmul form of the reference's AdaptiveAvgPool2d safety net
    (shopformer_2/models/gcae.py:329, :405-415)."""
    P = np.zeros((out_len, in_len), dtype=np.float32)
    for i in range(out_len):
        lo = (i * in_len) // out_len
        hi = -(-((i + 1) * in_len) // out_len)  # ceil
        P[i, lo:hi] = 1.0 / (hi - lo)
    return P
