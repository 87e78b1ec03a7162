"""Static-shape batching with pad-and-mask (the port's copy of
``batch_iterator`` from ``cvsd_tpu/data/datamodule.py``): every batch has the
same shape; the last partial batch is zero-padded and carries a ``mask``."""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def batch_iterator(
    poses: np.ndarray,
    labels: Optional[np.ndarray] = None,
    batch_size: int = 32,
    shuffle: bool = False,
    drop_last: bool = False,
    seed: int = 0,
    pad_to_multiple_of: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield dict batches {poses, labels, mask, index} of identical static shape.

    ``pad_to_multiple_of`` lets callers keep the batch divisible by the mesh's
    data-axis size so pjit sharding never sees ragged leading dims.
    """
    n = poses.shape[0]
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    bs = int(batch_size)
    if bs % pad_to_multiple_of != 0:
        bs = ((bs + pad_to_multiple_of - 1) // pad_to_multiple_of) * pad_to_multiple_of
    for start in range(0, n, bs):
        idx = order[start : start + bs]
        if idx.size < bs and drop_last:
            return
        k = idx.size
        if k < bs:
            idx = np.concatenate([idx, np.zeros(bs - k, dtype=idx.dtype)])
        batch = {
            "poses": poses[idx],
            "mask": (np.arange(bs) < k).astype(np.float32),
            "index": idx.astype(np.int32),
        }
        if labels is not None:
            batch["labels"] = labels[idx].astype(np.int32)
        yield batch
