"""Batching layer: static-shape batches with pad-and-mask, and the
data-module facade (the port's copy of ``cvsd_tpu/data/datamodule.py``,
numpy only).

Batches are dense numpy slices of one preloaded array (thousands of
12x18x2 sequences). Every batch has the SAME static shape: the last partial
batch is zero-padded and carries a ``mask``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np

from cvsd_tpu_torch.data.poselift import PoseLiftDataset
from cvsd_tpu_torch.data.synthetic import SyntheticPoseLiftDataset


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


class PoseLiftDataModule:
    """Config-driven train/test datasets + static-shape batch iterators."""

    def __init__(self, config: Dict[str, Any], verbose: bool = True):
        self.config = config
        self.verbose = verbose
        self.train_dataset = None
        self.test_dataset = None

    def setup(self) -> "PoseLiftDataModule":
        kind = self.config["data"].get("dataset", "poselift")
        if kind == "synthetic":
            self.train_dataset = SyntheticPoseLiftDataset.from_config(self.config, "train")
            self.test_dataset = SyntheticPoseLiftDataset.from_config(self.config, "test")
        else:
            self.train_dataset = PoseLiftDataset.from_config(self.config, "train", verbose=self.verbose)
            self.test_dataset = PoseLiftDataset.from_config(self.config, "test", verbose=self.verbose)
        return self

    @property
    def batch_size(self) -> int:
        return int(self.config["data"].get("batch_size", 32))

    def train_batches(self, epoch: int = 0, pad_to_multiple_of: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        ds = self.train_dataset
        return batch_iterator(
            ds.poses,
            ds.labels,
            batch_size=self.batch_size,
            shuffle=True,
            drop_last=True,  # v2 semantics: train drop_last (poselift_dataset.py:636-662)
            seed=int(self.config.get("experiment", {}).get("seed", 0)) + epoch,
            pad_to_multiple_of=pad_to_multiple_of,
        )

    def test_batches(self, pad_to_multiple_of: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        ds = self.test_dataset
        return batch_iterator(
            ds.poses,
            ds.labels,
            batch_size=self.batch_size,
            shuffle=False,
            drop_last=False,
            pad_to_multiple_of=pad_to_multiple_of,
        )

    def steps_per_epoch(self, pad_to_multiple_of: int = 1) -> int:
        """Batches per epoch. With ``pad_to_multiple_of``, train_batches rounds
        the batch size up to that multiple, so schedules must count with the
        padded batch size or they decay slower than configured."""
        bs = self.batch_size
        m = int(pad_to_multiple_of)
        if m > 1 and bs % m:
            bs = ((bs + m - 1) // m) * m
        return len(self.train_dataset) // bs

    def get_stats(self) -> Dict[str, int]:
        """Train/test/normal/anomaly counts
        (reference: shopformer_2/data/poselift_dataset.py:664-676)."""
        tr, te = self.train_dataset, self.test_dataset
        return {
            "num_train": len(tr),
            "num_test": len(te),
            "test_normal": int((te.labels == 0).sum()),
            "test_anomaly": int((te.labels == 1).sum()),
        }
