"""YOLO-format detection dataset loader, ultralytics' dataset layout (the
port's copy of ``cvsd_tpu/data/yolo_dataset.py``).

``images/*.jpg`` with sibling ``labels/*.txt``, each line ``class cx cy w h``
(normalized xywh), optionally followed by keypoint triples ``px py vis``,
all described by a ``data.yaml``. Read into the static-shape padded batches
``train/detector_train.py::DetectorTrainer`` takes: images (B, S, S, 3) f32
in [0, 1] letterboxed, boxes (B, P, 4) xyxy canvas px, valid (B, P), kpts
(B, P, K, 2) canvas px. Images are read and resized with cv2, imported only
where an image is read (``load``, which raises naming cv2 without it);
``yaml`` only inside ``from_data_yaml``.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from cvsd_tpu_torch.ops.letterbox import PAD_VALUE, letterbox_params

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def _labels_dir_for(images_dir: str) -> str:
    """Ultralytics convention: replace the last 'images' path component."""
    parts = os.path.normpath(images_dir).split(os.sep)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "images":
            parts[i] = "labels"
            return os.sep.join(parts)
    return os.path.join(os.path.dirname(os.path.normpath(images_dir)), "labels")


def parse_yolo_label(
    path: str,
    classes: Optional[Sequence[int]] = None,
    num_keypoints: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """One label .txt -> (boxes (N,4) normalized cxcywh, kpts (N,K,2) normalized).

    Missing file = no objects (ultralytics' background-image convention).
    Keypoints marked invisible (v == 0) are set to NaN so consumers can mask.
    """
    boxes: List[List[float]] = []
    kpts: List[np.ndarray] = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                vals = line.split()
                if len(vals) < 5:
                    continue
                cls = int(float(vals[0]))
                if classes is not None and cls not in classes:
                    continue
                boxes.append([float(v) for v in vals[1:5]])
                if num_keypoints:
                    rest = [float(v) for v in vals[5:]]
                    per = len(rest) // num_keypoints if num_keypoints else 0
                    k = np.full((num_keypoints, 2), np.nan, np.float32)
                    if per in (2, 3):
                        arr = np.asarray(rest[: num_keypoints * per],
                                         np.float32).reshape(num_keypoints, per)
                        k[:, :2] = arr[:, :2]
                        if per == 3:
                            k[arr[:, 2] <= 0] = np.nan
                    kpts.append(k)
    b = np.asarray(boxes, np.float32).reshape(-1, 4)
    k = (np.stack(kpts) if kpts else
         np.zeros((0, num_keypoints, 2), np.float32))
    return b, k


class YOLODetectionDataset:
    """Iterate a YOLO-layout dataset as DetectorTrainer-ready padded batches."""

    def __init__(
        self,
        images_dir: str,
        labels_dir: Optional[str] = None,
        img_size: int = 320,
        max_persons: int = 16,
        classes: Optional[Sequence[int]] = (0,),
        num_keypoints: int = 0,
    ):
        self.images_dir = images_dir
        self.labels_dir = labels_dir or _labels_dir_for(images_dir)
        self.img_size = int(img_size)
        self.max_persons = int(max_persons)
        self.classes = tuple(classes) if classes is not None else None
        self.num_keypoints = int(num_keypoints)
        self.files = sorted(
            f for f in os.listdir(images_dir)
            if f.lower().endswith(_IMG_EXTS))
        if not self.files:
            raise ValueError(f"no images under {images_dir}")

    @classmethod
    def from_data_yaml(cls, path: str, split: str = "train", **kw) -> "YOLODetectionDataset":
        """Build from an ultralytics data.yaml ({path, train, val, kpt_shape})."""
        import yaml

        with open(path) as f:
            spec = yaml.safe_load(f) or {}
        root = spec.get("path") or os.path.dirname(os.path.abspath(path))
        if not os.path.isabs(root):
            root = os.path.join(os.path.dirname(os.path.abspath(path)), root)
        rel = spec.get(split)
        if rel is None:
            raise KeyError(f"data.yaml has no '{split}' split")
        images_dir = rel if os.path.isabs(rel) else os.path.join(root, rel)
        if "num_keypoints" not in kw and spec.get("kpt_shape"):
            kw["num_keypoints"] = int(spec["kpt_shape"][0])
        return cls(images_dir, **kw)

    def __len__(self) -> int:
        return len(self.files)

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """One sample: (image (S,S,3) f32 [0,1] RGB letterboxed,
        boxes (P,4) xyxy canvas px, valid (P,), kpts (P,K,2) canvas px)."""
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError("YOLODetectionDataset reads images with cv2 (OpenCV), "
                               "which is not installed") from e
        name = self.files[idx]
        img = cv2.imread(os.path.join(self.images_dir, name))
        if img is None:
            raise IOError(f"unreadable image {name}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        h, w = img.shape[:2]
        S = self.img_size
        scale, pad_x, pad_y, new_w, new_h = letterbox_params(h, w, S)
        # PAD_VALUE gray, matching every inference letterbox (ops/letterbox,
        # host_letterbox, serve, quantize calib) — a black canvas here would be
        # a silent train/serve padding-distribution mismatch
        canvas = np.full((S, S, 3), PAD_VALUE, np.uint8)
        canvas[pad_y:pad_y + new_h, pad_x:pad_x + new_w] = cv2.resize(
            img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)

        stem = os.path.splitext(name)[0]
        nb, nk = parse_yolo_label(os.path.join(self.labels_dir, stem + ".txt"),
                                  self.classes, self.num_keypoints)
        P, K = self.max_persons, self.num_keypoints
        boxes = np.zeros((P, 4), np.float32)
        valid = np.zeros((P,), bool)
        kpts = np.zeros((P, K, 2), np.float32)
        for i in range(min(len(nb), P)):
            cx, cy, bw, bh = nb[i]
            x1 = (cx - bw / 2) * w * scale + pad_x
            y1 = (cy - bh / 2) * h * scale + pad_y
            x2 = (cx + bw / 2) * w * scale + pad_x
            y2 = (cy + bh / 2) * h * scale + pad_y
            boxes[i] = [x1, y1, x2, y2]
            valid[i] = True
            if K and i < len(nk):
                k = nk[i].copy()
                k[:, 0] = k[:, 0] * w * scale + pad_x
                k[:, 1] = k[:, 1] * h * scale + pad_y
                # invisible kpts (NaN) -> box center (masked semantics: the
                # keypoint loss has no visibility channel, so the least-harm
                # target is the box center)
                bad = ~np.isfinite(k).all(-1)
                k[bad] = [(x1 + x2) / 2, (y1 + y2) / 2]
                kpts[i] = k
        return canvas.astype(np.float32) / 255.0, boxes, valid, kpts

    def batches(
        self,
        batch_size: int,
        rng: Optional[np.random.Generator] = None,
        shuffle: bool = True,
        drop_last: bool = False,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """One epoch of static-shape batches (last batch zero-padded with
        valid=False rows unless drop_last)."""
        order = np.arange(len(self.files))
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        S, P, K = self.img_size, self.max_persons, self.num_keypoints
        for s in range(0, len(order), batch_size):
            idxs = order[s:s + batch_size]
            if len(idxs) < batch_size and drop_last:
                break
            imgs = np.zeros((batch_size, S, S, 3), np.float32)
            boxes = np.zeros((batch_size, P, 4), np.float32)
            valid = np.zeros((batch_size, P), bool)
            kpts = np.zeros((batch_size, P, K, 2), np.float32)
            for j, i in enumerate(idxs):
                imgs[j], boxes[j], valid[j], kpts[j] = self.load(int(i))
            yield imgs, boxes, valid, kpts
