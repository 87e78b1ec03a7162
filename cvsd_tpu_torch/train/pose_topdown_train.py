"""Trainer for the top-down pose net (PyTorch port of
``cvsd_tpu/train/pose_topdown_train.py``).

Crops are taken inside the step by the same ``crop_and_resize`` the
inference path uses, so training and inference resample alike. Boxes are the
(jittered) detector boxes; targets are GT keypoints in frame pixels, mapped
into crop space in the loss. optax's ``clip_by_global_norm(10)`` then Adam,
with the warmup-cosine schedule when ``total_steps`` is set, as the detector
trainer (``train/detector_train.py``). One device; the default is the CUDA
card, raising without one. The loader of the trainer's files is
``models/pose_topdown.py::load_pose_topdown_checkpoint``, re-exported here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from cvsd_tpu_torch.models.pose_topdown import (  # noqa: F401
    TopDownPoseNet,
    crop_and_resize,
    load_pose_topdown_checkpoint,
    soft_argmax,
)
from cvsd_tpu_torch.train.detector_train import clipped_adam, place_for_training
from cvsd_tpu_torch.utils.checkpoint import save_checkpoint
from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device, use_float32_math
from cvsd_tpu_torch.utils.weights import state_dict_to_flax


def pose_loss(model: TopDownPoseNet, images: torch.Tensor, boxes: torch.Tensor,
              kpts: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3), boxes (B, 4) xyxy px, kpts (B, K, 2) px: the
    soft-argmax L2 in crop-normalized space over the keypoints inside their
    crop. The model's mode decides whether its BatchNorm statistics move."""
    S = model.crop_size
    crops, origin, scale = crop_and_resize(images, boxes[:, None], S)
    crops, origin, scale = crops[:, 0], origin[:, 0], scale[:, 0]
    coords, _conf = soft_argmax(model(crops), model.temperature)  # (B, K, 2) in [0, 1]
    target = (kpts - origin[:, None, :]) / (S * scale[:, None, :])
    inside = ((target > 0.0) & (target < 1.0)).all(-1)  # (B, K)
    err = ((coords - target) ** 2).sum(-1)
    return torch.where(inside, err, 0.0).sum() / inside.sum().to(torch.float32).clamp(min=1.0)


class TopDownPoseTrainer:
    """Adam trainer for ``TopDownPoseNet``: weights from flax ``variables`` or
    a seeded generator, float32, on ``device`` (default: the CUDA card,
    raising without one)."""

    def __init__(self, model: TopDownPoseNet, lr: float = 1e-3, seed: int = 0,
                 total_steps: int = 0, warmup_steps: int = 100,
                 variables: Optional[Mapping[str, Any]] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        use_float32_math()  # the pose net trains in float32
        torch.backends.cudnn.deterministic = True  # a run repeats bit for bit
        self.model = place_for_training(model, variables, seed, self.device)
        self.opt = clipped_adam(list(self.model.parameters()), lr, total_steps, warmup_steps)

    @property
    def variables(self) -> Dict[str, Any]:
        """The weights as flax variables (numpy, on the host)."""
        return state_dict_to_flax(self.model)

    def _put(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array, np.float32)).to(self.device,
                                                                            non_blocking=True)

    def _step(self, images: torch.Tensor, boxes: torch.Tensor, kpts: torch.Tensor) -> torch.Tensor:
        loss = pose_loss(self.model, images, boxes, kpts)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def train_step(self, images: np.ndarray, boxes: np.ndarray, kpts: np.ndarray) -> float:
        return float(self._step(self._put(images), self._put(boxes), self._put(kpts)))

    def train_steps_scan(self, images: np.ndarray, boxes: np.ndarray,
                         kpts: np.ndarray) -> Dict[str, np.ndarray]:
        """Leading axis = steps: images (N, B, H, W, 3), boxes (N, B, 4), kpts
        (N, B, K, 2), copied to the device once; returns the per-step losses."""
        imgs, bxs, kps = self._put(images), self._put(boxes), self._put(kpts)
        losses = [self._step(imgs[i], bxs[i], kps[i]) for i in range(len(imgs))]
        return {"losses": torch.stack(losses).cpu().numpy()}

    def save(self, path: str, config: Optional[Dict[str, Any]] = None, **metadata: Any) -> None:
        """The JAX package's file: ``load_pose_topdown_checkpoint`` of either
        package reads it."""
        m = self.model
        save_checkpoint(path, self.variables,
                        config={**(config or {}), "pose_topdown": {
                            "num_keypoints": m.num_keypoints, "width": m.width,
                            "crop_size": m.crop_size, "temperature": m.temperature,
                        }}, **metadata)
