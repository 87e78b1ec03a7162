"""Quantization-aware fine-tuning of the int8 detector (PyTorch port of
``cvsd_tpu/train/qat.py``).

When PTQ alone costs accuracy, a short fake-quant fine-tune recovers it: the
fake-quant forward (``models/detector_int8.py``, ``qat=True``) sees the
serving arithmetic (per-channel int8 weights, frozen calibrated activation
ranges) while gradients flow through straight-through estimators into the
BN-folded float32 kernels. ``finalize_qat`` then rounds to the serving int8
layout.

    qat_model, qat_vars = prepare_qat(model, variables, calib_batches)
    tuner = QATFineTuner(qat_model, qat_vars, lr=1e-4)
    for ...: tuner.train_step(images, gt_boxes, gt_valid[, gt_kpts])
    serving_vars = finalize_qat(tuner.variables)   # -> QuantPersonDetector

The reference's optimizer is ``optax.multi_transform`` of
``chain(clip_by_global_norm(10), adam(lr))`` over every leaf but the
``act_scale``s and ``set_to_zero`` over those. Here the ``act_scale``s are
buffers, outside the optimizer: the clip's global norm is taken over the
trained leaves only and Adam keeps no state for the frozen ones, as there.
The loss, the assignment, the step loop and ``train_steps_scan`` (one
host-to-device copy a chunk) are ``DetectorTrainer``'s; there is no EMA.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from cvsd_tpu_torch.models.detector_int8 import QuantPersonDetector
from cvsd_tpu_torch.train.detector_train import DetectorTrainer, anchor_centers, clipped_adam
from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device, use_float32_math
from cvsd_tpu_torch.utils.weights import load_flax_variables


class QATFineTuner(DetectorTrainer):
    """Fine-tuning of the fake-quant detector mirror on one device
    (default: the CUDA card, raising without one). The model's weights come
    from ``qat_variables`` (``prepare_qat``'s); ``variables`` gives them back
    as flax variables."""

    def __init__(self, qat_model: QuantPersonDetector, qat_variables: Mapping[str, Any],
                 lr: float = 1e-4, obj_pos_weight: float = 3.0, kpt_weight: float = 0.05,
                 total_steps: int = 0, warmup_steps: int = 0, mesh_config: Any = None,
                 device: DeviceLike = None):
        if mesh_config is not None:
            raise NotImplementedError(
                "mesh_config: the port fine-tunes on one device; a mesh waits for ROADMAP.md "
                "section 1, item Parallel")
        if not getattr(qat_model, "qat", False):
            raise ValueError("model must be built with qat=True (qat_model_like)")
        self.device = resolve_device(device)
        use_float32_math()  # the fake-quant convolutions run in float32, not TF32
        torch.backends.cudnn.deterministic = True
        self.obj_pos_weight = float(obj_pos_weight)
        self.kpt_weight = float(kpt_weight)
        self.ema_decay = 0.0
        self.ema_params = None
        self._ema_t = 0
        self.model = load_flax_variables(qat_model, qat_variables).to(self.device).train()
        centers, strides = anchor_centers(qat_model.img_size)
        self._centers = torch.from_numpy(centers).to(self.device)
        self._strides = torch.from_numpy(strides).to(self.device)
        self.opt = clipped_adam(list(self.model.parameters()), lr, total_steps, warmup_steps)

    def _require_kpts(self, gt_kpts: Optional[np.ndarray]) -> None:
        if self.model.num_keypoints and gt_kpts is None:
            # zero targets would fine-tune every keypoint toward the canvas origin
            raise ValueError(
                "QAT on a pose-head model requires gt_kpts; got None for a model with "
                f"num_keypoints={self.model.num_keypoints}")

    def train_step(self, images: np.ndarray, gt_boxes: np.ndarray, gt_valid: np.ndarray,
                   gt_kpts: Optional[np.ndarray] = None) -> Dict[str, float]:
        self._require_kpts(gt_kpts)
        return super().train_step(images, gt_boxes, gt_valid, gt_kpts)

    def train_steps_scan(self, images: np.ndarray, gt_boxes: np.ndarray, gt_valid: np.ndarray,
                         gt_kpts: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        self._require_kpts(gt_kpts)
        return super().train_steps_scan(images, gt_boxes, gt_valid, gt_kpts)

    def save(self, *args, **kwargs) -> None:
        raise NotImplementedError("finalize_qat(tuner.variables) gives the serving variables; "
                                  "cli.quantize_detector writes them")
