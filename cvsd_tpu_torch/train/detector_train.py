"""Person-detector training: anchor-free target assignment, the losses, the
trainer (PyTorch port of ``cvsd_tpu/train/detector_train.py``).

Assignment (static shapes, vectorized): the anchors are every head cell of
strides 8/16/32, centers in letterbox pixels; an anchor is positive where
its center lies inside a GT box AND within ``center_radius * stride`` of
the GT center (center sampling); ties go to the smallest-area GT, by an
``argmin`` over costs that are ``inf`` off the candidates (a row with no
candidate gets GT 0, padding included, as ``jnp.argmin`` gives; it is not
positive, so only its target is that box).

Losses: optax's ``sigmoid_binary_cross_entropy`` formula,
-z log sigmoid(x) - (1 - z) log sigmoid(-x), for the objectness over all
anchors (positives up-weighted by ``obj_pos_weight``); (1 - IoU) on the
positives through ``ops/iou.py::box_iou_matrix`` (union clamped at 1e-9);
with the pose head, the box-width-normalized keypoint L2 gathered with the
same ``gt_idx``. GT arrives padded: (B, G, 4) boxes and a (B, G) mask.

``DetectorTrainer``: float32 master weights computing in the model's dtype
(``models/detector.py``'s docstring), optax's ``clip_by_global_norm(10)``
then Adam (``train/optim.py::StageOptimizer``), the warmup-cosine schedule
to 1 % when ``total_steps`` is set (optax counts from 0, so the first
update's rate is 0), and the ramped EMA of the parameters. One device (the
default is the CUDA card, raising without one) or, with ``mesh_config``,
data-parallel as the reference over its mesh: rank 0's weights on every
rank, each rank's rows of every batch (dim 1 of ``train_steps_scan``'s
chunks), the BatchNorm statistics and the loss over the global batch, the
gradients summed before the clip and Adam; only rank 0 saves.
``train_steps_scan`` is the reference's one-dispatch ``lax.scan``: one
host-to-device copy of the chunk and the same per-step updates in a Python
loop.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cvsd_tpu_torch.models.detector import (STRIDES, PersonDetector, decode_predictions,
                                            decode_predictions_v8)
from cvsd_tpu_torch.models.layers import set_data_group
from cvsd_tpu_torch.ops.iou import box_iou_matrix
from cvsd_tpu_torch.parallel.mesh import replicate, writes
from cvsd_tpu_torch.train.optim import Schedule, StageOptimizer, _warmup_cosine_decay
from cvsd_tpu_torch.utils.checkpoint import save_checkpoint
from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device, use_float32_math
from cvsd_tpu_torch.utils.weights import init_module, load_flax_variables, state_dict_to_flax


def anchor_centers(img_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """((A, 2) anchor centers in pixels, (A,) strides) across all levels."""
    centers, strides = [], []
    for s in STRIDES:
        n = img_size // s
        gy, gx = np.mgrid[0:n, 0:n]
        cx = (gx.reshape(-1) + 0.5) * s
        cy = (gy.reshape(-1) + 0.5) * s
        centers.append(np.stack([cx, cy], -1))
        strides.append(np.full(n * n, s))
    return np.concatenate(centers).astype(np.float32), np.concatenate(strides).astype(np.float32)


def assign_targets(
    gt_boxes: torch.Tensor,  # (B, G, 4) xyxy letterbox px
    gt_valid: torch.Tensor,  # (B, G) bool
    centers: torch.Tensor,   # (A, 2)
    strides: torch.Tensor,   # (A,)
    center_radius: float = 2.5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pos (B, A) bool, target_boxes (B, A, 4), gt_idx (B, A)): gt_idx is
    the matched GT per anchor, and every per-anchor target (boxes and
    keypoints) is gathered with it, so a positive anchor never regresses
    towards another person's keypoints than its box target's."""
    cx = centers[None, :, None, 0]  # (1, A, 1)
    cy = centers[None, :, None, 1]
    x1, y1, x2, y2 = (gt_boxes[:, None, :, i] for i in range(4))  # (B, 1, G)
    inside = (cx >= x1) & (cx <= x2) & (cy >= y1) & (cy <= y2)
    gcx, gcy = (x1 + x2) / 2, (y1 + y2) / 2
    r = center_radius * strides[None, :, None]
    centered = ((cx - gcx).abs() <= r) & ((cy - gcy).abs() <= r)
    match = inside & centered & gt_valid[:, None, :]  # (B, A, G)

    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)  # (B, 1, G)
    cost = torch.where(match, area, torch.inf)
    gt_idx = torch.argmin(cost, dim=-1)  # the first minimum: 0 on an all-inf row
    pos = match.any(dim=-1)
    target = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    return pos, target, gt_idx


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's elementwise form, -z log sigmoid(x) - (1 - z) log sigmoid(-x)."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def detection_loss(
    raw: Dict[str, torch.Tensor],
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    img_size: int,
    centers: torch.Tensor,
    strides: torch.Tensor,
    box_weight: float = 5.0,
    gt_kpts: Optional[torch.Tensor] = None,  # (B, G, K, 2) px, optional pose head
    num_keypoints: int = 0,
    kpt_weight: float = 0.05,
    obj_pos_weight: float = 1.0,
    head_variant: str = "anchor_free",
    num_classes: int = 80,
    reg_max: int = 16,
    data_group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and its components from the raw head maps: objectness BCE,
    the IoU box loss and, with the pose head, the keypoint regression. For
    ``v8dfl`` the person-class logit plays objectness and the box loss flows
    through the DFL softmax-expectation decode. Computed in float32.

    With ``data_group`` (this rank's rows of a meshed batch) the loss and
    its components are this rank's shares of the global batch's: the
    objectness mean over the ranks, the box and keypoint sums over the
    global positive count (``n_pos``, returned global), since the ranks'
    positive counts differ."""
    if head_variant == "v8dfl":
        pred_boxes, _scores, pred_kpts = decode_predictions_v8(
            raw, num_classes, reg_max, num_keypoints)
        obj_ch = 4 * reg_max  # the person class logit (class_idx 0)
    else:
        pred_boxes, _scores, pred_kpts = decode_predictions(raw, img_size, num_keypoints)
        obj_ch = 4
    obj_logits = torch.cat(
        [raw[k].to(torch.float32)[..., obj_ch].reshape(raw[k].shape[0], -1)
         for k in ("p3", "p4", "p5")], dim=1)  # (B, A)
    pos, target, gt_idx = assign_targets(gt_boxes, gt_valid, centers, strides)

    obj_bce = sigmoid_binary_cross_entropy(obj_logits, pos.to(torch.float32))
    if obj_pos_weight != 1.0:
        obj_bce = torch.where(pos, obj_pos_weight * obj_bce, obj_bce)
    obj_loss = obj_bce.mean()
    n_pos = pos.sum().to(torch.float32)
    if data_group is not None:
        obj_loss = obj_loss / data_group.size
        n_pos = data_group.sum_(n_pos)
    n_pos = n_pos.clamp(min=1.0)

    # IoU of each anchor's box with its own target (the diagonal)
    iou = box_iou_matrix(pred_boxes[..., None, :], target[..., None, :])[..., 0, 0]
    box_loss = torch.where(pos, 1.0 - iou, 0.0).sum() / n_pos

    total = obj_loss + box_weight * box_loss
    aux = {"obj_loss": obj_loss, "box_loss": box_loss, "n_pos": n_pos}
    if gt_kpts is not None and pred_kpts is not None:
        idx = gt_idx[:, :, None, None].expand(-1, -1, *gt_kpts.shape[2:])
        tk = torch.gather(gt_kpts, 1, idx)  # (B, A, K, 2)
        scale = (target[..., 2] - target[..., 0]).clamp(min=1.0)[..., None, None]
        err = (((pred_kpts[..., :2] - tk) / scale) ** 2).sum(dim=(-1, -2))
        kpt_loss = torch.where(pos, err, 0.0).sum() / n_pos
        total = total + kpt_weight * kpt_loss
        aux["kpt_loss"] = kpt_loss
    return total, aux


def clipped_adam(params: List[torch.nn.Parameter], lr: float, total_steps: int,
                 warmup_steps: int) -> StageOptimizer:
    """optax.chain(clip_by_global_norm(10), adam(lr)); with ``total_steps``
    the rate follows warmup_cosine_decay_schedule(0, lr, max(1, min(warmup,
    total // 5)), total, end_value=lr / 100)."""
    schedule: Schedule = lr
    if total_steps:
        # warmup + cosine decay to 1%: flat Adam never converges the keypoint
        # regression tightly; the tail rate is what cuts the keypoint RMS
        warmup = max(1, min(int(warmup_steps), int(total_steps) // 5))
        schedule = _warmup_cosine_decay(0.0, lr, warmup, int(total_steps), end_value=lr * 0.01)
    return StageOptimizer(params, params, "adam", schedule, max_norm=10.0)


def place_for_training(model: torch.nn.Module, variables: Optional[Mapping[str, Any]],
                       seed: int, device: torch.device) -> torch.nn.Module:
    """``model`` filled from flax ``variables`` (or seeded with flax's default
    initializers), with float32 parameters and statistics on ``device``, in
    train mode."""
    if variables is not None:
        load_flax_variables(model, variables)
    else:
        init_module(model, seed, truncated=True)
    model = model.to(device=device, dtype=torch.float32)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model.train()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class DetectorTrainer:
    """Trainer for the person detector on one device, or data-parallel over
    ``mesh_config`` (the module docstring).

    ``model`` is a ``PersonDetector`` (its ``dtype`` is the compute dtype);
    its weights come from flax ``variables`` (``utils/weights.py``) or from
    a seeded ``torch.Generator``, and are kept in float32. ``device``: the
    default is the CUDA card, raising without one."""

    def __init__(self, model: PersonDetector, lr: float = 1e-3, seed: int = 0,
                 obj_pos_weight: float = 3.0, kpt_weight: float = 0.05,
                 mesh_config: Any = None, total_steps: int = 0, warmup_steps: int = 0,
                 ema_decay: float = 0.0, variables: Optional[Mapping[str, Any]] = None,
                 device: DeviceLike = None):
        self._init_mesh(mesh_config, device)
        use_float32_math()  # float32 parts run in float32, not TF32
        # cuDNN's backward kernels that add with atomics are not chosen, so a
        # run repeats bit for bit on one device (process-wide, as TF32's flags)
        torch.backends.cudnn.deterministic = True
        self.obj_pos_weight = float(obj_pos_weight)
        self.kpt_weight = float(kpt_weight)
        self.ema_decay = float(ema_decay)
        self.model = self._replicated(place_for_training(model, variables, seed, self.device))
        centers, strides = anchor_centers(model.img_size)
        self._centers = torch.from_numpy(centers).to(self.device)
        self._strides = torch.from_numpy(strides).to(self.device)
        params = list(self.model.parameters())
        self.opt = clipped_adam(params, lr, total_steps, warmup_steps)
        # EMA of the parameters (YOLO's): ramped decay min(d, (1+t)/(10+t))
        self.ema_params = ([p.detach().clone() for p in params] if self.ema_decay > 0
                           else None)
        self._ema_t = 0

    def _init_mesh(self, mesh_config: Any, device: DeviceLike) -> None:
        self.mesh_config = mesh_config
        self._dp = mesh_config.data_group() if mesh_config is not None else None
        self._writer = writes(mesh_config)
        self.device = resolve_device(device if device is not None or mesh_config is None
                                     else mesh_config.device)

    def _replicated(self, model: torch.nn.Module) -> torch.nn.Module:
        """``model`` with rank 0's weights and the global batch's BatchNorm
        statistics under a mesh; as it is without."""
        if self.mesh_config is None:
            return model
        return set_data_group(replicate(self.mesh_config.mesh, model), self._dp)

    # -- weights --------------------------------------------------------------

    @property
    def variables(self) -> Dict[str, Any]:
        """The raw weights as flax variables (numpy, on the host)."""
        return state_dict_to_flax(self.model)

    @torch.no_grad()
    def eval_model(self, use_ema: bool = True) -> PersonDetector:
        """A copy of the detector in eval mode with the EMA parameters (the raw
        ones with ``use_ema`` off or EMA off) and the raw BatchNorm statistics."""
        model = copy.deepcopy(self.model).eval()
        if use_ema and self.ema_params is not None:
            for p, e in zip(model.parameters(), self.ema_params):
                p.copy_(e)
        return model

    @property
    def ema_variables(self) -> Dict[str, Any]:
        """flax variables with the EMA parameters (the raw ones when EMA is off)."""
        return state_dict_to_flax(self.eval_model(use_ema=True))

    @torch.no_grad()
    def _ema_update(self) -> None:
        t = np.float32(self._ema_t)  # the decay in float32, as the reference's
        d = float(min(np.float32(self.ema_decay), (np.float32(1.0) + t) / (np.float32(10.0) + t)))
        params = [p.detach() for p in self.model.parameters()]
        torch._foreach_mul_(self.ema_params, d)
        torch._foreach_add_(self.ema_params, torch._foreach_mul(params, 1.0 - d))
        self._ema_t += 1

    # -- steps ----------------------------------------------------------------

    def _put(self, array: Optional[np.ndarray], dtype=np.float32,
             batch_dim: int = 0) -> Optional[torch.Tensor]:
        """A global host batch on the device; under a mesh, this rank's rows
        of it (the batch on ``batch_dim``)."""
        if array is None:
            return None
        if self._dp is not None:
            index = [slice(None)] * batch_dim + [self._dp.rows(array.shape[batch_dim])]
            array = array[tuple(index)]
        return torch.from_numpy(np.ascontiguousarray(array, dtype)).to(self.device,
                                                                       non_blocking=True)

    def _step(self, images: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
              gt_kpts: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One update on a batch already on the device; no host sync."""
        m = self.model
        raw = m(images)
        loss, aux = detection_loss(
            raw, gt_boxes, gt_valid, m.img_size, self._centers, self._strides,
            gt_kpts=gt_kpts if m.num_keypoints else None, num_keypoints=m.num_keypoints,
            obj_pos_weight=self.obj_pos_weight, kpt_weight=self.kpt_weight,
            head_variant=m.head_variant, num_classes=m.num_classes, reg_max=m.reg_max,
            data_group=self._dp)
        loss.backward()
        loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
        if self._dp is not None:  # the sum of the shares' gradients: the global batch's
            self._dp.reduce_gradients(self.model.parameters())
            loss = self._dp.sum_(loss)
            aux = {k: v if k == "n_pos" else self._dp.sum_(v) for k, v in aux.items()}
        self.opt.step()
        if self.ema_params is not None:
            self._ema_update()
        return loss, aux

    def train_step(self, images: np.ndarray, gt_boxes: np.ndarray, gt_valid: np.ndarray,
                   gt_kpts: Optional[np.ndarray] = None) -> Dict[str, float]:
        if self.model.num_keypoints and gt_kpts is None:
            gt_kpts = np.zeros((*gt_boxes.shape[:2], self.model.num_keypoints, 2), np.float32)
        loss, aux = self._step(self._put(images), self._put(gt_boxes),
                               self._put(gt_valid, bool), self._put(gt_kpts))
        return {"loss": float(loss), **{k: float(v) for k, v in aux.items()}}

    def train_steps_scan(self, images: np.ndarray, gt_boxes: np.ndarray, gt_valid: np.ndarray,
                         gt_kpts: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """N pre-batched steps (inputs with a leading steps axis: images
        (N, B, S, S, 3), gt_boxes (N, B, G, 4), ...) after one host-to-device
        copy; returns the per-step losses."""
        if gt_kpts is None:
            gt_kpts = np.zeros((*gt_boxes.shape[:3], max(self.model.num_keypoints, 1), 2),
                               np.float32)
        imgs, boxes = self._put(images, batch_dim=1), self._put(gt_boxes, batch_dim=1)
        valid, kpts = self._put(gt_valid, bool, batch_dim=1), self._put(gt_kpts, batch_dim=1)
        losses = [self._step(imgs[i], boxes[i], valid[i], kpts[i])[0] for i in range(len(imgs))]
        return {"losses": torch.stack(losses).cpu().numpy()}

    def save(self, path: str, config: Optional[Dict[str, Any]] = None, use_ema: bool = True,
             **metadata: Any) -> None:
        """The detector's variables (the EMA weights by default when EMA is on)
        with the architecture config embedded: the JAX package's file, which
        either package's ``load_detector_checkpoint`` and the stream /
        preprocess CLIs' ``--detector_checkpoint`` read. Under a mesh only
        rank 0 writes."""
        if not self._writer:
            return
        m = self.model
        det_cfg = {
            "img_size": m.img_size, "width_mult": m.width_mult,
            "depth_mult": m.depth_mult, "pose_head": bool(m.num_keypoints),
            "num_keypoints": m.num_keypoints,
            "head_variant": m.head_variant, "num_classes": m.num_classes,
            "reg_max": m.reg_max, "dtype": _dtype_name(m.dtype),
        }
        variables = self.ema_variables if use_ema else self.variables
        save_checkpoint(path, variables, config={**(config or {}), "detector": det_cfg},
                        **metadata)


def synthetic_detection_batch(
    rng: np.random.Generator, batch: int, img_size: int, max_gt: int = 4,
    num_keypoints: int = 0,
) -> Tuple[np.ndarray, ...]:
    """Bright rectangles on dark noise and their boxes, the detector-training
    fixture. With num_keypoints > 0 also (B, max_gt, K, 2) keypoints laid out
    on a fixed grid inside each box (the pose-head fixture)."""
    images = rng.uniform(0, 0.25, (batch, img_size, img_size, 3)).astype(np.float32)
    boxes = np.zeros((batch, max_gt, 4), np.float32)
    valid = np.zeros((batch, max_gt), bool)
    kpts = np.zeros((batch, max_gt, num_keypoints, 2), np.float32) if num_keypoints else None
    fracs = np.linspace(0.15, 0.85, max(num_keypoints, 1))
    for b in range(batch):
        for g in range(rng.integers(1, max_gt + 1)):
            w = rng.integers(img_size // 8, img_size // 3)
            h = rng.integers(img_size // 8, img_size // 3)
            x1 = rng.integers(0, img_size - w)
            y1 = rng.integers(0, img_size - h)
            images[b, y1 : y1 + h, x1 : x1 + w] = rng.uniform(0.7, 1.0, 3)
            boxes[b, g] = (x1, y1, x1 + w, y1 + h)
            valid[b, g] = True
            if num_keypoints:
                kpts[b, g, :, 0] = x1 + fracs * w
                kpts[b, g, :, 1] = y1 + fracs[::-1] * h
    if num_keypoints:
        return images, boxes, valid, kpts
    return images, boxes, valid
