"""Serialized serving artifacts through ``torch.export`` (the port's
counterpart of ``cvsd_tpu/serve/export.py``).

An artifact is one ``ExportedProgram`` saved as a ``.pt2`` file: the whole
serving program (backbone -> decode -> NMS, or the Shopformer's scoring
forward) with the weights baked in, loadable without the model classes or
the config. The batch dimension is a ``torch.export.Dim``, so one artifact
serves every batch size from 1 to ``MAX_BATCH``; the spatial sizes are
fixed. The batch is capped because ``torch.export`` refuses an unbounded
one on CUDA: the launch limits of the card's kernels add guards on it (the
scorer's, for one, guards b <= 65535).

Where the JAX package exports StableHLO with its pure-XLA NMS (portable
across PJRT backends), the port's artifact keeps the hand-written kernel:
the detect program calls ``torch.ops.cvsd_tpu_torch.nms_fixpoint``, the
operator of ``ops/nms.py``, which runs ``csrc/nms_fixpoint.cu`` on a CUDA
tensor and the plain version on a CPU tensor. So an artifact is bound
to the device type it was exported on (its weights live there), and a
program that loads it imports ``ops/nms.py`` first (``load_exported`` does).

torch specialises a dimension whose example size is 0 or 1, so the example
batch is 2; the program then runs at batch 1 and at every other size up to
``MAX_BATCH``.
"""

from __future__ import annotations

import weakref
from typing import Any

import numpy as np
import torch
from torch import nn

MAX_BATCH = 4096

# one runnable module per loaded program: ``ExportedProgram.module()`` builds
# a fresh GraphModule at every call; weak keys, so the cache keeps no
# artifact alive
_MODULES: "weakref.WeakKeyDictionary[torch.export.ExportedProgram, nn.Module]" = (
    weakref.WeakKeyDictionary())


class _Serving(nn.Module):
    """One traced function of the model: ``fn(model, x)``."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, x: torch.Tensor):
        return self.fn(self.model, x)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _export(module: nn.Module, example: torch.Tensor) -> torch.export.ExportedProgram:
    batch = torch.export.Dim("b", min=1, max=MAX_BATCH)
    with torch.no_grad():
        return torch.export.export(module, (example,), dynamic_shapes={"x": {0: batch}})


def export_detector(
    model,
    conf_thresh: float = 0.25,
    iou_thresh: float = 0.45,
    max_detections: int = 128,
    tta_flip: bool = False,
) -> torch.export.ExportedProgram:
    """Export the detect program of ``model`` (a ``PersonDetector`` in eval
    mode on the device the artifact is for) with its weights baked in.

    Signature: images (b, S, S, 3) float32 in [0, 1] -> (boxes (b, M, 4) xyxy
    canvas px, scores (b, M), valid (b, M)[, keypoints (b, M, K, 3)]), the
    outputs of ``models/detector.py::make_detect_fn``; ``b`` is 1 to
    ``MAX_BATCH``. The NMS is the ``nms_fixpoint`` kernel's operator."""
    from cvsd_tpu_torch.models.detector import make_detect_fn

    detect = make_detect_fn(model, conf_thresh=conf_thresh, iou_thresh=iou_thresh,
                            max_detections=max_detections, nms_method="pallas_fixpoint",
                            tta_flip=tta_flip)
    S = int(model.img_size)
    example = torch.zeros((2, S, S, 3), dtype=torch.float32, device=_device_of(model))
    return _export(_Serving(model.eval(), lambda _m, images: detect(images)), example)


def export_scorer(scorer) -> torch.export.ExportedProgram:
    """Export the Shopformer anomaly-scoring forward of a
    ``ShopformerScorer`` with its weights baked in.

    Signature: poses (b, T, V, C) float32 (normalized windows, the data
    layer's output) -> scores (b,)."""
    m = scorer.config["model"]
    T = int(m.get("seq_len", 12))
    V = int(m.get("num_keypoints", 18))
    C = int(m.get("in_channels", 2))
    example = torch.zeros((2, T, V, C), dtype=torch.float32, device=scorer.device)
    score = lambda model, poses: model.compute_anomaly_score(poses)  # noqa: E731
    return _export(_Serving(scorer.model.eval(), score), example)


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    torch.export.save(exported, path)


def load_exported(path: str) -> torch.export.ExportedProgram:
    """Load a ``.pt2`` artifact; the NMS operators are registered first, and
    float32 runs as float32 (TF32 off, as at every float32 entry point)."""
    import cvsd_tpu_torch.ops.nms  # noqa: F401  (registers torch.ops.cvsd_tpu_torch.*)
    from cvsd_tpu_torch.utils.device import use_float32_math

    use_float32_math()
    return torch.export.load(path)


def exported_device(exported: torch.export.ExportedProgram) -> torch.device:
    """The device the artifact's weights live on (the one it runs on)."""
    for t in list(exported.state_dict.values()) + list(exported.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def _module(exported: torch.export.ExportedProgram) -> nn.Module:
    """The program's runnable module, built once per program."""
    mod = _MODULES.get(exported)
    if mod is None:
        mod = _MODULES[exported] = exported.module()
    return mod


def call_exported(exported: torch.export.ExportedProgram, *args: Any) -> Any:
    """Run an artifact: numpy arrays or tensors go to its device as float32;
    the outputs are tensors on that device. A batch larger than
    ``MAX_BATCH`` runs in chunks of at most ``MAX_BATCH``, each output
    concatenated along its batch dimension."""
    dev = exported_device(exported)
    inputs = [torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
              .to(device=dev, dtype=torch.float32) for a in args]
    mod = _module(exported)
    b = inputs[0].shape[0]
    with torch.no_grad():
        if b <= MAX_BATCH:
            return mod(*inputs)
        parts = [mod(*[x[i: i + MAX_BATCH] for x in inputs]) for i in range(0, b, MAX_BATCH)]
    if isinstance(parts[0], torch.Tensor):  # the scorer's scores
        return torch.cat(parts)
    return type(parts[0])(torch.cat(leaves) for leaves in zip(*parts))  # the detector's tuple
