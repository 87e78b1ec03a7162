"""Ultralytics yolov5*u checkpoint import -> ``PersonDetector(head_variant='v8dfl')``
(the port's copy of ``cvsd_tpu/utils/yolo_import.py``).

The reference detects with a pretrained ultralytics ``yolov5mu.pt``. The
detector shares the v5 backbone and PAN topology (6x6 stem, C3 blocks at
depths [2, 4, 6, 2] at v5m, SPPF, the v5 neck) and, with
``head_variant='v8dfl'``, the u-series anchor-free DFL head, so the
checkpoint's tensors map onto it one to one:

    tree = import_yolov5u(load_torch_checkpoint("yolov5mu.pt"))
    model = load_flax_variables(PersonDetector(head_variant="v8dfl"), tree)

The importer fills the flax-layout numpy tree (``{'params', 'batch_stats'}``,
HWIO kernels) that the msgpack checkpoints of both packages hold
(``utils/checkpoint.py``); ``utils/weights.py`` carries it into the module,
strictly. The mapping is structural (Conv2d OIHW -> HWIO, BatchNorm weight /
bias / running statistics -> scale / bias / batch_stats); no ultralytics
code is used. ``synthesize_state_dict`` builds a state dict with the keys
and shapes of a real yolov5<x>u checkpoint from a seeded numpy generator:
for the same arguments its arrays are the JAX package's, bit for bit.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

FlaxPath = Tuple[str, ...]
_TORCH_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}


def _to_numpy(t: Any) -> np.ndarray:
    """Accept torch tensors or numpy arrays."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _conv_entries(tp: str, fp: FlaxPath) -> List[Tuple[str, str, FlaxPath, str]]:
    """Mapping rows for one ultralytics Conv (conv+bn+silu) block.
    Row = (torch_key, kind, flax_subpath, collection)."""
    return [
        (f"{tp}.conv.weight", "conv_kernel", fp + ("Conv_0", "kernel"), "params"),
        (f"{tp}.bn.weight", "copy", fp + ("BatchNorm_0", "scale"), "params"),
        (f"{tp}.bn.bias", "copy", fp + ("BatchNorm_0", "bias"), "params"),
        (f"{tp}.bn.running_mean", "copy", fp + ("BatchNorm_0", "mean"), "batch_stats"),
        (f"{tp}.bn.running_var", "copy", fp + ("BatchNorm_0", "var"), "batch_stats"),
    ]


def _c3_entries(tp: str, fp: FlaxPath, n: int) -> List[Tuple[str, str, FlaxPath, str]]:
    rows = []
    rows += _conv_entries(f"{tp}.cv1", fp + ("ConvBNAct_0",))
    rows += _conv_entries(f"{tp}.cv2", fp + ("ConvBNAct_1",))
    rows += _conv_entries(f"{tp}.cv3", fp + ("ConvBNAct_2",))
    for i in range(n):
        rows += _conv_entries(f"{tp}.m.{i}.cv1", fp + (f"Bottleneck_{i}", "ConvBNAct_0"))
        rows += _conv_entries(f"{tp}.m.{i}.cv2", fp + (f"Bottleneck_{i}", "ConvBNAct_1"))
    return rows


def build_key_map(depth_mult: float = 0.67) -> List[Tuple[str, str, FlaxPath, str]]:
    """Full torch-state-dict -> flax-tree mapping for a yolov5<x>u checkpoint.
    Layer indices follow the v5 yaml (backbone 0-9, neck 10-23, Detect 24);
    C3 depths are ``max(1, round(n * depth_mult))`` (v5m: 2, 4, 6, 2)."""
    d = lambda n: max(1, round(n * depth_mult))  # noqa: E731
    B: FlaxPath = ("Backbone_0",)
    N: FlaxPath = ("PANNeck_0",)
    rows: List[Tuple[str, str, FlaxPath, str]] = []
    rows += _conv_entries("model.0", B + ("ConvBNAct_0",))
    rows += _conv_entries("model.1", B + ("ConvBNAct_1",))
    rows += _c3_entries("model.2", B + ("C3_0",), d(3))
    rows += _conv_entries("model.3", B + ("ConvBNAct_2",))
    rows += _c3_entries("model.4", B + ("C3_1",), d(6))
    rows += _conv_entries("model.5", B + ("ConvBNAct_3",))
    rows += _c3_entries("model.6", B + ("C3_2",), d(9))
    rows += _conv_entries("model.7", B + ("ConvBNAct_4",))
    rows += _c3_entries("model.8", B + ("C3_3",), d(3))
    rows += _conv_entries("model.9.cv1", B + ("SPPF_0", "ConvBNAct_0"))
    rows += _conv_entries("model.9.cv2", B + ("SPPF_0", "ConvBNAct_1"))
    rows += _conv_entries("model.10", N + ("ConvBNAct_0",))
    rows += _c3_entries("model.13", N + ("C3_0",), d(3))
    rows += _conv_entries("model.14", N + ("ConvBNAct_1",))
    rows += _c3_entries("model.17", N + ("C3_1",), d(3))
    rows += _conv_entries("model.18", N + ("ConvBNAct_2",))
    rows += _c3_entries("model.20", N + ("C3_2",), d(3))
    rows += _conv_entries("model.21", N + ("ConvBNAct_3",))
    rows += _c3_entries("model.23", N + ("C3_3",), d(3))
    for lvl in range(3):
        H: FlaxPath = (f"V8DFLHead_{lvl}",)
        rows += _conv_entries(f"model.24.cv2.{lvl}.0", H + ("ConvBNAct_0",))
        rows += _conv_entries(f"model.24.cv2.{lvl}.1", H + ("ConvBNAct_1",))
        rows.append((f"model.24.cv2.{lvl}.2.weight", "conv_kernel", H + ("Conv_0", "kernel"), "params"))
        rows.append((f"model.24.cv2.{lvl}.2.bias", "copy", H + ("Conv_0", "bias"), "params"))
        rows += _conv_entries(f"model.24.cv3.{lvl}.0", H + ("ConvBNAct_2",))
        rows += _conv_entries(f"model.24.cv3.{lvl}.1", H + ("ConvBNAct_3",))
        rows.append((f"model.24.cv3.{lvl}.2.weight", "conv_kernel", H + ("Conv_1", "kernel"), "params"))
        rows.append((f"model.24.cv3.{lvl}.2.bias", "copy", H + ("Conv_1", "bias"), "params"))
    return rows


def _get(tree: Dict[str, Any], path: FlaxPath):
    node = tree
    for k in path:
        node = node[k]
    return node


def _set(tree: Dict[str, Any], path: FlaxPath, value):
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def _torch_key(fpath: FlaxPath) -> str:
    """The port module's state_dict key of a flax leaf path (utils/weights.py's map)."""
    return ".".join(fpath[:-1] + (_TORCH_LEAF[fpath[-1]],))


def initial_variables(model, seed: int = 0) -> Dict[str, Any]:
    """A flax-layout numpy tree of ``model``'s shapes, from the port's seeded
    initialisation (``utils/weights.py::init_module``) of a host copy of it."""
    from cvsd_tpu_torch.models.detector import PersonDetector
    from cvsd_tpu_torch.utils.weights import init_module, state_dict_to_flax

    host = PersonDetector(img_size=model.img_size, width_mult=model.width_mult,
                          depth_mult=model.depth_mult, num_keypoints=model.num_keypoints,
                          head_variant=model.head_variant, num_classes=model.num_classes,
                          reg_max=model.reg_max, channel_divisor=model.channel_divisor,
                          dtype=torch.float32)
    return state_dict_to_flax(init_module(host, seed))


def import_yolov5u(
    state_dict: Dict[str, Any],
    model: Optional[Any] = None,
    variables: Optional[Dict[str, Any]] = None,
    strict: bool = True,
) -> Dict[str, Any]:
    """Map an ultralytics yolov5*u torch state dict onto the variables of
    ``model``, a port ``PersonDetector(head_variant='v8dfl')`` (default: v5m
    at 640; only its architecture is read). Leaves the checkpoint does not
    cover (an enabled keypoint branch: ultralytics detection models have
    none) keep their values in ``variables`` (default: the port's seeded
    initialisation, ``initial_variables(model, 0)``).

    Returns ``{'params': ..., 'batch_stats': ...}`` of float32 numpy arrays in
    the flax layout, for ``utils/checkpoint.py`` or
    ``utils/weights.py::load_flax_variables``.
    """
    from cvsd_tpu_torch.models.detector import PersonDetector

    if model is None:
        model = PersonDetector(head_variant="v8dfl")
    if model.head_variant != "v8dfl":
        raise ValueError("yolov5u import requires head_variant='v8dfl'")
    if variables is None:
        variables = initial_variables(model, 0)
    # strip common prefixes: DetectionModel checkpoints may expose
    # 'model.model.N...' when nested, plain exports use 'model.N...'
    sd = {}
    for k, v in state_dict.items():
        if k.startswith("model.model."):
            k = k[len("model."):]
        sd[k] = v

    def copy(node):
        return ({k: copy(v) for k, v in node.items()} if isinstance(node, dict)
                else np.array(node, dtype=np.float32))

    tree = {"params": copy(variables["params"]), "batch_stats": copy(variables["batch_stats"])}

    dfl_w = sd.get("model.24.dfl.conv.weight")
    if dfl_w is not None:
        expected = np.arange(model.reg_max, dtype=np.float32)
        got = _to_numpy(dfl_w).reshape(-1)
        if not np.allclose(got, expected):
            raise ValueError("DFL conv weight is not arange(reg_max); unsupported head")

    missing = []
    for torch_key, kind, fpath, coll in build_key_map(model.depth_mult):
        if torch_key not in sd:
            missing.append(torch_key)
            continue
        w = _to_numpy(sd[torch_key])
        if kind == "conv_kernel":
            w = np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO
        target = _get(tree[coll], fpath)
        if tuple(target.shape) != tuple(w.shape):
            raise ValueError(
                f"shape mismatch for {torch_key} -> {'/'.join(fpath)}: "
                f"checkpoint {w.shape} vs model {tuple(target.shape)}"
            )
        _set(tree[coll], fpath, np.ascontiguousarray(w, dtype=np.float32))
    if strict and missing:
        raise KeyError(f"checkpoint is missing {len(missing)} keys, e.g. {missing[:5]}")
    return tree


def synthesize_state_dict(
    depth_mult: float = 0.67, width_mult: float = 0.75,
    num_classes: int = 80, reg_max: int = 16, seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Build a random state dict with exactly the keys/shapes of a real
    yolov5<x>u checkpoint (for tests and the card run; also documents the
    expected layout). The shapes are the port detector's (built on the meta
    device); the values come from ``np.random.default_rng(seed)`` in key-map
    order, so they equal the JAX package's for the same arguments."""
    from cvsd_tpu_torch.models.detector import PersonDetector

    with torch.device("meta"):
        model = PersonDetector(width_mult=width_mult, depth_mult=depth_mult,
                               head_variant="v8dfl", num_classes=num_classes,
                               reg_max=reg_max, img_size=64)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for torch_key, _kind, fpath, _coll in build_key_map(depth_mult):
        shape = shapes[_torch_key(fpath)]  # conv weights are OIHW here already
        if torch_key.endswith("running_var"):
            w = rng.uniform(0.5, 2.0, shape)
        elif torch_key.endswith("bn.weight"):
            w = rng.uniform(0.5, 1.5, shape)
        else:
            fan = max(1, int(np.prod(shape[1:])))
            w = rng.normal(0.0, 1.0 / math.sqrt(fan), shape)
        sd[torch_key] = w.astype(np.float32)
    sd["model.24.dfl.conv.weight"] = np.arange(reg_max, dtype=np.float32).reshape(1, reg_max, 1, 1)
    return sd


def torch_load(path: str, allow_unsafe_load: bool = False) -> Any:
    """``torch.load`` on the CPU with ``weights_only=True``; full unpickling,
    which executes code embedded in the file, only with ``allow_unsafe_load``
    and then with a ``RuntimeWarning``. Otherwise the safe failure is raised
    as a ``ValueError``."""
    try:
        # weights_only=True refuses to execute arbitrary pickle code: the
        # safe default for third-party downloads (plain state dicts load fine)
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not allow_unsafe_load:
            raise ValueError(
                f"{path}: not loadable with weights_only=True. Full unpickling "
                "executes code embedded in the file; pass allow_unsafe_load="
                "True (--unsafe) only for checkpoints you trust.")
        import warnings

        warnings.warn(
            f"{path}: not loadable with weights_only=True; falling back to full "
            "unpickling, which EXECUTES code embedded in the file. Only do this "
            "for checkpoints you trust.", RuntimeWarning)
        return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_checkpoint(path: str, allow_unsafe_load: bool = False) -> Dict[str, Any]:
    """Load a .pt checkpoint into a flat torch state dict. Handles plain
    state dicts, ``{'model': state_dict}``, and objects exposing
    ``.state_dict()``. Unpickling a full ultralytics ``DetectionModel`` needs
    the ultralytics package, which neither this package nor the card machine
    has: it fails here as it does for the JAX package; export its
    ``.state_dict()`` first (``torch.save(m.state_dict(), ...)``).

    allow_unsafe_load: see ``torch_load`` (cli.import_yolo: --unsafe).
    """
    obj = torch_load(path, allow_unsafe_load)
    inner = obj.get("model", obj) if isinstance(obj, dict) else obj
    if hasattr(inner, "state_dict"):
        inner = inner.float().state_dict() if hasattr(inner, "float") else inner.state_dict()
    if not isinstance(inner, dict):
        raise TypeError(f"unsupported checkpoint object: {type(obj)}")
    return inner
