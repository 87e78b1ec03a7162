"""Weight bridge: flax variables (as numpy) -> the port's ``state_dict``, and
seeded random initialisation when no weights are given.

The port's modules are named after the flax auto-names (``Backbone_0``,
``ConvBNAct_3``, ``Conv_0``, ``BatchNorm_0``, ``MultiHeadDotProductAttention_1``,
...), so a flax path maps to a torch key mechanically:

    params/A/B/Conv_0/kernel       -> A.B.Conv_0.weight        HWIO -> OIHW
    params/A/ConvTranspose_0/kernel -> A.ConvTranspose_0.weight HWIO -> IOHW, flipped in H and W
    params/A/Conv_1/kernel (1-D)   -> A.Conv_1.weight          (k, in/g, out) -> (out, in/g, k)
    params/A/Dense_0/kernel        -> A.Dense_0.weight         (in,out) -> (out,in)
    params/A/query/kernel          -> A.query.weight           (d,h,hd) -> (h*hd,d)
    params/A/out/kernel            -> A.out.weight             (h,hd,d) -> (d,h*hd)
    params/A/BatchNorm_0/scale     -> A.BatchNorm_0.weight
    batch_stats/A/BatchNorm_0/mean -> A.BatchNorm_0.running_mean   (var likewise)
    params/A/ConvBNAct_0/w_int8     -> A.ConvBNAct_0.w_int8     HWIO -> (O, H*W*I), int8 kept
    params/A/ConvBNAct_0/w          -> A.ConvBNAct_0.w          HWIO as is (the QAT kernel)
    params/A/ConvBNAct_0/{w_scale,act_scale} -> the same names (float32)

The conversion is strict: every flax leaf is consumed, every torch tensor is
filled (BatchNorm's ``num_batches_tracked`` counter has no flax counterpart
and is left at 0), and every shape must match. Subtrees the port does not
hold are skipped only when named in ``skip``. ``state_dict_to_flax`` goes
the other way, for checkpoints the port writes.

flax's ``ConvTranspose`` does not flip its kernel (lax's ``conv_transpose``
with ``transpose_kernel=False``); ``nn.ConvTranspose2d`` is the gradient of
a convolution, which does. So a flax ConvTranspose equals the torch one with
the kernel flipped along both spatial axes (and the torch padding set to
match flax's, as ``models/gcae.py::GCAEDecoder`` does).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
# the int8 detector's ConvBNAct leaves (models/detector_int8.py), same names both sides
_QUANT_LEAVES = ("w_int8", "w_scale", "act_scale", "w")
_PARAM_LEAF.update({leaf: leaf for leaf in _QUANT_LEAVES})
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out: Dict[Tuple[str, ...], Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def _convert_leaf(leaf: str, value: np.ndarray, target_shape: torch.Size,
                  transposed: bool = False) -> np.ndarray:
    if leaf == "w_int8":  # HWIO -> the GEMM layout (O, H*W*I), rows in (h, w, i) order
        return value.reshape(-1, value.shape[-1]).T
    if leaf == "kernel":
        if transposed:  # ConvTranspose HWIO -> IOHW, the kernel flipped in H and W
            return value.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        if value.ndim == 4:  # conv HWIO -> OIHW
            return value.transpose(3, 2, 0, 1)
        if value.ndim == 3 and len(target_shape) == 3:  # 1-D conv (k, in/g, out) -> (out, in/g, k)
            return value.transpose(2, 1, 0)
        if len(target_shape) == 2:  # Dense / DenseGeneral: inputs first, outputs last
            return value.reshape(int(target_shape[1]), -1).T
    if leaf == "bias" and value.ndim > 1 and len(target_shape) == 1:
        return value.reshape(-1)  # attention q/k/v bias (heads, head_dim)
    return value


def flax_to_state_dict(
    variables: Mapping[str, Any],
    module: nn.Module,
    skip: Iterable[str] = (),
) -> Dict[str, torch.Tensor]:
    """Convert ``{"params": ..., "batch_stats": ...}`` (numpy leaves) into a
    complete ``state_dict`` for ``module``, on the host; only the module's
    shapes and dtypes are read, so it may lie on the meta device. ``skip``
    lists '/'-joined flax
    subtree prefixes without the collection (e.g. ``"gcae/decoder"``) that the
    port deliberately does not hold. Raises ``KeyError`` on a missing or
    extra key and ``ValueError`` on a shape mismatch."""
    target = module.state_dict()
    skip = tuple(s.strip("/") + "/" for s in skip)
    out: Dict[str, torch.Tensor] = {}
    extra = []
    for path, value in _flatten(variables).items():
        collection, *mod_path, leaf = path
        if skip and ("/".join(mod_path) + "/").startswith(skip):
            continue
        table = {"params": _PARAM_LEAF, "batch_stats": _STAT_LEAF}.get(collection)
        if table is None or leaf not in table:
            extra.append("/".join(path))
            continue
        key = ".".join(mod_path + [table[leaf]])
        if key not in target:
            extra.append("/".join(path))
            continue
        if isinstance(value, torch.Tensor):  # a bfloat16 leaf read from a checkpoint
            value = value.to(torch.float32).numpy()
        owner = module.get_submodule(".".join(mod_path))
        if (target[key].dtype == torch.int8) != (np.asarray(value).dtype == np.int8):
            raise ValueError(f"{'/'.join(path)}: dtype {np.asarray(value).dtype} does not "
                             f"match {key} {target[key].dtype}")
        value = np.asarray(value) if target[key].dtype == torch.int8 else np.asarray(
            value, np.float32)
        arr = _convert_leaf(leaf, value, target[key].shape, isinstance(owner, nn.ConvTranspose2d))
        if tuple(arr.shape) != tuple(target[key].shape):
            raise ValueError(
                f"{'/'.join(path)}: shape {tuple(np.shape(value))} -> {tuple(arr.shape)} "
                f"does not match {key} {tuple(target[key].shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape)).to(
            target[key].dtype)  # ascontiguousarray makes a 0-d array 1-d
    if extra:
        raise KeyError(f"flax leaves with no torch counterpart: {extra[:8]}"
                       f"{' ...' if len(extra) > 8 else ''}")
    missing = [k for k in target if k not in out and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"torch tensors not filled from flax: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    for k in target:  # on the host, whatever device the template lies on
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros(target[k].shape, dtype=target[k].dtype)
    return out


def load_flax_variables(module: nn.Module, variables: Mapping[str, Any],
                        skip: Iterable[str] = ()) -> nn.Module:
    """Fill ``module`` in place from flax variables (see flax_to_state_dict)."""
    module.load_state_dict(flax_to_state_dict(variables, module, skip), strict=True)
    return module


def _to_flax_leaf(owner: nn.Module, name: str, leaf: str, value: np.ndarray,
                  heads: Optional[int]) -> Tuple[str, str, np.ndarray]:
    """(collection, flax leaf name, flax-shaped value) of one torch tensor,
    every case of ``_convert_leaf`` undone. ``heads``: the head count of the
    attention module that owns ``owner``, else None."""
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", leaf[len("running_"):], value
    if leaf == "w_int8":  # (O, H*W*I) -> HWIO
        return "params", leaf, value.reshape(owner.features, owner.kernel, owner.kernel,
                                             owner.cin).transpose(1, 2, 3, 0)
    if leaf in _QUANT_LEAVES:
        return "params", leaf, value
    qkv = heads is not None and name in ("query", "key", "value")
    if leaf == "bias":  # attention q/k/v (h*hd,) -> (h, hd)
        return "params", "bias", value.reshape(heads, -1) if qkv else value
    if isinstance(owner, nn.ConvTranspose2d):  # IOHW -> HWIO, unflipped
        return "params", "kernel", value[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(owner, nn.Conv2d):  # OIHW -> HWIO
        return "params", "kernel", value.transpose(2, 3, 1, 0)
    if isinstance(owner, nn.Conv1d):  # (out, in/g, k) -> (k, in/g, out)
        return "params", "kernel", value.transpose(2, 1, 0)
    if isinstance(owner, nn.Linear):  # (out, in) -> (in, out)
        kernel = value.T
        if qkv:  # (d, h*hd) -> (d, h, hd)
            kernel = kernel.reshape(kernel.shape[0], heads, -1)
        elif heads is not None and name == "out":  # (h*hd, d) -> (h, hd, d)
            kernel = kernel.reshape(heads, -1, kernel.shape[1])
        return "params", "kernel", kernel
    return "params", "scale", value  # norm scales


def state_dict_to_flax(module: nn.Module, skip: Iterable[str] = ()) -> Dict[str, Any]:
    """The inverse of ``flax_to_state_dict``: ``module``'s tensors as
    ``{"params": ..., "batch_stats": ...}`` of float32 numpy arrays under the
    flax names and layouts, ready for ``utils/checkpoint.py``. BatchNorm's
    ``num_batches_tracked`` is dropped; ``skip`` lists '/'-joined flax
    subtree prefixes to leave out, as in ``flax_to_state_dict``."""
    skip = tuple(s.strip("/") + "/" for s in skip)
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, tensor in module.state_dict().items():
        owner_path, leaf = key.rsplit(".", 1)
        mod_path = owner_path.split(".")
        if leaf == "num_batches_tracked" or (skip and (owner_path.replace(".", "/") + "/")
                                             .startswith(skip)):
            continue
        owner = module.get_submodule(owner_path)
        parent = module.get_submodule(owner_path.rpartition(".")[0])
        heads = getattr(parent, "num_heads", None) if isinstance(owner, nn.Linear) else None
        value = tensor.detach().cpu()  # int8 stays int8, everything else float32
        value = (value if value.dtype == torch.int8 else value.to(torch.float32)).numpy()
        collection, name, arr = _to_flax_leaf(owner, mod_path[-1], leaf, value, heads)
        node = out[collection]
        for part in mod_path:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr).reshape(arr.shape)  # 0-d stays 0-d
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out


# ---------------------------------------------------------------------------
# seeded initialisation (no weights given)


# erf(-sqrt 2), erf(sqrt 2): a standard normal's CDF at -2 and 2, as 2 * cdf - 1
_ERF_LO, _ERF_HI = math.erf(-math.sqrt(2.0)), math.erf(math.sqrt(2.0))
# Giles (2010), "Approximating the erfinv function": the central branch
# (w < 5), which covers |x| <= erf(sqrt 2); relative error below 4e-7
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)


def _truncated_normal(shape, gen: torch.Generator) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], float32: ``trunc_normal_``'s
    uniform draw from ``gen``, mapped through erfinv in float64 numpy.

    ``torch.nn.init.trunc_normal_`` samples with torch's float32 host
    kernels, which run multithreaded: on one card machine two builds of one
    seed in one process differed in an eighth of one such tensor (one
    thread's share of eight), so two trainings of one seed did not repeat.
    numpy maps the draw on the calling thread alone, the same way on every
    torch version."""
    u = torch.empty(shape).uniform_(_ERF_LO, _ERF_HI, generator=gen).double().numpy()
    w = -np.log((1.0 - u) * (1.0 + u)) - 2.5
    poly = np.zeros_like(u)
    for c in _ERFINV_CENTRAL:
        poly = poly * w + c
    return torch.from_numpy(np.clip(math.sqrt(2.0) * poly * u, -2.0, 2.0).astype(np.float32))


@torch.no_grad()
def init_module(module: nn.Module, seed: int, xavier: bool = False,
                truncated: bool = False) -> nn.Module:
    """Deterministic init from a seeded ``torch.Generator`` on the CPU.

    Conv/Linear weights: lecun-normal (std 1/sqrt(fan_in)); with
    ``truncated``, flax's default ``lecun_normal()`` itself (a normal
    truncated at 2 standard deviations, rescaled to std 1/sqrt(fan_in)), which
    the trainers start from, as the reference's do;
    or xavier-uniform where the JAX module asks for it (GCAE, transformer);
    there, a Linear of a module that names ``flax_kernel_init =
    "lecun_normal"`` (the attention projections, left at flax's default) is
    flax's truncated lecun-normal (within 2 standard deviations, rescaled to
    std 1/sqrt(fan_in)); biases 0; norm scales 1; running stats mean 0 / var
    1. The numbers differ from flax's for the same seed: tests carry flax
    weights across with the bridge instead."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        if leaf == "bias":
            vals = torch.zeros(p.shape)
        elif isinstance(owner, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in = int(np.prod(p.shape[1:]))
            fan_out = int(p.shape[0]) * int(np.prod(p.shape[2:]))
            if isinstance(owner, nn.ConvTranspose2d):  # weight is (in, out, kh, kw)
                fan_in, fan_out = fan_out, fan_in
            parent = module.get_submodule(name.rsplit(".", 2)[0]) if name.count(".") > 1 else module
            if truncated or (xavier and getattr(parent, "flax_kernel_init", None)
                             == "lecun_normal"):
                vals = _truncated_normal(p.shape, gen) * (math.sqrt(1.0 / fan_in)
                                                          / 0.87962566103423978)
            elif xavier:
                a = math.sqrt(6.0 / (fan_in + fan_out))
                vals = torch.rand(p.shape, generator=gen) * (2 * a) - a
            else:
                vals = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
        else:  # norm scales
            vals = torch.ones(p.shape)
        p.copy_(vals.to(p.dtype))
    for name, b in module.named_buffers():
        if name.endswith("running_mean"):
            b.zero_()
        elif name.endswith("running_var"):
            b.fill_(1.0)
    return module
