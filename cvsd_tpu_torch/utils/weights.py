"""Weight bridge: flax variables (as numpy) -> the port's ``state_dict``, and
seeded random initialisation when no weights are given.

The port's modules are named after the flax auto-names (``Backbone_0``,
``ConvBNAct_3``, ``Conv_0``, ``BatchNorm_0``, ``MultiHeadDotProductAttention_1``,
...), so a flax path maps to a torch key mechanically:

    params/A/B/Conv_0/kernel       -> A.B.Conv_0.weight        HWIO -> OIHW
    params/A/Dense_0/kernel        -> A.Dense_0.weight         (in,out) -> (out,in)
    params/A/query/kernel          -> A.query.weight           (d,h,hd) -> (h*hd,d)
    params/A/out/kernel            -> A.out.weight             (h,hd,d) -> (d,h*hd)
    params/A/BatchNorm_0/scale     -> A.BatchNorm_0.weight
    batch_stats/A/BatchNorm_0/mean -> A.BatchNorm_0.running_mean   (var likewise)

The conversion is strict: every flax leaf is consumed, every torch tensor is
filled (BatchNorm's ``num_batches_tracked`` counter has no flax counterpart
and is left at 0), and every shape must match. Subtrees the port does not
hold yet are skipped only when named in ``skip``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out: Dict[Tuple[str, ...], Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def _convert_leaf(leaf: str, value: np.ndarray, target_shape: torch.Size) -> np.ndarray:
    if leaf == "kernel":
        if value.ndim == 4:  # conv HWIO -> OIHW
            return value.transpose(3, 2, 0, 1)
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
    complete ``state_dict`` for ``module``. ``skip`` lists '/'-joined flax
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
        arr = _convert_leaf(leaf, np.asarray(value, np.float32), target[key].shape)
        if tuple(arr.shape) != tuple(target[key].shape):
            raise ValueError(
                f"{'/'.join(path)}: shape {tuple(np.shape(value))} -> {tuple(arr.shape)} "
                f"does not match {key} {tuple(target[key].shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(target[key].dtype)
    if extra:
        raise KeyError(f"flax leaves with no torch counterpart: {extra[:8]}"
                       f"{' ...' if len(extra) > 8 else ''}")
    missing = [k for k in target if k not in out and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"torch tensors not filled from flax: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    for k in target:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros_like(target[k])
    return out


def load_flax_variables(module: nn.Module, variables: Mapping[str, Any],
                        skip: Iterable[str] = ()) -> nn.Module:
    """Fill ``module`` in place from flax variables (see flax_to_state_dict)."""
    module.load_state_dict(flax_to_state_dict(variables, module, skip), strict=True)
    return module


# ---------------------------------------------------------------------------
# seeded initialisation (no weights given)


@torch.no_grad()
def init_module(module: nn.Module, seed: int, xavier: bool = False) -> nn.Module:
    """Deterministic init from a seeded ``torch.Generator`` on the CPU.

    Conv/Linear weights: lecun-normal (std 1/sqrt(fan_in)), the flax default,
    or xavier-uniform where the JAX module asks for it (GCAE, transformer);
    biases 0; norm scales 1; running stats mean 0 / var 1. The numbers differ
    from flax's for the same seed: tests carry flax weights across with the
    bridge instead."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        if leaf == "bias":
            vals = torch.zeros(p.shape)
        elif isinstance(owner, (nn.Conv2d, nn.Linear)):
            fan_in = int(np.prod(p.shape[1:]))
            fan_out = int(p.shape[0]) * int(np.prod(p.shape[2:]))
            if xavier:
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
