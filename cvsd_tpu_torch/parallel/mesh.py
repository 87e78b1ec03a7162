"""Device mesh and data parallelism over ``torch.distributed`` (the port of
``cvsd_tpu/parallel/mesh.py``).

The JAX package's mesh is one controller over every device, and XLA emits
the collectives from sharding annotations. Here there is one process per
device, and the mapping is *replicated host work, sharded device work*:
every rank runs the same host loop on the same inputs, keeps its rows of
each device batch, and the collectives are written out where the sharded
program needs them (``DataGroup``):

- a sharded batch's outputs come back to every rank by ``gather_rows``, as
  JAX returns the global array;
- a loss is the sum over ranks of each rank's share of the global loss
  (masked means divide by the global count), so the sum of the ranks'
  gradients, ``reduce_gradients``, is the gradient of the global loss;
- train-mode BatchNorm reduces its statistics over the group
  (``models/layers.py``), as flax's statistics are the global batch's.

    mcfg = MeshConfig.from_config(cfg)      # after init_process_group
    x = shard_batch(mcfg.mesh, batch)       # this rank's rows
    model = replicate(mcfg.mesh, model)     # rank 0's weights everywhere

``MeshConfig.device`` is the rank's device: ``cuda:<LOCAL_RANK>`` on the
card (NCCL), the CPU for a gloo group. A single rank's collectives are
identities, so a world of one computes bit for bit what no mesh does.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def default_mesh_shape(n_devices: int, n_axes: int) -> Tuple[int, ...]:
    """Factor n_devices into n_axes dims, largest first (data axis gets the most)."""
    if n_axes == 1:
        return (n_devices,)
    shape = [n_devices] + [1] * (n_axes - 1)
    # Peel small prime factors onto the trailing (model) axes.
    for axis in range(n_axes - 1, 0, -1):
        for p in (2, 2, 3):
            if shape[0] % p == 0 and shape[0] > p:
                shape[0] //= p
                shape[axis] *= p
                break
    return tuple(shape)


def local_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK>`` (the rank modulo the cards
    when no launcher set it), made current; the CPU otherwise."""
    if device_type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA device, and none is available")
    index = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _default_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


class _AllSum(torch.autograd.Function):
    """Sum over a group; the backward pass sums the gradients over it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class DataGroup:
    """The ranks that split a batch: this rank's rows and the collectives of
    a data-parallel step over them."""

    def __init__(self, group: Optional[dist.ProcessGroup], size: int, rank: int):
        self.group, self.size, self.rank = group, int(size), int(rank)

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.size:
            raise ValueError(f"batch of {n} does not split over {self.size} ranks; pad it "
                             "to a multiple (pad-and-mask, as the data layer does)")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the group, differentiable: its backward sums the
        gradients over the group, which is what a rank's share of a global
        loss needs from a global statistic."""
        return _AllSum.apply(t, self.group)

    @torch.no_grad()
    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the group, outside autograd."""
        dist.all_reduce(t, group=self.group)
        return t

    @torch.no_grad()
    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows, in rank order, on every rank."""
        src = t.contiguous()
        if src.dtype == torch.bool:  # collectives move bytes: booleans as uint8
            return self.gather_rows(src.to(torch.uint8)).bool()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=0)

    @torch.no_grad()
    def reduce_gradients(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Sum every present gradient over the group, one collective per
        dtype (the gradients flattened into one buffer)."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.group)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()


@dataclasses.dataclass
class MeshConfig:
    """Mesh + axis names resolved from the config tree (parallel section),
    and this rank's device."""

    mesh: DeviceMesh
    batch_axis: str = "data"
    model_axis: Optional[str] = None
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.device is None:
            self.device = local_device(self.mesh.device_type)

    @classmethod
    def from_config(cls, cfg: Dict[str, Any], device_type: Optional[str] = None) -> "MeshConfig":
        p = cfg.get("parallel", {}) if cfg else {}
        axes = tuple(p.get("mesh_axes") or ("data",))
        mesh = build_mesh(p.get("mesh_shape"), axes, device_type)
        return cls(mesh=mesh, batch_axis=p.get("batch_axis", axes[0]),
                   model_axis=p.get("model_axis"))

    @property
    def n_devices(self) -> int:
        return int(self.mesh.size())

    def batch_spec(self, ndim: int) -> List[Any]:
        return batch_sharding(self.mesh, ndim, self.batch_axis)

    def data_group(self) -> DataGroup:
        return axis_group(self.mesh, self.batch_axis)

    @property
    def is_writer(self) -> bool:
        """Only rank 0 writes files (CSVs, events, checkpoints, logs)."""
        return dist.get_rank() == 0


def writes(mesh_config: Optional[MeshConfig]) -> bool:
    """Whether this process writes output files: always without a mesh,
    rank 0 alone with one."""
    return mesh_config is None or mesh_config.is_writer


def axis_group(mesh: DeviceMesh, axis: str) -> DataGroup:
    """The ranks along ``axis`` that share this rank's other coordinates."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are {names}")
    dim = names.index(axis)
    return DataGroup(mesh.get_group(axis), mesh.size(dim), mesh.get_local_rank(axis))


def build_mesh(shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("data",),
               device_type: Optional[str] = None) -> DeviceMesh:
    """A DeviceMesh over every rank of the default process group (which must
    be initialized). shape=None -> all ranks on axis 0's side, as
    ``default_mesh_shape`` factors them. ``device_type`` defaults to the
    backend's: ``cuda`` for NCCL, ``cpu`` for gloo."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialized process group "
                           "(initialize_distributed, or torchrun and maybe_mesh)")
    n = dist.get_world_size()
    if shape is None:
        shape = default_mesh_shape(n, len(axis_names))
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != #devices {n}")
    device_type = device_type or _default_device_type()
    local_device(device_type)  # the rank's card is current before the mesh forms
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def batch_sharding(mesh: DeviceMesh, ndim: int, batch_axis: str = "data") -> List[Any]:
    """Placements that shard a tensor's leading (batch) dim over the data
    axis and replicate it over the others (DTensor's ``Shard(0)`` /
    ``Replicate()``, one per mesh dim)."""
    if ndim < 1:
        raise ValueError("a batch-sharded tensor needs a leading dim")
    return [Shard(0) if name == batch_axis else Replicate() for name in mesh.mesh_dim_names]


def replicated_sharding(mesh: DeviceMesh) -> List[Any]:
    return [Replicate()] * mesh.ndim


def _map_tree(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: DeviceMesh, tree: Any, batch_axis: str = "data",
                device: Optional[torch.device] = None) -> Any:
    """This rank's rows of every array of a tree of global host batches, as
    tensors on the rank's device. Pads nothing: the leading dim must split
    over the data axis (the data layer's batching does this with
    pad-and-mask)."""
    group = axis_group(mesh, batch_axis)
    device = device or local_device(mesh.device_type)

    def put(x):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        return x[group.rows(x.shape[0])].to(device)

    return _map_tree(put, tree)


@torch.no_grad()
def replicate(mesh: DeviceMesh, tree: Any) -> Any:
    """Rank 0's values everywhere: a broadcast of every parameter and buffer
    of a module, or of every tensor of a tree, in place over the mesh's
    ranks. Returns ``tree``."""
    group = mesh.get_group() if mesh.ndim == 1 else None  # None: the default (world) group
    src = int(mesh.mesh.flatten()[0])
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    else:
        tensors = []
        _map_tree(lambda t: tensors.append(t) if isinstance(t, torch.Tensor) else None, tree)
    for t in tensors:
        dist.broadcast(t.data, src=src, group=group)
    return tree
