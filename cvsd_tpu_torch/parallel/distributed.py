"""Process groups, hybrid meshes and worker worlds (the port of
``cvsd_tpu/parallel/distributed.py``).

``jax.distributed.initialize`` becomes ``init_process_group`` over TCP:
NCCL on the card, gloo where the caller asks for the CPU. A hybrid mesh keeps its inner
axes inside a node and puts the node (DCN) part of each axis outermost, as
``mesh_utils.create_hybrid_device_mesh`` does. ``spawn_world`` runs a
function in N spawned processes of one gloo group: the CPU counterpart of
the JAX package's virtual multi-device CPU mesh, used by the dry run
(``parallel/dryrun.py``) and the tests.
"""

from __future__ import annotations

import math
import os
import queue
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from cvsd_tpu_torch.parallel.mesh import _default_device_type, local_device
from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
) -> bool:
    """Join a process group of ``num_processes`` at ``coordinator_address``
    (host:port). The group follows the device the caller asked for, as
    ``cli/common.py::maybe_mesh`` does: ``device='cpu'`` joins gloo;
    anything else (unset: the card) resolves the card first and joins NCCL,
    raising without one. No-op (returns False) in single-process settings,
    safe to call unconditionally."""
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("a process group of several processes needs the coordinator's "
                         "address and this process's id")
    backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    return True


def hybrid_rank_layout(ici_shape: Sequence[int],
                       dcn_shape: Optional[Sequence[int]] = None) -> np.ndarray:
    """The ranks of a mesh of shape ici * dcn (axis by axis). Ranks are laid
    out node-major, ``prod(ici_shape)`` ranks a node; along each axis the
    node (DCN) part is outermost, so a collective over an axis whose DCN
    size is 1 stays inside a node. Without ``dcn_shape``: the ranks in
    order, reshaped."""
    ici = tuple(int(s) for s in ici_shape)
    if dcn_shape is None:
        return np.arange(math.prod(ici)).reshape(ici)
    dcn = tuple(int(s) for s in dcn_shape)
    if len(dcn) != len(ici):
        raise ValueError(f"dcn_shape {dcn} and ici_shape {ici} differ in length")
    shape = tuple(i * d for i, d in zip(ici, dcn))
    layout = np.empty(shape, np.int64)
    per_node = math.prod(ici)
    for coord in np.ndindex(*shape):
        node = np.ravel_multi_index(tuple(c // i for c, i in zip(coord, ici)), dcn)
        local = np.ravel_multi_index(tuple(c % i for c, i in zip(coord, ici)), ici)
        layout[coord] = node * per_node + local
    return layout


def create_hybrid_mesh(
    ici_shape: Sequence[int],
    dcn_shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """A DeviceMesh whose inner (trailing) parts of each axis map to ranks
    of one node and outer parts across nodes (``hybrid_rank_layout``).
    Falls back to a plain reshaped mesh without ``dcn_shape``."""
    layout = hybrid_rank_layout(ici_shape, dcn_shape)
    if layout.size != dist.get_world_size():
        raise ValueError(f"mesh of {layout.size} ranks != world of {dist.get_world_size()}")
    device_type = device_type or _default_device_type()
    local_device(device_type)
    return DeviceMesh(device_type, torch.from_numpy(layout), mesh_dim_names=tuple(axis_names))


def process_local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(per-process batch, offset) for multi-process input pipelines: each
    process feeds only its shard of the global batch; (global, 0) without a
    process group."""
    if not dist.is_initialized():
        return global_batch, 0
    n = dist.get_world_size()
    per = global_batch // n
    return per, per * dist.get_rank()


def _world_worker(fn: Callable, rank: int, world: int, store_path: str, threads: int,
                  args: Tuple[Any, ...], results) -> None:
    torch.set_num_threads(threads)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        results.put((rank, True, fn(*args)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def spawn_world(fn: Callable, world: int, args: Tuple[Any, ...] = (), *,
                store_dir: str, timeout: float = 300.0, threads: int = 1) -> List[Any]:
    """``fn(*args)`` in ``world`` spawned processes that form one gloo group
    (a ``FileStore`` under ``store_dir``, which must hold no store yet);
    returns each rank's result in rank order. ``fn`` must be importable (a
    module-level function). Raises with the failing ranks' tracebacks, or
    after ``timeout`` seconds, and leaves no process running."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_path = os.path.join(store_dir, "world.store")
    procs = [ctx.Process(target=_world_worker,
                         args=(fn, rank, world, store_path, threads, args, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):  # drain the queue before joining
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"world of {world} did not finish in {timeout} s") from None
            if not ok:  # the other ranks may wait in a collective: stop them all
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30 if len(got) == world else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]
