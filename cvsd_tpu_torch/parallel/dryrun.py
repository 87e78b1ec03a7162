"""Multi-process dry run of the parallel layer (the counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``), on N gloo processes of the
CPU: the port's counterpart of JAX's virtual multi-device CPU mesh.

    python -m cvsd_tpu_torch.parallel.dryrun 4

With an even N > 1 the mesh is (data, model) = ``default_mesh_shape(N, 2)``,
else (data,) = (N,). Three phases, each held against the unsharded run of
the same step in the same process:

1. Shopformer's full training step (augmentation, the GCAE and transformer
   losses, Adam), data-parallel on "data" with each 2-D dense weight split
   on its output dim over "model" (torch ``Linear`` dim 0; flax kernel dim
   1). Two steps: the losses within rtol 1e-4 of the unsharded steps'.
2. A detector training step (``DetectorTrainer`` over the mesh) with every
   convolution's output channels split over "model" (OIHW dim 0; flax HWIO
   dim 3) and the clip's norm taken over the whole tensors; two steps,
   rtol 1e-4.
3. Six rendered videos through four concurrent streams, detection meshed
   over "data", against the single-device stream: the same event keys,
   scores within 1e-3, more than 20 events (skipped without cv2, as the
   JAX dry run's).

Tensor parallelism is written as column-parallel wrappers, not DTensor:
each keeps its output-channel shard, and two autograd functions carry the
collectives. The gather's backward keeps this rank's slice of the gradient
(the computation after the gather is replicated over "model", so every rank
holds the whole gradient) and the input's backward sums the partial input
gradients over "model". A backward that sums the replicated gradients (as
``torch.distributed.nn.functional.all_gather``'s does, model-size times the
true one) or an input without that sum leaves the first step's loss equal
and moves the second one's by 3-5 % here, which is why two steps are held.

Prints one ``dryrun_multichip(N): ... OK`` line.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from cvsd_tpu_torch.parallel.distributed import spawn_world
from cvsd_tpu_torch.parallel.mesh import (DataGroup, MeshConfig, axis_group, build_mesh,
                                          default_mesh_shape)

RTOL = 1e-4


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, y, tp: DataGroup, dim: int):
        ctx.tp, ctx.dim, ctx.width = tp, dim, y.shape[dim]
        parts = [torch.empty_like(y) for _ in range(tp.size)]
        dist.all_gather(parts, y.contiguous(), group=tp.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.tp.rank * ctx.width, ctx.width).contiguous(), None, None


class ColumnParallel(nn.Module):
    """A ``Linear`` or ``Conv2d`` holding this rank's shard of its output
    channels (weight dim 0); the output is gathered over the model axis."""

    def __init__(self, inner: nn.Module, tp: DataGroup):
        super().__init__()
        out = inner.weight.shape[0]
        rows = tp.rows(out)
        with torch.no_grad():
            inner.weight = nn.Parameter(inner.weight[rows].clone())
            if inner.bias is not None:
                inner.bias = nn.Parameter(inner.bias[rows].clone())
        if isinstance(inner, nn.Linear):
            inner.out_features, self.dim = out // tp.size, -1
        else:
            inner.out_channels, self.dim = out // tp.size, 1
        self.inner, self.tp = inner, tp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.inner(_CopyToModel.apply(x, self.tp.group))
        return _GatherFromModel.apply(y, self.tp, self.dim)


def shard_output_channels(model: nn.Module, kinds, tp: DataGroup) -> List[nn.Parameter]:
    """Replace every module of ``kinds`` whose output channels split over the
    model axis by its ``ColumnParallel`` shard; returns the sharded
    parameters."""
    sharded = []
    for name, child in list(model.named_children()):
        if isinstance(child, kinds) and child.weight.shape[0] % tp.size == 0:
            wrapped = ColumnParallel(child, tp)
            setattr(model, name, wrapped)
            sharded += list(wrapped.parameters())
        else:
            sharded += shard_output_channels(child, kinds, tp)
    return sharded


def tp_clipped_adam(params: Sequence[nn.Parameter], sharded: Sequence[nn.Parameter],
                    tp: Optional[DataGroup], lr: float):
    """``clipped_adam``'s optimizer (clip_by_global_norm(10), Adam) whose
    norm counts each sharded tensor whole: the shards' squares summed over
    the model axis."""
    from cvsd_tpu_torch.train.optim import StageOptimizer

    sharded_ids = {id(p) for p in sharded}

    class _Clipped(StageOptimizer):
        def global_norm(self, grads):
            full, shard = [], []
            for p, g in zip(self.all_params, grads):
                if g is not None:
                    (shard if id(p) in sharded_ids else full).append(g)
            sq = torch.zeros((), dtype=torch.float32)
            if full:
                sq = sq + torch.stack(torch._foreach_norm(full)).square().sum()
            if shard:
                part = torch.stack(torch._foreach_norm(shard)).square().sum()
                sq = sq + (tp.sum_(part) if tp is not None else part)
            return sq.sqrt()

    params = list(params)
    return _Clipped(params, params, "adam", lr, max_norm=10.0)


def _mesh(n: int):
    if n % 2 == 0 and n > 1:
        axes, shape = ("data", "model"), default_mesh_shape(n, 2)
    else:
        axes, shape = ("data",), (n,)
    mc = MeshConfig(build_mesh(shape, axes, "cpu"), batch_axis="data",
                    model_axis="model" if "model" in axes else None)
    tp = axis_group(mc.mesh, "model") if mc.model_axis else None
    return mc, tp, dict(zip(axes, shape))


def shopformer_steps(poses: np.ndarray, dp: Optional[DataGroup], tp: Optional[DataGroup],
                     steps: int = 2) -> List[float]:
    """Phase 1: ``steps`` full Shopformer steps on the global batch
    ``poses``; data-parallel over ``dp`` and tensor-parallel over ``tp``
    where given. Returns the global losses."""
    from cvsd_tpu_torch.config import get_default_config
    from cvsd_tpu_torch.data.augment import batched_augment_from_config
    from cvsd_tpu_torch.models.layers import DropoutRNG, set_data_group
    from cvsd_tpu_torch.models.shopformer import build_shopformer

    cfg = get_default_config()
    cfg["model"]["hidden_channels"] = 16  # tiny shapes for the dry run
    model = build_shopformer(cfg, device="cpu", seed=0)
    if tp is not None:
        shard_output_channels(model, (nn.Linear,), tp)
    set_data_group(model, dp)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)
    gen = torch.Generator()
    x_all = torch.from_numpy(poses)
    losses = []
    for step in range(steps):
        gen.manual_seed(1000 + step)
        x = batched_augment_from_config(gen, x_all, cfg)
        rows = None
        if dp is not None:
            rows = (dp.rows(x.shape[0]), x.shape[0])
            x = x[rows[0]]
        gen.manual_seed(2000 + step)  # one dropout key for both losses, as JAX's step
        gcae = model.compute_gcae_loss(x, train=True, rng=DropoutRNG(gen, rows), data_group=dp)
        gen.manual_seed(2000 + step)
        tr = model.compute_transformer_loss(x, train=True, rng=DropoutRNG(gen, rows),
                                            data_group=dp)
        loss = gcae + tr
        loss.backward()
        loss = loss.detach()
        if dp is not None:
            dp.reduce_gradients(model.parameters())
            loss = dp.sum_(loss)
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss))
    return losses


def detector_steps(batch, mesh_config: Optional[MeshConfig], tp: Optional[DataGroup],
                   steps: int = 2) -> List[float]:
    """Phase 2: ``steps`` detector training steps on one global batch,
    ``DetectorTrainer`` over ``mesh_config`` with the convolutions' output
    channels split over ``tp`` where given. Returns the global losses."""
    from cvsd_tpu_torch.models.detector import PersonDetector
    from cvsd_tpu_torch.train.detector_train import DetectorTrainer

    det = PersonDetector(img_size=64, width_mult=0.25, depth_mult=0.34, dtype=torch.float32)
    trainer = DetectorTrainer(det, lr=1e-3, seed=0, mesh_config=mesh_config, device="cpu")
    if tp is not None:
        sharded = shard_output_channels(trainer.model, (nn.Conv2d,), tp)
        trainer.opt = tp_clipped_adam(trainer.model.parameters(), sharded, tp, 1e-3)
    return [trainer.train_step(*batch)["loss"] for _ in range(steps)]


def stream_events(mesh_config: Optional[MeshConfig], workdir: str, dp_size: int):
    """Phase 3: 6 rendered videos through 4 concurrent streams; the events."""
    from cvsd_tpu_torch.config import get_default_config
    from cvsd_tpu_torch.data.video import write_test_video
    from cvsd_tpu_torch.eval.evaluate import ShopformerScorer
    from cvsd_tpu_torch.models.shopformer import build_shopformer
    from cvsd_tpu_torch.pipeline.streaming import StreamingPipeline

    cfg = get_default_config()
    cfg["detector"].update(img_size=64, width_mult=0.25, depth_mult=0.34,
                           batch_size=max(2 * dp_size, 4), conf_threshold=0.0,
                           max_detections=2, dtype="float32", pose_head=True,
                           native_decode=False)
    cfg["model"]["hidden_channels"] = 8
    cfg["data"]["stride"] = 6
    scorer = ShopformerScorer(build_shopformer(cfg, device="cpu", seed=0), cfg, device="cpu")
    vids = [write_test_video(f"{workdir}/v{i}.mp4", num_frames=40, width=160, height=128,
                             seed=i) for i in range(6)]
    pipe = StreamingPipeline(cfg, scorer, device="cpu", mesh_config=mesh_config)
    return pipe.stream_videos_concurrent(vids, max_streams=4)["events"]


def _check(name: str, got: Sequence[float], ref: Sequence[float]) -> None:
    if not np.all(np.isfinite(got)):
        raise RuntimeError(f"{name}: non-finite loss {got}")
    if not np.allclose(got, ref, rtol=RTOL, atol=0.0):
        raise RuntimeError(f"{name}: sharded losses {got} differ from the unsharded {ref} "
                           f"beyond rtol {RTOL}")


def _body(n: int) -> str:
    mc, tp, shape = _mesh(n)
    dp = mc.data_group()
    poses = np.random.default_rng(0).normal(size=(2 * dp.size, 12, 18, 2)).astype(np.float32)
    loss = shopformer_steps(poses, dp, tp)
    _check("shopformer", loss, shopformer_steps(poses, None, None))
    msg = f"dryrun_multichip({n}): mesh={shape} loss={loss[0]:.5f}"
    if tp is not None:
        from cvsd_tpu_torch.train.detector_train import synthetic_detection_batch

        batch = synthetic_detection_batch(np.random.default_rng(0), 2 * dp.size, 64, max_gt=2)
        det = detector_steps(batch, mc, tp)
        _check("detector", det, detector_steps(batch, None, None))
        msg += f" det_tp_loss={det[0]:.5f}"
    try:
        import cv2  # noqa: F401 (rendering needs OpenCV)
    except ImportError:
        return msg + " OK"
    with tempfile.TemporaryDirectory() as td:
        single = stream_events(None, td, dp.size)
        meshed = stream_events(mc, td, dp.size)

    def ekey(e):
        return (e.video, e.track_id, e.frame_end)

    if sorted(map(ekey, meshed)) != sorted(map(ekey, single)):
        raise RuntimeError("mesh streaming event mismatch")
    scores: Dict = {ekey(e): e.score for e in single}
    drift = max((abs(scores[ekey(e)] - e.score) for e in meshed), default=0.0)
    if drift >= 1e-3:
        raise RuntimeError(f"mesh streaming score drift {drift}")
    if len(meshed) <= 20:  # a vacuous pass would gate nothing
        raise RuntimeError(f"streaming gate too thin: {len(meshed)} events")
    return msg + f" streaming_events={len(meshed)}(mesh==single) OK"


def dryrun_multichip(n_devices: int, timeout: float = 900.0) -> str:
    """Run the three phases on ``n_devices`` gloo processes; print and
    return rank 0's line. Raises if a phase fails on any rank."""
    with tempfile.TemporaryDirectory() as store_dir:
        lines = spawn_world(_body, n_devices, (n_devices,), store_dir=store_dir,
                            timeout=timeout)
    print(lines[0], flush=True)
    return lines[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n", type=int, nargs="?", default=4, help="processes (the mesh's devices)")
    p.add_argument("--timeout", type=float, default=900.0)
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.timeout)


if __name__ == "__main__":
    main()
