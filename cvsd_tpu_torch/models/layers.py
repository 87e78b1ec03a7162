"""Train-mode building blocks with flax's semantics, shared by the GCAE, the
transformer and XceptionTime.

- ``FlaxBatchNorm``: flax ``nn.BatchNorm(momentum, epsilon)`` (default 0.9,
  1e-5) over any feature dims. Training normalizes with the batch
  statistics (variance E[x^2] - E[x]^2, clipped at 0) and moves the running
  ones towards them by ``momentum``, the BIASED variance included;
  evaluation uses the running ones. ``nn.BatchNorm2d`` keeps the unbiased
  variance, takes a two-pass variance and counts momentum the other way, so
  it cannot stand in for training; evaluation over the channels of
  (B, C, ...) whose input has the statistics' dtype is ``F.batch_norm``'s,
  as the port computed it before training came, so its outputs do not move
  by a bit. A half-precision input (a bfloat16 detector over float32
  parameters) is reduced and normalized in float32 and returned in its own
  dtype, as flax's ``force_float32_reductions`` does.
- ``DropoutRNG`` and ``dropout``: flax ``nn.Dropout`` (keep with probability
  1 - p, scale kept values by 1/(1 - p)) drawing from one explicit
  ``torch.Generator``, never the global RNG. The masks drawn in a forward are
  kept, so a forward recomputed by ``torch.utils.checkpoint`` replays them
  (checkpoint restores only the global RNGs, not an explicit generator).
- flax's ``dtype`` / ``param_dtype`` split as XLA computes it (the
  Shopformer's ``model.dtype``): ``Linear``, ``Conv2d``, ``ConvTranspose2d``
  and ``LayerNorm`` are PyTorch's layers with a ``compute_dtype``. Unset (the
  default) they are PyTorch's layers as they are. Set
  (``set_compute_dtype``), activations are tensors of the compute dtype, so
  each elementwise op rounds to it, as XLA rounds each bfloat16 op of a flax
  model of ``dtype=bfloat16``; products (``Dense``, ``Conv``, ``product``'s
  einsums) take their operands and kernels in it and accumulate in float32;
  ``FlaxBatchNorm`` and ``LayerNorm`` normalize in float32 over float32
  parameters and round their output. Two places follow XLA's float32
  propagation, which computes an op in float32 where every consumer widens
  its result: a convolution's bias is added in float32 (a BatchNorm takes
  it), and ``softmax`` sums in float32. ``softmax`` and ``gelu`` are
  flax's, op by op.
- ``frozen_batch_stats``: a forward recomputed in the backward pass must not
  move the running statistics a second time; the trainer runs the backward
  pass inside it.
- Data parallelism (``parallel/mesh.py``): under a mesh flax's train-mode
  statistics are the global batch's, so ``set_data_group`` makes every
  ``FlaxBatchNorm`` average its per-channel mean and mean of squares over
  the ranks (in float32, flax's formula after, the running statistics moved
  once), and a ``DropoutRNG`` with ``rows`` draws the global batch's masks
  and keeps this rank's rows.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


class FlaxBatchNorm(nn.Module):
    """flax BatchNorm over the ``feature_dims`` of x (default the channels of
    (B, C, ...)); every other dim is reduced. Parameters and statistics have
    ``shape``, the sizes of the feature dims in order."""

    def __init__(self, shape: Union[int, Sequence[int]], feature_dims: Sequence[int] = (1,),
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if len(shape) != len(feature_dims):
            raise ValueError(f"shape {shape} does not match feature_dims {tuple(feature_dims)}")
        self.feature_dims = tuple(feature_dims)
        self.momentum, self.eps = momentum, eps
        self.update_stats = True  # cleared by frozen_batch_stats
        self.data_group = None  # set_data_group: statistics over the mesh's data axis
        self.compute_dtype: Optional[torch.dtype] = None  # set_compute_dtype: the output's
        self.weight = nn.Parameter(torch.ones(*shape))
        self.bias = nn.Parameter(torch.zeros(*shape))
        self.register_buffer("running_mean", torch.zeros(*shape))
        self.register_buffer("running_var", torch.ones(*shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (not self.training and self.feature_dims == (1,) and self.compute_dtype is None
                and x.dtype == self.running_mean.dtype):
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        feat = [d % x.ndim for d in self.feature_dims]
        reduce = tuple(d for d in range(x.ndim) if d not in feat)
        view = [x.shape[d] if d in feat else 1 for d in range(x.ndim)]
        x32 = x.float()  # a no-op for float32 input
        if self.training:
            mean, mean_sq = x32.mean(dim=reduce), (x32 * x32).mean(dim=reduce)
            if self.data_group is not None:  # every rank holds as many rows
                both = self.data_group.all_sum(torch.stack([mean, mean_sq]) / self.data_group.size)
                mean, mean_sq = both[0], both[1]
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            if self.update_stats:
                with torch.no_grad():
                    self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                    self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = (x32 - mean.view(view)) * mul.view(view) + self.bias.view(view)
        return out.to(self.compute_dtype or x.dtype)


class Linear(nn.Linear):
    """``nn.Linear``; with ``compute_dtype``, flax's ``Dense(dtype=...)``."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d``; with ``compute_dtype``, flax's ``Conv(dtype=...)``, the
    bias added in float32 and a float32 output (XLA's float32 propagation:
    the model's convolutions feed BatchNorms, or leave it widened)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None).float()
        return y if self.bias is None else y + self.bias.to(dt).float().view(1, -1, 1, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d``; with ``compute_dtype``, flax's
    ``ConvTranspose(dtype=...)`` as ``Conv2d`` computes it (the kernel flip
    is the weight bridge's)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding,
                               self.output_padding, self.groups, self.dilation).float()
        return y if self.bias is None else y + self.bias.to(dt).float().view(1, -1, 1, 1)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm``; with ``compute_dtype``, flax's ``LayerNorm(dtype=...)``:
    flax's statistics (variance E[x^2] - E[x]^2) and normalization in
    float32 over float32 parameters, the output rounded to the compute
    dtype."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x32 - mean) * mul + self.bias).to(dt)


def product(equation: str, dtype: Optional[torch.dtype], *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; with a compute ``dtype``, over operands cast to it."""
    if dtype is None:
        return torch.einsum(equation, *operands)
    return torch.einsum(equation, *(o.to(dtype) for o in operands))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax`` op by op: in x's dtype, each op rounded to it, the
    sum in float32 (for float32 x: ``torch.softmax``)."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.float().sum(dim=dim, keepdim=True).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU; below float32, flax's ``0.5 * x * erfc(-x * sqrt(1/2))``
    op by op in x's dtype (sqrt(1/2) rounded to it)."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    sqrt_half = torch.tensor(0.5 ** 0.5, dtype=x.dtype, device=x.device)
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Every submodule of ``module`` that has a ``compute_dtype`` computes in
    ``dtype`` (None: as PyTorch computes, in its input's dtype); the
    parameters keep their own."""
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return module


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module) -> Iterator[None]:
    """Inside, no ``FlaxBatchNorm`` of ``module`` moves its running statistics
    (a train-mode forward still normalizes with the batch's)."""
    norms = [m for m in module.modules() if isinstance(m, FlaxBatchNorm)]
    saved = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m, s in zip(norms, saved):
            m.update_stats = s


def set_data_group(module: nn.Module, group) -> nn.Module:
    """Every ``FlaxBatchNorm`` of ``module`` takes its train-mode statistics
    over ``group`` (a ``parallel.mesh.DataGroup``; None: this rank's batch)."""
    for m in module.modules():
        if isinstance(m, FlaxBatchNorm):
            m.data_group = group
    return module


class DropoutRNG:
    """Dropout masks from one explicit generator, in the order a forward asks
    for them. ``rewind`` before a recomputed forward makes it take the same
    masks again instead of drawing new ones. ``rows`` = (slice, global
    rows): a mask over the batch is drawn for the global batch and this
    rank's rows are kept, so a meshed step drops what the single-device
    step on the global batch drops."""

    def __init__(self, generator: torch.Generator, rows: Optional[Tuple[slice, int]] = None):
        self.generator = generator
        self.rows = rows
        self._masks: List[torch.Tensor] = []
        self._cursor = 0

    def rewind(self) -> None:
        self._cursor = 0

    def keep_mask(self, shape: Tuple[int, ...], keep: float, device: torch.device,
                  batched: bool = True) -> torch.Tensor:
        """A boolean mask of ``shape``, True with probability ``keep``;
        ``batched``: dim 0 is the batch (False for a mask broadcast over it)."""
        if self._cursor < len(self._masks):
            mask = self._masks[self._cursor]
        else:
            draw = shape
            if batched and self.rows is not None:
                draw = (self.rows[1],) + tuple(shape[1:])
            u = torch.empty(draw, device=device).bernoulli_(keep, generator=self.generator)
            mask = u.bool()
            if draw != shape:
                mask = mask[self.rows[0]]
            self._masks.append(mask)
        self._cursor += 1
        return mask


def dropout(x: torch.Tensor, p: float, training: bool, rng: Optional[DropoutRNG]) -> torch.Tensor:
    """flax ``nn.Dropout(p)``: in training, x / (1 - p) where kept, else 0;
    the identity in evaluation or at p = 0."""
    if not training or p <= 0.0:
        return x
    if rng is None:
        raise ValueError("train-mode dropout needs a DropoutRNG (an explicit generator)")
    keep = 1.0 - p
    mask = rng.keep_mask(tuple(x.shape), keep, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


@contextlib.contextmanager
def set_mode(module: nn.Module, train: bool) -> Iterator[None]:
    """Inside, ``module`` (and its children) in train or eval mode; its
    previous mode is restored after."""
    prev = module.training
    module.train(train)
    try:
        yield
    finally:
        module.train(prev)
