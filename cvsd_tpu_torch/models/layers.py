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
        self.weight = nn.Parameter(torch.ones(*shape))
        self.bias = nn.Parameter(torch.zeros(*shape))
        self.register_buffer("running_mean", torch.zeros(*shape))
        self.register_buffer("running_var", torch.ones(*shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (not self.training and self.feature_dims == (1,)
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
        return ((x32 - mean.view(view)) * mul.view(view) + self.bias.view(view)).to(x.dtype)


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
