"""Optimizers, learning-rate schedules, gradient accumulation, freezing and
early stopping (PyTorch port of ``cvsd_tpu/train/optim.py``, which builds
them from optax).

``build_optimizer`` returns a ``StageOptimizer`` that behaves as the JAX
package's chain ``MultiSteps(chain(clip_by_global_norm, inject_hyperparams(
adam | adamw)))`` does:

- **Accumulation** (``grad_accum_steps`` k > 1) is ``optax.MultiSteps``: the
  running mean of k micro-gradients (Welford, acc + (g - acc) / (n + 1)),
  applied at the k-th micro-step. Its counter lives in the optimizer, so it
  carries across epoch boundaries. The schedule counts applied updates only.
- **Clipping** is optax's formula: where the global norm ||g|| over ALL
  gradients (a frozen part's included) is at least ``max_norm``, each
  gradient becomes g / ||g|| * max_norm, else it stays g. It is not
  ``torch.nn.utils.clip_grad_norm_``, which divides by ||g|| + 1e-6.
- **Freezing**: the inner ``torch.optim.Adam`` / ``AdamW`` holds only the
  trained part's parameters, so a frozen one gets no update and no weight
  decay (the trainer builds a fresh optimizer per stage).
- **The learning rate** is what ``inject_hyperparams`` stores: the schedule
  at the count of the last applied update, or at 0 before any, rounded to
  float32 as optax keeps it. ``set_learning_rate`` takes effect only where
  the rate is a constant: a schedule overwrites it at the next update.

Schedules are over optimizer steps (already divided by the accumulation) and
return Python floats; ``cosine_warmup`` is optax's piecewise
``warmup_cosine_decay_schedule``, copied.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], float]]


def _warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                         decay_steps: int, end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: a linear warmup joined at
    ``warmup_steps`` to a cosine decay over ``decay_steps - warmup_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(float(count - warmup_steps), cos_steps)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / cos_steps)) + alpha)

    return schedule


def build_schedule(name: str, base_lr: float, steps_per_epoch: int, num_epochs: int,
                   params: Optional[Dict[str, Any]] = None) -> Schedule:
    """Learning-rate schedule over OPTIMIZER steps. reduce_on_plateau is the
    constant base rate: ``PlateauController`` lowers it between epochs."""
    p = params or {}
    total_steps = max(steps_per_epoch * num_epochs, 1)
    if name in ("constant", "none", "reduce_on_plateau"):
        return base_lr
    if name == "cosine_warmup":
        warmup_steps = max(int(p.get("warmup_epochs", 1)) * steps_per_epoch, 1)
        return _warmup_cosine_decay(0.0, base_lr, warmup_steps,
                                    max(total_steps, warmup_steps + 1))
    if name == "step":
        step_size = int(p.get("step_size", 10)) * steps_per_epoch
        gamma = float(p.get("gamma", 0.1))
        return lambda count: base_lr * gamma ** (count // max(step_size, 1))
    if name == "exponential":
        # the per-epoch gamma spread over the epoch's steps
        gamma_step = float(p.get("gamma", 0.95)) ** (1.0 / max(steps_per_epoch, 1))
        return lambda count: base_lr * gamma_step ** count
    if name in ("cosine_warm_restarts", "cosine_restarts"):
        # CosineAnnealingWarmRestarts: cosine cycles of T_0 * T_mult^k epochs
        t0 = float(p.get("T_0", max(num_epochs // 3, 1))) * max(steps_per_epoch, 1)
        t_mult = float(p.get("T_mult", 2.0))
        eta_min = float(p.get("eta_min", p.get("min_lr", 0.0)))

        def restarts(count: int) -> float:
            t = float(count)
            if t_mult == 1.0:
                t_cur, t_i = math.fmod(t, t0), t0
            else:
                n = math.floor(math.log(max(t / t0 * (t_mult - 1.0) + 1.0, 1.0)) / math.log(t_mult))
                t_cur = t - t0 * (t_mult ** n - 1.0) / (t_mult - 1.0)
                t_i = t0 * t_mult ** n
            return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t_cur / t_i))

        return restarts
    raise ValueError(f"unknown scheduler {name!r}")


def _f32(x: float) -> float:
    return float(np.float32(x))


class StageOptimizer:
    """clip -> Adam/AdamW at the scheduled rate -> k-step accumulation, over
    ``trained`` parameters; the clip's norm is over the gradients of
    ``all_params``. Call ``step`` after each backward pass (one micro-step);
    it consumes and clears the gradients."""

    def __init__(self, trained: Iterable[torch.nn.Parameter],
                 all_params: Iterable[torch.nn.Parameter], name: str, schedule: Schedule,
                 weight_decay: float = 0.0, max_norm: float = 0.0, accum: int = 1):
        self.trained = list(trained)
        self.all_params = list(all_params)
        self.schedule = schedule
        self.max_norm = float(max_norm)
        self.accum = int(accum)
        self.count = 0  # applied updates
        self.mini_step = 0  # micro-steps since the last applied update
        self.lr = _f32(schedule(0) if callable(schedule) else schedule)
        trained_ids = {id(p) for p in self.trained}
        self._trained_index = [i for i, p in enumerate(self.all_params) if id(p) in trained_ids]
        self._acc: List[Optional[torch.Tensor]] = [None] * len(self.all_params)
        if name == "adamw":
            self.inner = torch.optim.AdamW(self.trained, lr=self.lr, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=weight_decay)
        elif name == "adam":
            self.inner = torch.optim.Adam(self.trained, lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        else:
            raise ValueError(f"unknown optimizer {name!r}")

    def global_norm(self, grads: List[Optional[torch.Tensor]]) -> torch.Tensor:
        """The clip's norm over the present gradients (one per ``all_params``
        entry, None where absent); a tensor-parallel step, whose parameters
        are shards, overrides it (``parallel/dryrun.py``)."""
        present = [g for g in grads if g is not None]
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(present)))

    def step(self) -> bool:
        """One micro-step; returns True where it applied an update."""
        n = self.mini_step
        both_acc, both_g = [], []
        for i, p in enumerate(self.all_params):
            # Welford's mean, acc + (g - acc) / (n + 1); a missing gradient
            # (a part outside the loss) is zero
            g, acc = p.grad, self._acc[i]
            p.grad = None
            if acc is None:
                self._acc[i] = None if g is None else (g if n == 0 else g / (n + 1))
            elif g is None:
                acc.sub_(acc / (n + 1))
            else:
                both_acc.append(acc)
                both_g.append(g)
        if both_acc:  # the same arithmetic, a few launches for every tensor at once
            delta = torch._foreach_sub(both_g, both_acc)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(both_acc, delta)
        if n + 1 < self.accum:
            self.mini_step = n + 1
            return False
        grads = self._acc
        self._acc = [None] * len(self.all_params)
        self.mini_step = 0
        if self.max_norm > 0:
            norm = self.global_norm(grads)
            keep = norm < self.max_norm
            grads = [None if g is None else torch.where(keep, g, g / norm * self.max_norm)
                     for g in grads]
        if callable(self.schedule):
            self.lr = _f32(self.schedule(self.count))
        for group in self.inner.param_groups:
            group["lr"] = self.lr
        for i in self._trained_index:
            g = grads[i]
            self.all_params[i].grad = g if g is not None else torch.zeros_like(self.all_params[i])
        self.inner.step()
        for p in self.trained:
            p.grad = None
        self.count += 1
        return True


def build_optimizer(config: Dict[str, Any], steps_per_epoch: int, num_epochs: int,
                    trained: Iterable[torch.nn.Parameter],
                    all_params: Optional[Iterable[torch.nn.Parameter]] = None) -> StageOptimizer:
    """The training section's optimizer over ``trained`` (the clip's norm
    over ``all_params``, default the trained ones)."""
    t = config["training"]
    trained = list(trained)
    schedule = build_schedule(t.get("scheduler", "constant"), float(t.get("lr", 5e-5)),
                              steps_per_epoch, num_epochs, t.get("scheduler_params"))
    return StageOptimizer(
        trained, trained if all_params is None else all_params,
        t.get("optimizer", "adam").lower(), schedule,
        weight_decay=float(t.get("weight_decay", 0.0)),
        max_norm=float(t.get("grad_clip", 0.0) or 0.0),
        accum=int(t.get("grad_accum_steps", 1)))


def stage_param_labels(top_level_names: Iterable[str], stage: int) -> Dict[str, str]:
    """'train' / 'freeze' per top-level part for the two-stage regime:
    stage 1 trains the GCAE, stage 2 freezes it and trains the transformer."""
    train_key = "gcae" if stage == 1 else "transformer"
    return {k: ("train" if k == train_key else "freeze") for k in top_level_names}


def current_learning_rate(opt: StageOptimizer) -> Optional[float]:
    """The injected learning rate (see the module docstring)."""
    return opt.lr


def set_learning_rate(opt: StageOptimizer, lr: float) -> StageOptimizer:
    """Replace the injected learning rate: the host side of reduce-on-plateau."""
    opt.lr = _f32(lr)
    return opt


class PlateauController:
    """reduce_on_plateau: scale lr by `factor` after `patience` epochs without
    improvement (reference: shopformer_2/train.py:106-113)."""

    def __init__(self, factor: float = 0.5, patience: int = 5, mode: str = "min", min_lr: float = 1e-8):
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.min_lr = min_lr
        self.best = math.inf if mode == "min" else -math.inf
        self.bad_epochs = 0

    def update(self, metric: float, lr: float) -> float:
        improved = metric < self.best if self.mode == "min" else metric > self.best
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.bad_epochs = 0
                return max(lr * self.factor, self.min_lr)
        return lr


class EarlyStopping:
    """Patience/min_delta/mode early stopping (reference: shopformer/train.py:36-65)."""

    def __init__(self, patience: int = 20, min_delta: float = 0.0, mode: str = "max"):
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False

    def __call__(self, metric: float) -> bool:
        if self.best is None:
            self.best = metric
            return False
        improved = (
            metric > self.best + self.min_delta if self.mode == "max" else metric < self.best - self.min_delta
        )
        if improved:
            self.best = metric
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop
