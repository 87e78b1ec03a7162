"""Observability: scalar logging (JSONL always, TensorBoard when it is
installed), a step timer that waits for the card, and a device trace (the
port's counterpart of ``cvsd_tpu/utils/logging.py``).

``device_trace`` is ``torch.profiler`` in place of ``jax.profiler``: it
records the host and, where a card is present, its kernels, and writes a
chrome trace (``trace.json``) into the directory on exit.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch


class ScalarLogger:
    """Logs scalars to <dir>/scalars.jsonl and, where ``torch.utils.tensorboard``
    imports, to TensorBoard under <dir>/runs."""

    def __init__(self, log_dir: str, tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter  # lazy, optional

                self._tb = SummaryWriter(os.path.join(log_dir, "runs"))
            except ImportError:
                self._tb = None

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                  "t": time.time()}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def log_dict(self, scalars: Dict[str, float], step: int, prefix: str = "") -> None:
        for k, v in scalars.items():
            if isinstance(v, (int, float)):
                self.log_scalar(f"{prefix}{k}", v, step)

    def log_hparams(self, hparams: Dict[str, Any], metrics: Dict[str, float]) -> None:
        """Final hparams/metrics record (<dir>/hparams.json, and TensorBoard's)."""
        with open(os.path.join(self.log_dir, "hparams.json"), "w") as f:
            json.dump({"hparams": hparams, "metrics": metrics}, f, indent=2, default=str)
        if self._tb is not None:
            flat = {k: v for k, v in hparams.items() if isinstance(v, (int, float, str, bool))}
            self._tb.add_hparams(flat, {f"final/{k}": v for k, v in metrics.items()})

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Wall-clock step timer; ``stop`` waits for the card's queued work first
    when given a result that lies on a card."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result: Any = None) -> float:
        if isinstance(result, torch.Tensor) and result.is_cuda:
            torch.cuda.synchronize(result.device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` over the block, its chrome trace written to
    ``<log_dir>/trace.json``; a no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
