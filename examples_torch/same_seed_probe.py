"""Probe: do two Shopformer fits of one seed on the card agree tensor by tensor?

Runs the port's ``gpu`` tests in the order a full run takes them (the
kernels, the Shopformer trainer, the detector trainer), with the trainer
patched to keep device-side copies (no host sync) of every parameter at the
start of each fit, and of every gradient, parameter and Adam state around
its first optimizer steps. Afterwards it compares the first two fits (those
of ``test_same_seed_twice_identical_on_the_card``) record by record and
prints the first records that differ, tensor by tensor: which tensors, how
many entries, by how much.

Run on a machine with one CUDA card, from the repository root (repeat it:
a difference, where there is one, shows in some runs only):

    python examples_torch/same_seed_probe.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch

from cvsd_tpu_torch.train import loop
from cvsd_tpu_torch.train import optim

GPU_TESTS = ["tests/test_torch_kernels_gpu.py", "tests/test_torch_train_gpu.py",
             "tests/test_torch_detector_train_gpu.py"]
MAX_RECORDS = 40  # per fit: the start and the first optimizer steps


def install(fits: list) -> None:
    """Patch the trainer so each fit appends its records to ``fits``."""
    state = {"cur": None, "names": {}}
    fit, step = loop.Trainer.fit, optim.StageOptimizer.step

    def copies(pairs):
        return {state["names"].get(id(t), str(i)): t.detach().clone() for i, t in pairs}

    def patched_fit(self, *a, **k):
        state["cur"] = cur = []
        fits.append(cur)
        state["names"] = {id(p): n for n, p in self.model.named_parameters()}
        cur.append(("start", copies(enumerate(self.model.parameters()))))
        try:
            return fit(self, *a, **k)
        finally:
            state["cur"] = None

    def patched_step(self):
        cur = state["cur"]
        keep = cur is not None and len(cur) < MAX_RECORDS
        if keep:
            cur.append(("grad", copies((i, p.grad) for i, p in enumerate(self.all_params)
                                       if p.grad is not None)))
        applied = step(self)
        if keep:
            cur.append(("param", copies(enumerate(self.all_params))))
            cur.append(("adam", {f"{state['names'].get(id(p), '?')}:{k}": v.detach().clone()
                                 for p in self.trained for k, v in self.inner.state[p].items()
                                 if torch.is_tensor(v)}))
        return applied

    loop.Trainer.fit, optim.StageOptimizer.step = patched_fit, patched_step


def differences(a: dict, b: dict) -> list:
    """(name, entries that differ, largest difference) for each tensor whose bits differ."""
    out = []
    for name, x in a.items():
        x, y = x.cpu(), b[name].cpu()
        if not torch.equal(x, y):
            d = (x.double() - y.double()).abs()
            out.append((name, int((d > 0).sum()), x.numel(), float(d.max())))
    return out


def main() -> int:
    import pytest

    if not torch.cuda.is_available():
        raise SystemExit("the probe runs the trainers on a CUDA card; none is available")
    fits: list = []
    install(fits)
    rc = pytest.main(["--noconftest", "-m", "gpu", *GPU_TESTS, "-q", "-p", "no:cacheprovider"])
    print(f"pytest exit {rc}; {len(fits)} fits recorded")
    if len(fits) < 2:
        raise SystemExit("the same-seed test recorded no two fits")
    shown = 0
    for (kind, a), (_, b) in zip(fits[0], fits[1]):
        diff = differences(a, b)
        if diff:
            print(f"{kind}: {len(diff)} of {len(a)} tensors differ")
            for name, n, total, top in diff[:12]:
                print(f"    {name}: {n} of {total} entries, max |d| {top:.3g}")
            shown += 1
            if shown == 4:
                break
    print("the two fits agree in every record" if not shown else "the two fits differ")
    return 0 if not shown else 1


if __name__ == "__main__":
    sys.exit(main())
