"""The traced span of a ``--trace 1`` run: ``torch.profiler`` over a steady
stretch of the loop, read back into device busy time, the device's
operations by name, kernel launch times and the idle gaps, each gap named
by the benchmark's host span that was open when it began.

The benchmark's host spans are ``record_function`` ranges named
``bench.<what>``; ``bench.window`` bounds the traced stretch."""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def span(name: str, on: bool):
    """A host span in the trace (a no-op when not tracing)."""
    return record_function(f"bench.{name}") if on else contextlib.nullcontext()


class Trace:
    """Start, stop, then the summary: ``busy_s``, ``window_s``, ``ops``
    {name: seconds}, ``kernels`` {name: [durations s]}, ``gaps`` [(label,
    seconds)], longest first."""

    def __init__(self):
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self.summary: Optional[Dict] = None

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> Dict:
        self._prof.stop()
        self.summary = summarize(self._prof.profiler.kineto_results.events())
        return self.summary


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(events) -> Dict:
    from torch.autograd import DeviceType

    window = None
    host: List[Tuple[int, int, str]] = []
    dev: List[Tuple[int, int, str]] = []
    for e in events:
        name = e.name()
        a, b = int(e.start_ns()), int(e.end_ns())
        if e.device_type() == DeviceType.CPU:
            if name == "bench.window":
                window = (a, b)
            elif name.startswith("bench."):
                host.append((a, b, name[6:]))
        elif (e.device_type() == DeviceType.CUDA and b > a and not e.is_user_annotation()
              and not name.startswith("bench.")):
            # kernels, copies and sets; a range named from the host (the
            # benchmark's spans, the optimizer's) is no device work
            dev.append((a, b, name))
    if window is None:
        return {"busy_s": 0.0, "window_s": 0.0, "ops": {}, "kernels": {}, "gaps": []}
    w0, w1 = window
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in dev])
    ops: Dict[str, float] = defaultdict(float)
    kernels: Dict[str, List[float]] = defaultdict(list)
    for a, b, n in dev:
        ops[n] += (b - a) * 1e-9
        kernels[n].append((b - a) * 1e-9)
    gaps = []
    prev = w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((_label(host, prev), (a - prev) * 1e-9))
        prev = max(prev, b)
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": sum(b - a for a, b in busy) * 1e-9, "window_s": (w1 - w0) * 1e-9,
            "ops": dict(ops), "kernels": dict(kernels), "gaps": gaps}


def _label(host: List[Tuple[int, int, str]], t: int) -> str:
    """The innermost host span open at ``t`` (the latest begun), or 'host'."""
    best = None
    for a, b, n in host:
        if a <= t < b and (best is None or a > best[0]):
            best = (a, n)
    return best[1] if best else "host"


def breakdown(summary: Dict, top: int = 10) -> Dict[str, List]:
    """The ``breakdown`` of the result line: the device operations that took
    most time and the longest idle gaps, by host span (seconds)."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in summary["gaps"][:top]]}


def kernel_times(summary: Optional[Dict], needle: str) -> List[float]:
    """Device durations (s) of the kernels whose name holds ``needle``."""
    if not summary:
        return []
    return [t for n, ts in summary["kernels"].items() if needle in n for t in ts]
