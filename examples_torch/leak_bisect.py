"""Bisect a streaming soak's host RSS growth on the PyTorch port; the
counterpart of ``examples/leak_bisect.py`` (whose JAX soak grew +83 MB a
pass).

Runs a few passes of ``stream_videos_concurrent`` and records, per pass:
  - VmRSS from /proc/self/status (the soak's leaking metric);
  - tracemalloc's current bytes (Python-owned allocations only);
  - ``live_arrays``: the live tensors on the pipeline's device that ``gc``
    finds (device-owned buffers), beside ``torch.cuda.memory_allocated``
    (null on the CPU);
  - the gc object count;
plus a tracemalloc top-10 diff between the first steady pass and the last.

Reading it: an RSS slope with flat tracemalloc and flat live tensors points
at C/C++ allocations (the native decoder, cv2, the CUDA runtime); a
matching tracemalloc slope names the Python line; a live-tensor or
device-memory slope names leaked device buffers.

    python examples_torch/leak_bisect.py --passes 6 [--native-decode off]
        [--max-streams 8] [--videos 8] [--malloc-trim] [--device cpu]

Default device: the CUDA card, raising without one. ``--native-decode on``
raises where the native decoder cannot be built (no opencv4 development
files); ``auto`` uses it where it builds. Needs cv2.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import tracemalloc
import warnings
from typing import Any, Dict, List, Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from cvsd_tpu_torch.config import get_default_config  # noqa: E402
from cvsd_tpu_torch.pipeline.streaming import StreamingPipeline  # noqa: E402
from cvsd_tpu_torch.utils.device import resolve_device  # noqa: E402
from cvsd_tpu_torch.utils.hostmem import malloc_trim  # noqa: E402
from soak_streaming import build_pipeline, render_videos, require_cv2, vmrss_mb  # noqa: E402


def bisect_config(args: argparse.Namespace) -> Dict[str, Any]:
    """The reference's configuration; ``--native-decode on|off`` sets
    ``detector.native_decode`` (``auto`` leaves it unset)."""
    cfg = get_default_config()
    cfg["detector"].update(img_size=args.img, width_mult=0.25, depth_mult=0.34,
                           batch_size=args.batch, conf_threshold=0.3,
                           max_detections=4, dtype="float32", pose_head=True,
                           host_letterbox=args.host_letterbox)
    if args.native_decode != "auto":
        cfg["detector"]["native_decode"] = args.native_decode == "on"
    return cfg


def live_tensors(device: torch.device) -> int:
    """The tensors on ``device``'s type that the garbage collector tracks.
    Whether a type is a tensor type is decided once per type: ``isinstance``
    against ``torch.Tensor`` goes through its metaclass, seconds over a
    process's million objects."""
    n = 0
    is_tensor = {}
    with warnings.catch_warnings():  # a deprecated module's attribute warns when read
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            t = type(obj)
            tensor = is_tensor.get(t)
            if tensor is None:
                tensor = is_tensor[t] = issubclass(t, torch.Tensor)
            try:
                if tensor and obj.device.type == device.type:
                    n += 1
            except ReferenceError:  # a weak proxy whose referent is gone
                continue
    return n


def bisect(pipe: StreamingPipeline, paths: Sequence[str], passes: int, max_streams: int,
           trim: bool = False) -> Dict[str, Any]:
    """``passes`` passes with the readings above; returns the rows, the
    top-10 tracemalloc growth and the slopes a pass (from pass 1 on)."""
    device = pipe.detection.device
    cuda = device.type == "cuda"
    started = not tracemalloc.is_tracing()
    if started:
        # one frame a trace: the readings and the by-line growth below use
        # the allocating line alone, and deeper tracebacks multiply the
        # snapshots' cost
        tracemalloc.start(1)
    series: List[Dict[str, Any]] = []
    snap_base = None
    top: List[str] = []
    try:
        for p in range(passes):
            res = pipe.stream_videos_concurrent(paths, max_streams=max_streams)
            gc.collect()
            if trim:
                malloc_trim()
            cur, _peak = tracemalloc.get_traced_memory()
            row = {"pass": p, "rss_mb": round(vmrss_mb(), 1),
                   "tracemalloc_mb": round(cur / 1e6, 2),
                   "live_arrays": live_tensors(device),
                   "device_allocated_mb": (round(torch.cuda.memory_allocated() / 2 ** 20, 2)
                                           if cuda else None),
                   "gc_objects": len(gc.get_objects()),
                   "events": len(res["events"])}
            series.append(row)
            print(json.dumps(row), flush=True)
            if p == 1:
                snap_base = tracemalloc.take_snapshot()
        if snap_base is not None and passes > 2:
            top = [str(s) for s in
                   tracemalloc.take_snapshot().compare_to(snap_base, "lineno")[:10]]
    finally:
        if started:
            tracemalloc.stop()
    slopes = None
    if len(series) > 2:
        n = len(series) - 2

        def per_pass(key):
            a, b = series[1][key], series[-1][key]
            return None if a is None else round((b - a) / n, 2)

        slopes = {"rss_mb_per_pass": per_pass("rss_mb"),
                  "tracemalloc_mb_per_pass": per_pass("tracemalloc_mb"),
                  "live_arrays_per_pass": per_pass("live_arrays"),
                  "device_allocated_mb_per_pass": per_pass("device_allocated_mb")}
    return {"series": series, "top": top, "slopes": slopes}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--passes", type=int, default=6)
    ap.add_argument("--videos", type=int, default=8)
    ap.add_argument("--frames", type=int, default=72)
    ap.add_argument("--img", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-streams", type=int, default=8)
    ap.add_argument("--native-decode", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--malloc-trim", action="store_true",
                    help="call glibc malloc_trim(0) before each RSS read: if RSS flattens, "
                         "the growth is free-but-unreturned arena memory (fragmentation), "
                         "not a live leak")
    ap.add_argument("--host-letterbox", default="content")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "leak_bisect"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising without one)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parser().parse_args(argv)
    require_cv2()
    device = resolve_device(args.device)
    print(f"device={device} native={args.native_decode}", flush=True)
    paths = render_videos(args.out, args.videos, args.frames)
    pipe = build_pipeline(bisect_config(args), device)
    out = bisect(pipe, paths, args.passes, args.max_streams, trim=args.malloc_trim)
    if out["top"]:
        print("tracemalloc top-10 growth since pass 1:")
        for line in out["top"]:
            print("  ", line, flush=True)
    if out["slopes"] is not None:
        print(json.dumps({**out["slopes"], "native": args.native_decode}))
    return out


if __name__ == "__main__":
    main()
