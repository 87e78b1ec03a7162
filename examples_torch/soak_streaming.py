"""Streaming-pipeline soak test on the PyTorch port: sustained serving
stability over many passes; the counterpart of ``examples/soak_streaming.py``.

Production serving is a long-running process; this drives the full live path
(``pipeline/streaming.py::stream_videos_concurrent``) pass after pass for
``--minutes`` of wall clock (and at least 3 passes: a warm-up and two
steady ones) and records, per pass:

  - throughput (fps, videos/hour): steady-state drift or regression;
  - host RSS (the peak, as the reference reads it, and the current VmRSS):
    leaks in the decode ring, the prefetch or the in-flight queues;
  - the device's view: ``torch.cuda.memory_allocated`` after the pass and
    ``max_memory_allocated`` during it (null on the CPU);
  - the event count and an order-insensitive score checksum against the
    first steady pass (pass 1): nondeterminism or state bleeding from one
    pass into the next (tracker and window state must reset per video).

Writes a JSON time series and a verdict. Beside the reference's
first-against-last ``fps_drift_pct`` (one slow pass moves it), the verdict
fits a line to the steady passes' fps over wall clock: its slope in % of
the mean per 10 minutes, the slope's 95 % interval, the count of passes
below 0.8 x the median, and the rule "fault" (interval wholly below -5 %),
"noise" (it holds 0 or lies inside +-5 %) or "neither". The default configuration is the
reference's (img 128, width 0.25, float32, pose head, random seeded
weights); ``--config`` streams a configuration file instead (e.g.
``configs/streaming_production.yaml``), whose detector settings it keeps.

    python examples_torch/soak_streaming.py --minutes 30 [--device cpu]
    python examples_torch/soak_streaming.py --minutes 10 \\
        --config configs/streaming_production.yaml

Default device: the CUDA card, raising without one. Needs cv2 to write and
read the videos.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy import stats  # noqa: E402

from end_to_end_synthetic import require_cv2  # noqa: E402
from cvsd_tpu_torch.config import get_default_config, load_config  # noqa: E402
from cvsd_tpu_torch.data.render import render_pose_video  # noqa: E402
from cvsd_tpu_torch.data.synthetic import SyntheticPoseLiftDataset  # noqa: E402
from cvsd_tpu_torch.eval.evaluate import ShopformerScorer  # noqa: E402
from cvsd_tpu_torch.models.shopformer import build_shopformer  # noqa: E402
from cvsd_tpu_torch.pipeline.streaming import StreamingPipeline  # noqa: E402
from cvsd_tpu_torch.utils.device import resolve_device  # noqa: E402


DRIFT_BAND = 5.0  # % of the mean fps per 10 minutes: the fps slope's fault and noise rules


def render_videos(out: str, videos: int, frames: int) -> List[str]:
    """``videos`` rendered pose videos of ``frames`` frames (half anomalous
    motion, ``SyntheticPoseLiftDataset(seed=5)``), reused where present."""
    os.makedirs(out, exist_ok=True)
    ds = SyntheticPoseLiftDataset(videos, seq_len=frames, anomaly_ratio=0.5, seed=5)
    paths = []
    for i in range(videos):
        p = os.path.join(out, f"v{i}.mp4")
        if not os.path.exists(p):
            render_pose_video(p, ds.poses[i], seed=100 + i)
        paths.append(p)
    return paths


def soak_config(args: argparse.Namespace) -> Dict[str, Any]:
    """The reference's soak configuration, or ``--config``'s file as it is."""
    if args.config:
        return load_config(args.config)
    cfg = get_default_config()
    cfg["detector"].update(img_size=args.img, width_mult=0.25, depth_mult=0.34,
                           batch_size=args.batch, conf_threshold=0.3,
                           max_detections=4, dtype="float32", pose_head=True,
                           stream_depth=args.stream_depth,
                           host_letterbox=args.host_letterbox)
    return cfg


def build_pipeline(cfg: Dict[str, Any], device: torch.device) -> StreamingPipeline:
    """The live path with seeded random weights: the Shopformer from seed 0
    and the detector from the pipeline's seed 0."""
    scorer = ShopformerScorer(build_shopformer(cfg, device=device, seed=0), cfg, device=device)
    return StreamingPipeline(cfg, scorer, device=device)


def checksum(events) -> List[float]:
    """Order-insensitive: the scores rounded, sorted by (video, track, end)."""
    return [round(float(e.score), 5) for e in
            sorted(events, key=lambda e: (e.video, e.track_id, e.frame_end))]


def vmrss_mb() -> float:
    """The current resident set (VmRSS), MB; -1 where /proc is absent."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return -1.0


def soak(pipe: StreamingPipeline, paths: Sequence[str], max_streams: int, minutes: float,
         min_passes: int = 3) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """Stream ``paths`` pass after pass until ``minutes`` have gone by and at
    least ``min_passes`` passes (3: a warm-up and two steady passes) ran.
    Returns (one row per pass, the verdict)."""
    cuda = pipe.detection.device.type == "cuda"
    series: List[Dict[str, Any]] = []
    ref_sum = None
    deadline = time.time() + minutes * 60
    i = 0
    while time.time() < deadline or i < max(min_passes, 3):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = pipe.stream_videos_concurrent(paths, max_streams=max_streams)
        rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        row = {"pass": i, "fps": round(out["fps"], 1),
               "videos_per_hour": round(out["videos_per_hour"], 0),
               "events": len(out["events"]), "rss_mb": round(rss_mb, 1),
               "vmrss_mb": round(vmrss_mb(), 1),
               "device_allocated_mb": (round(torch.cuda.memory_allocated() / 2 ** 20, 1)
                                       if cuda else None),
               "device_max_allocated_mb": (round(torch.cuda.max_memory_allocated() / 2 ** 20, 1)
                                           if cuda else None),
               "wall_s": round(time.time() - t0, 1)}
        cs = checksum(out["events"])
        if i == 1:
            ref_sum = cs
        elif i > 1:
            row["events_match_pass1"] = bool(cs == ref_sum)
        series.append(row)
        print(json.dumps(row), flush=True)
        i += 1
    return series, verdict(series)


def _per_pass(first: Optional[float], last: Optional[float], passes: int) -> Optional[float]:
    if first is None or last is None or passes < 1:
        return None
    return round((last - first) / passes, 2)


def fps_slope(series: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The least-squares line of the steady passes' fps over wall clock
    (each pass at its midpoint, from the passes' ``wall_s``), as % of their
    mean fps per 10 minutes, with its 95 % t interval (passes taken as
    independent); the count of steady passes below 0.8 x their median; and
    the drift rule: "fault" where the interval lies wholly below
    -DRIFT_BAND, "noise" where it holds 0 or lies inside +-DRIFT_BAND,
    else "neither". None where fewer than 3 steady passes or no time
    between them."""
    ends = np.cumsum([r["wall_s"] for r in series])
    t_min = (ends - np.array([r["wall_s"] for r in series]) / 2)[1:] / 60.0
    fps = np.array([r["fps"] for r in series[1:]], np.float64)
    out = {"fps_slow_passes": int((fps < 0.8 * np.median(fps)).sum()),
           "fps_slope_pct_per_10min": None, "fps_slope_ci_pct_per_10min": None,
           "fps_slope_verdict": None}
    n = len(fps)
    sxx = float(((t_min - t_min.mean()) ** 2).sum())
    if n < 3 or sxx == 0.0 or fps.mean() == 0.0:
        return out
    slope, intercept = np.polyfit(t_min, fps, 1)
    resid = fps - (slope * t_min + intercept)
    se = float(np.sqrt((resid ** 2).sum() / (n - 2) / sxx))
    half = float(stats.t.ppf(0.975, n - 2)) * se
    scale = 1000.0 / fps.mean()  # fps a minute -> % of the mean per 10 minutes
    lo, hi = (slope - half) * scale, (slope + half) * scale
    if hi < -DRIFT_BAND:
        rule = "fault"
    elif lo <= 0.0 <= hi or (-DRIFT_BAND < lo and hi < DRIFT_BAND):
        rule = "noise"
    else:
        rule = "neither"
    return {**out, "fps_slope_pct_per_10min": float(slope * scale),
            "fps_slope_ci_pct_per_10min": [float(lo), float(hi)], "fps_slope_verdict": rule}


def verdict(series: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The reference's verdict over the steady passes (all but the first),
    with the growth a pass of the current RSS and of the device memory, and
    the fps slope over wall clock (``fps_slope``)."""
    steady = series[1:]
    fps = [r["fps"] for r in steady]
    rss = [r["rss_mb"] for r in steady]
    n = len(steady) - 1
    return {
        "passes": len(series),
        "fps_first_steady": fps[0], "fps_last": fps[-1],
        "fps_drift_pct": round(100 * (fps[-1] - fps[0]) / fps[0], 2) if fps[0] else None,
        "fps_min": min(fps), "fps_max": max(fps),
        "rss_first_steady_mb": rss[0], "rss_last_mb": rss[-1],
        "rss_growth_mb": round(rss[-1] - rss[0], 1),
        "vmrss_growth_mb_per_pass": _per_pass(steady[0]["vmrss_mb"], steady[-1]["vmrss_mb"], n),
        "device_allocated_growth_mb_per_pass": _per_pass(
            steady[0]["device_allocated_mb"], steady[-1]["device_allocated_mb"], n),
        "device_max_allocated_growth_mb_per_pass": _per_pass(
            steady[0]["device_max_allocated_mb"], steady[-1]["device_max_allocated_mb"], n),
        "all_event_sets_match": all(r.get("events_match_pass1", True) for r in steady),
        **fps_slope(series),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--min-passes", type=int, default=3,
                    help="passes to run at least, whatever --minutes says (3 or more)")
    ap.add_argument("--videos", type=int, default=32)
    ap.add_argument("--frames", type=int, default=72)
    ap.add_argument("--img", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-streams", type=int, default=8)
    ap.add_argument("--stream-depth", type=int, default=3)
    ap.add_argument("--host-letterbox", default="content")
    ap.add_argument("--config", default=None,
                    help="a configuration file to stream (its detector settings as they are) "
                         "instead of the reference's soak settings")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "soak_streaming"))
    ap.add_argument("--artifact",
                    default=os.path.join(tempfile.gettempdir(), "soak_streaming.json"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising without one)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parser().parse_args(argv)
    require_cv2()
    device = resolve_device(args.device)
    print(f"device={device}", flush=True)
    paths = render_videos(args.out, args.videos, args.frames)
    cfg = soak_config(args)
    pipe = build_pipeline(cfg, device)
    series, result = soak(pipe, paths, args.max_streams, args.minutes, args.min_passes)
    print(json.dumps(result), flush=True)
    d = cfg["detector"]
    with open(args.artifact, "w") as f:
        json.dump({"series": series, "verdict": result,
                   "config": {"videos": args.videos, "frames": args.frames,
                              "img": d.get("img_size"), "batch": d.get("batch_size"),
                              "max_streams": args.max_streams, "file": args.config,
                              "device": str(device)}}, f, indent=2)
    return {"series": series, "verdict": result}


if __name__ == "__main__":
    main()
