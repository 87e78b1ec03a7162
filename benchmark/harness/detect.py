"""The detection cells: ``DetectionPipeline`` driven as ``run_stream``
drives it, a closed loop over a pool of recorded frames.

Set-up builds the pipeline from the seed's weights and warms up the
cell's one batch shape. The window then keeps ``stream_depth + fetch_group
- 1`` batches in flight through ``detect_frames_async`` (each batch
uploaded from host memory and letterboxed on the card) and fetches the
oldest ``fetch_group`` together with ``fetch_detections_group``, until
``seconds`` have passed. A batch counts where its outputs reached the host
inside the window, which ends at the last such fetch (so the rate is not
rounded to whole fetch groups); its latency runs from its dispatch call to
its fetch's return. A sample of the window's batches, drawn from the seed, is judged
against the float32 reference once the window has closed."""

from __future__ import annotations

import gc
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import judge as J
from harness import trace as T
from harness import traffic as TR
from harness.weights import calibrated
from reference import detector as R


def build_pipeline(det: Dict, traffic: Dict, seed: int, device) -> Dict:
    """The pool, the weights and the program's pipeline; ``phases`` holds
    the seconds each took."""
    t = [time.perf_counter()]
    from cvsd_tpu_torch.models.pose_topdown import build_pose_topdown
    from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline

    t.append(time.perf_counter())
    pool = TR.detect_pool(traffic, seed, device)
    t.append(time.perf_counter())
    calib = torch.from_numpy(pool[0, :min(32, pool.shape[1])]).to(device)
    det_params, pose_params = calibrated(det, seed, calib, getattr(torch, det["dtype"]))
    _sync(device)
    t.append(time.perf_counter())
    cfg = {"detector": dict(det, batch_size=int(traffic["batch"]))}
    pose = (build_pose_topdown(cfg, device, state_dict=pose_params)
            if pose_params is not None else None)
    pipe = DetectionPipeline(cfg, state_dict=det_params, seed=seed, device=device,
                             pose_model=pose)
    t.append(time.perf_counter())
    phases = dict(zip(("import", "frames", "weights", "pipeline"), np.diff(t).tolist()))
    return {"pool": pool, "det_params": det_params, "pose_params": pose_params, "pipe": pipe,
            "det": det, "traffic": traffic, "seed": seed, "device": device, "phases": phases}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_loop(st: Dict, seconds: float = 0.0, batches: int = 0, trace: Optional[T.Trace] = None,
             trace_batches: int = 0, keep: int = 0) -> Dict:
    """Run the closed loop over ``batches`` batches, or for a window of
    ``seconds``. Returns the window's counts, each counted batch's latency,
    the dispatch times and a sample of ``keep`` counted batches, drawn from
    the seed, as (pool index, outputs). With ``trace``, the profiler runs
    from the window's middle until ``trace_batches`` more have been fetched,
    and ``untraced`` holds the counts of the window's first half."""
    pipe, pool = st["pipe"], st["pool"]
    ahead = pipe.stream_depth + pipe.fetch_group - 1
    offer = TR.reservoir_keep(TR.seed_rng(st["seed"], 1), keep)
    kept: List = [None] * keep
    inflight: deque = deque()
    lat: List[float] = []
    dispatch: List[float] = []
    frames = done = sent = valid_boxes = 0
    trace_to = None
    window_span = None
    pre = None
    t0 = time.perf_counter()
    end = t0 + seconds
    last = t0
    while True:
        while len(inflight) < ahead and (sent < batches if batches else
                                         time.perf_counter() < end):
            if trace is not None and trace_to is None and time.perf_counter() >= t0 + seconds / 2:
                pre = {"frames": frames, "valid_boxes": valid_boxes, "window_s": last - t0}
                trace.start()
                window_span = T.span("window", True)
                window_span.__enter__()
                trace_to = sent + trace_batches
            ta = time.perf_counter()
            with T.span("dispatch", window_span is not None):
                out = pipe.detect_frames_async(pool[sent % pool.shape[0]])
            dispatch.append(time.perf_counter() - ta)
            inflight.append((ta, sent % pool.shape[0], sent, out))
            sent += 1
        if not inflight:
            break
        g = [inflight.popleft() for _ in range(min(pipe.fetch_group, len(inflight)))]
        with T.span("fetch", window_span is not None):
            host = pipe.fetch_detections_group([x[3] for x in g])
        tc = time.perf_counter()
        if batches or tc <= end:
            last = tc
            for (ta, i, _n, _), outs in zip(g, host):
                lat.append(tc - ta)
                frames += outs[0].shape[0]
                valid_boxes += int(outs[3].sum())
                done += 1
                slot = offer()
                if slot >= 0:
                    kept[slot] = (i, outs)
        if window_span is not None and g[-1][2] >= trace_to - 1:
            window_span.__exit__(None, None, None)
            window_span = None
            trace.stop()
    if window_span is not None:
        window_span.__exit__(None, None, None)
        trace.stop()
    return {"window_s": max(last - t0, 1e-9), "batch": pool.shape[1],
            "batches": done, "frames": frames, "latency_s": lat,
            "dispatch_s": dispatch, "valid_boxes": valid_boxes,
            "kept": [k for k in kept if k is not None], "untraced": pre}


def warmup(st: Dict) -> None:
    t = time.perf_counter()
    run_loop(st, batches=int(st["traffic"].get("warmup_batches", 12)))
    _sync(st["device"])
    st["phases"]["warmup"] = time.perf_counter() - t


@torch.no_grad()
def judge_kept(st: Dict, kept: List, fp8: bool = False, block: int = 32) -> Dict[str, float]:
    """Readings of the kept batches against the reference. With ``fp8``
    the reference in float8 takes the program's place (the control)."""
    R.float32_math()
    det, device = st["det"], st["device"]
    ctx = R.Ctx(st["det_params"])
    pose_ctx = R.Ctx(st["pose_params"]) if st["pose_params"] is not None else None
    readings = []
    for i, outs in kept:
        frames = st["pool"][i]
        H, W = frames.shape[1:3]
        for s in range(0, frames.shape[0], block):
            f = torch.from_numpy(frames[s:s + block]).to(device)
            ref = R.detect(ctx, det, f)
            if fp8:
                ctl = R.detect(R.Ctx(st["det_params"], fp8=True), det, f,
                               R.Ctx(st["pose_params"], fp8=True) if pose_ctx else None)
                prog = [ctl["boxes"], ctl["xywhn"], ctl["scores"], ctl["valid"]]
                if ctl["kpts"] is not None:
                    prog.append(ctl["kpts"])
            else:
                prog = [torch.from_numpy(np.ascontiguousarray(o[s:s + block])).to(device)
                        for o in outs]
            readings.append(J.judge_block(det, ref, prog, (H, W), pose_ctx))
    return J.merge(readings)


def release(st: Dict) -> None:
    """Free the program's pipeline before the reference runs."""
    st["pipe"] = None
    gc.collect()
    if torch.device(st["device"]).type == "cuda":
        torch.cuda.empty_cache()


def end_to_end(res: Dict) -> Dict[str, float]:
    lat = np.asarray(res["latency_s"], dtype=np.float64)
    return {"detect_fps": res["frames"] / res["window_s"],
            "detect_p95_ms": float(np.percentile(lat, 95)) * 1e3 if lat.size else float("nan")}


# -- the kind's interface (``harness/cells.py``) -------------------------------


def build(cfg: Dict, traffic: Dict, seed: int, device) -> Dict:
    return build_pipeline(cfg["detector"], traffic, seed, device)


def loop(st: Dict, seconds: float, trace: Optional[T.Trace]) -> Dict:
    traffic = st["traffic"]
    return run_loop(st, seconds=seconds, trace=trace, trace_batches=int(traffic["trace_batches"]),
                    keep=int(traffic["judge_batches"]))


def judge(st: Dict, rec: Dict) -> Dict[str, float]:
    return judge_kept(st, rec["kept"])


def counts(rec: Dict):
    return rec["batches"] * int(rec["batch"]), 0


def context(st: Dict, rec: Dict) -> Dict:
    return {"kind": "detect", "det": st["det"], "traffic": st["traffic"], "run": rec}


def control(cfg: Dict, traffic: Dict, seed: int, device) -> Dict[str, float]:
    """The reference in float8 in the program's place, on as many pool
    batches as a run judges, drawn from the seed."""
    st = build_pipeline(cfg["detector"], traffic, seed, device)
    release(st)
    idx = TR.seed_rng(seed, 1).choice(int(traffic["pool_batches"]),
                                      int(traffic["judge_batches"]), replace=False)
    return judge_kept(st, [(int(i), None) for i in idx], fp8=True)
