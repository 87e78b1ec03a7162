"""One run of one cell, found by name: ``BENCHMARK.json``'s entry names a
configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``), whose ``kind`` names the module that drives it
(``harness/<kind>.py``); the per-layer metrics are readers of their own
(``metrics/<name>.py``), and each cell's limits for ``correct`` are
``limits/<cell>.json``. A new cell, configuration, mix, metric or kind of
traffic is new files and entries only.

A kind's module has ``build(cfg, traffic, seed, device)`` (the state, with
the seconds of each step under ``phases``), ``warmup(state)``,
``loop(state, seconds, trace)`` (the window's record), ``release(state)``
(frees the program before the reference runs), ``judge(state, record)``
(the readings compared with the limits), ``end_to_end(record)``,
``counts(record)`` (attempted, failed), ``context(state, record)`` (what
the metric readers read) and ``control(cfg, traffic, seed, device)`` (the
control's readings)."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cvsd_tpu")


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(root, "BENCHMARK.json")


def find_cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config_of(bench: Dict, cell: Dict, root: str = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == cell["config"]:
            return load_json(root, c["file"])
    raise SystemExit(f"no configuration named {cell['config']!r}")


def traffic_of(cell: Dict, bench_dir: str = BENCH) -> Dict:
    return load_json(bench_dir, "traffic", f"{cell['traffic']}.json")


def limits_of(cell: Dict, bench_dir: str = BENCH) -> Dict[str, float]:
    path = os.path.join(bench_dir, "limits", f"{cell['name']}.json")
    if not os.path.exists(path):
        return {}
    return {k: float(v["limit"]) for k, v in load_json(path)["limits"].items()}


def metrics_for(bench: Dict, cell: Dict, section: str) -> List[Dict]:
    """The cell's metrics of ``section`` ('end_to_end' or 'per_layer')."""
    return [m for m in bench[section]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(name: str, bench_dir: str = BENCH) -> Callable[[Dict], Optional[float]]:
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def device_info(chips: int) -> Dict:
    from flops import card

    c = card()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips))),
            "power_limit": c["power_limit"]}


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(BENCH, "_build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ["CVSD_COMPILE_CACHE_DIR"] = os.path.join(build, "kernels")
    os.environ.setdefault("USE_FLAX", "0")


def kind(name: str, bench_dir: str = BENCH):
    """``harness/<name>.py``: the module that drives a mix of kind ``name``."""
    path = os.path.join(bench_dir, "harness", f"{name}.py")
    if not os.path.isfile(path):
        raise SystemExit(f"no module for traffic kind {name!r}: {path}")
    if os.path.samefile(bench_dir, BENCH):
        return importlib.import_module(f"harness.{name}")
    spec = importlib.util.spec_from_file_location(f"bench_kind_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", config: Optional[Dict] = None,
             traffic: Optional[Dict] = None) -> Dict:
    """One run: set-up, warm-up, the window, the readings, the comparison.
    Returns {e2e, per_layer, checks, correct, attempted, failed, breakdown,
    device, forbidden, readings, setup_phases}; ``device`` is None off the
    card. ``config`` and ``traffic`` stand in for the cell's files (the CPU
    tests' small sizes)."""
    from harness import judge as J
    from harness import trace as T

    bench = benchmark()
    cell = find_cell(bench, name)
    cfg = config or config_of(bench, cell)
    traffic = traffic or traffic_of(cell)
    K = kind(traffic["kind"])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from cvsd_tpu_torch.utils.compile_cache import maybe_enable_compile_cache
        set_caches()
        maybe_enable_compile_cache(os.environ["CVSD_COMPILE_CACHE_DIR"])
    t_build = time.perf_counter()
    st = K.build(cfg, traffic, seed, device)
    K.warmup(st)
    phases = dict(st["phases"], start=t_build - t_start)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    tr = T.Trace() if trace else None
    rec = K.loop(st, seconds, tr)
    if on_card:
        torch.cuda.synchronize()
    dev_info = device_info(int(cell["chips"])) if on_card else None
    found = forbidden_modules()
    K.release(st)
    readings = K.judge(st, rec)
    e2e = dict(K.end_to_end(rec), setup_s=setup_s)
    ctx = dict(K.context(st, rec), trace=tr.summary if tr else None)
    attempted, failed = K.counts(rec)
    limits = limits_of(cell)
    compared = {k: readings.get(k, float("nan")) for k in limits} if limits else readings
    checks = J.verdict(compared, limits)
    per_layer = {}
    for m in metrics_for(bench, cell, "per_layer"):
        v = reader(m["name"])(ctx)
        if v is not None:
            per_layer[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": J.passed(checks), "attempted": attempted, "failed": failed,
           "e2e": {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in metrics_for(bench, cell, "end_to_end")},
           "per_layer": per_layer, "checks": checks, "device": dev_info,
           "forbidden": found, "readings": readings, "setup_phases": phases}
    if tr is not None and tr.summary is not None:
        out["breakdown"] = T.breakdown(tr.summary)
        if dev_info is not None:
            dev_info["busy_s"] = tr.summary["busy_s"]
            dev_info["window_s"] = tr.summary["window_s"]
    return out


def control_readings(name: str, seed: int, device: str = "cuda",
                     config: Optional[Dict] = None, traffic: Optional[Dict] = None) -> Dict:
    """The control's readings: the reference computed one precision below
    the configuration's in the program's place, at the cell's own size."""
    bench = benchmark()
    cell = find_cell(bench, name)
    cfg = config or config_of(bench, cell)
    traffic = traffic or traffic_of(cell)
    return kind(traffic["kind"]).control(cfg, traffic, seed, device)
