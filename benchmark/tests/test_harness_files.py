"""A cell, a configuration, a traffic mix, a per-layer metric and a kind
of traffic are added as files and entries only, and found by name."""

import json
import os
import shutil
import subprocess
import sys

from harness import cells

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_new_cell_is_found_by_name_from_files_alone(tmp_path):
    root = tmp_path / "checkout"
    bench_dir = root / "benchmark"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    cfg = json.load(open(bench_dir / "configs" / "v5m-pose.json"))
    cfg["detector"]["max_detections"] = 64
    (bench_dir / "configs" / "v5m-pose-m64.json").write_text(json.dumps(cfg))
    traffic = json.load(open(bench_dir / "traffic" / "detect-240p-b32.json"))
    (bench_dir / "traffic" / "detect-720p-b8.json").write_text(
        json.dumps(dict(traffic, frame_h=720, frame_w=1280, batch=8)))
    (bench_dir / "metrics" / "frames_total.detect.py").write_text(
        "def read(ctx):\n    return float(ctx['run']['frames'])\n")
    (bench_dir / "limits" / "v5m-pose-m64-detect-720p.json").write_text(
        json.dumps({"limits": {"box_gap": {"limit": 0.5}}}))
    bench["configs"].append({"name": "v5m-pose-m64", "source": "x", "file":
                             "benchmark/configs/v5m-pose-m64.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "v5m-pose-m64-detect-720p", "config": "v5m-pose-m64",
                               "traffic": "detect-720p-b8", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames_total.detect", "unit": "frames",
                               "better": "higher", "source": "host_clock", "layer": "device",
                               "moves": "detect_fps", "workloads": ["v5m-pose-m64-detect-720p"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    got = cells.benchmark(str(root))
    cell = cells.find_cell(got, "v5m-pose-m64-detect-720p")
    assert cells.config_of(got, cell, str(root))["detector"]["max_detections"] == 64
    assert cells.traffic_of(cell, str(bench_dir))["frame_w"] == 1280
    assert cells.limits_of(cell, str(bench_dir)) == {"box_gap": 0.5}
    names = [m["name"] for m in cells.metrics_for(got, cell, "per_layer")]
    assert "frames_total.detect" in names and "nms_fixpoint_roofline" not in names
    read = cells.reader("frames_total.detect", str(bench_dir))
    assert read({"run": {"frames": 12}}) == 12.0
    # the cells already there are unchanged
    old = cells.find_cell(got, "v5m-pose-detect-b128")
    assert cells.traffic_of(old, str(bench_dir))["batch"] == 128


ECHO_KIND = '''"""A kind of traffic for the test: counts items on the host."""
import time


def build(cfg, traffic, seed, device):
    return {"phases": {"build": 0.0}, "n": int(traffic["items"]) * int(cfg["scale"])}


def warmup(st):
    pass


def loop(st, seconds, trace):
    t0, done = time.perf_counter(), 0
    while done < st["n"]:
        done += 1
    return {"done": done, "window_s": max(time.perf_counter() - t0, 1e-9)}


def release(st):
    pass


def judge(st, rec):
    return {"missing": float(st["n"] - rec["done"])}


def end_to_end(rec):
    return {"items_per_s": rec["done"] / rec["window_s"]}


def counts(rec):
    return rec["done"], 0


def context(st, rec):
    return {"kind": "echo", "run": rec}


def control(cfg, traffic, seed, device):
    return {"missing": 1.0}
'''

RUN_NEW_CELL = """
import json, sys, time
sys.path[:0] = ["benchmark", "."]
from harness import cells
out = cells.run_cell("echo-count", 3, 0.1, False, time.perf_counter(), device="cpu")
print(json.dumps({k: out[k] for k in ("correct", "attempted", "e2e", "per_layer", "checks")}))
"""


def test_new_kind_of_traffic_runs_from_files_alone(tmp_path):
    # a kind of traffic, its mix, a configuration, a metric, limits and a
    # cell, all new files and entries, run end to end in a copy of the checkout
    root = tmp_path / "checkout"
    bench_dir = root / "benchmark"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    (bench_dir / "harness" / "echo.py").write_text(ECHO_KIND)
    (bench_dir / "traffic" / "echo-small.json").write_text(json.dumps({"kind": "echo",
                                                                       "items": 1000}))
    (bench_dir / "configs" / "echo.json").write_text(json.dumps({"scale": 2}))
    (bench_dir / "metrics" / "items_total.echo.py").write_text(
        "def read(ctx):\n    return float(ctx['run']['done']) if ctx['kind'] == 'echo' else None\n")
    (bench_dir / "limits" / "echo-count.json").write_text(
        json.dumps({"limits": {"missing": {"limit": 0}}}))
    bench["configs"].append({"name": "echo", "source": "x", "file": "benchmark/configs/echo.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "echo-count", "config": "echo", "traffic": "echo-small",
                               "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "items_per_s", "unit": "items/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["echo-count"]})
    bench["per_layer"].append({"name": "items_total.echo", "unit": "items", "better": "higher",
                               "source": "host_clock", "layer": "host", "moves": "items_per_s",
                               "workloads": ["echo-count"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert cells.kind("echo", str(bench_dir)).counts({"done": 4}) == (4, 0)
    got = subprocess.run([sys.executable, "-c", RUN_NEW_CELL], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["attempted"] == 2000
    assert set(out["e2e"]) == {"items_per_s", "setup_s"}
    assert out["per_layer"] == {"items_total.echo": {"value": 2000.0, "unit": "items"}}
    assert out["checks"] == {"missing": {"value": 0.0, "limit": 0.0}}
