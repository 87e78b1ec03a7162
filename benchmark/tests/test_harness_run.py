"""``run.py`` refuses to run without a card, and the result line holds
only the contract's keys."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import tiny
from harness import cells

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CONTRACT = {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "v5m-pose-detect-b128", "--seed", str(2 ** 33), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_exits_nonzero_without_a_card_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert "CUDA card" in out.stderr
    assert not out.stdout.strip()


def test_exits_nonzero_with_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_only_the_contracts_keys(trace):
    import run

    bench, cfg, traffic = tiny("v5m-pose-detect-b128")
    out = cells.run_cell("v5m-pose-detect-b128", 2 ** 33 + 1, 3.0, trace, time.perf_counter(),
                         device="cpu", config=cfg, traffic=traffic)
    line = json.loads(json.dumps(run.result_line(out, trace)))
    assert set(line) <= CONTRACT and set(line) >= CONTRACT - {"breakdown"}
    assert list(line)[-1] == "checks"
    want = cells.metrics_for(bench, cells.find_cell(bench, "v5m-pose-detect-b128"),
                             "per_layer" if trace else "end_to_end")
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in want}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
