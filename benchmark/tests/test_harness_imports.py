"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level name, and the references load nothing of the program."""

import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cvsd_tpu")

PROBE = r"""
import json, sys, os
sys.path[:0] = [{bench!r}, {root!r}]
{body}
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_names(body: str):
    code = PROBE.format(bench=BENCH, root=ROOT, body=body)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_metrics_traffic_and_program_load_no_jax():
    names = _top_names("""
from harness import cells, detect, judge, trace, traffic, weights
import flops, readings, run
from reference import detector
bench = cells.benchmark()
for m in bench["per_layer"]:
    cells.reader(m["name"])
for w in bench["workloads"]:
    cells.traffic_of(w); cells.config_of(bench, w); cells.limits_of(w)
from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline
from cvsd_tpu_torch.models.pose_topdown import build_pose_topdown
from cvsd_tpu_torch.utils.compile_cache import maybe_enable_compile_cache
""")
    assert "cvsd_tpu_torch" in names
    assert not names & set(FORBIDDEN), sorted(names & set(FORBIDDEN))


def test_reference_alone_loads_nothing_of_the_program():
    names = _top_names("from reference import detector")
    assert not names & (set(FORBIDDEN) | {"cvsd_tpu_torch", "harness"}), sorted(names)
