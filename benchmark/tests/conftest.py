"""The benchmark's tests. CPU tests run the harness at tiny sizes; tests
marked ``gpu`` need the card and decide so in a fixture:

    python -m pytest benchmark/tests -q            # here, the gpu ones skip
    python -m pytest benchmark/tests -q -m gpu     # on the card
"""

import copy
import os
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (BENCH, os.path.dirname(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a cap that every tiny frame fills, as every frame fills the cells' own
TINY = {"img_size": 128, "width_mult": 0.25, "depth_mult": 0.34, "max_detections": 32}
TINY_POSE = {"num_keypoints": 17, "width": 8, "crop_size": 32}
TINY_TRAFFIC = {"detect": {"frame_h": 60, "frame_w": 80, "batch": 4, "pool_batches": 3,
                           "warmup_batches": 2, "judge_batches": 2, "trace_batches": 3}}


def tiny(name: str):
    """(bench, config, traffic) of the cell ``name``, cut to a CPU test's size."""
    from harness import cells

    bench = cells.benchmark()
    cell = cells.find_cell(bench, name)
    cfg = copy.deepcopy(cells.config_of(bench, cell))
    cfg["detector"].update(TINY)
    if "pose_topdown" in cfg["detector"]:
        cfg["detector"]["pose_topdown"] = dict(TINY_POSE)
    mix = cells.traffic_of(cell)
    mix = dict(mix, **TINY_TRAFFIC[mix["kind"]])
    return bench, cfg, mix


@pytest.fixture
def cuda():
    # decided here, not at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
