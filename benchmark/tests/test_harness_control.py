"""The control, the reference one precision below the configuration's put
in the program's place, reads far above the program; on the card, at the
cell's own size, the program's run is correct and the control is not."""

import time

import pytest

from conftest import tiny
from harness import cells
from harness import judge as J

CELLS = ["v5m-pose-detect-b128", "yolov5mu-topdown-detect-b32"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_far_above_the_program_at_a_small_size(cell):
    _, cfg, traffic = tiny(cell)
    prog = cells.run_cell(cell, 2 ** 33 + 7, 3.0, False, time.perf_counter(), device="cpu",
                          config=cfg, traffic=traffic)["readings"]
    ctl = cells.control_readings(cell, 2 ** 33 + 7, "cpu", cfg, traffic)
    compared = cells.limits_of(cells.find_cell(cells.benchmark(), cell))
    assert max(ctl[k] / max(prog[k], 1e-12) for k in compared) >= 3.0, (prog, ctl)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_program_is_correct_and_control_is_not(cell, cuda):
    out = cells.run_cell(cell, 2 ** 33 + 9, 3.0, False, time.perf_counter(), device=cuda)
    assert out["correct"], out["checks"]
    limits = cells.limits_of(cells.find_cell(cells.benchmark(), cell))
    ctl = cells.control_readings(cell, 2 ** 33 + 9, cuda)
    checks = J.verdict({k: ctl[k] for k in limits}, limits)
    assert not J.passed(checks), checks
