"""The soak's fps slope (``examples_torch/soak_streaming.py::verdict``): the
least-squares line of the steady passes' fps over wall clock, its 95 %
interval, the slow passes and the drift rule, beside the reference's
first-against-last ``fps_drift_pct``, on scripted series."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples_torch"))

import soak_streaming  # noqa: E402


def _series(fps, wall_s=12.0):
    """A warm-up pass, then one steady pass per ``fps`` value, each
    ``wall_s`` long; the other keys as the soak writes them."""
    rows = [{"pass": 0, "fps": 20.0, "rss_mb": 900.0, "vmrss_mb": 800.0,
             "device_allocated_mb": None, "device_max_allocated_mb": None, "wall_s": 40.0}]
    for i, f in enumerate(fps, 1):
        rows.append({"pass": i, "fps": float(f), "rss_mb": 900.0, "vmrss_mb": 800.0,
                     "device_allocated_mb": None, "device_max_allocated_mb": None,
                     "wall_s": wall_s, "events_match_pass1": True})
    return rows


def test_known_slope():
    """fps falling 0.5 a 12-second pass is 25 fps per 10 minutes: -25 % of
    a mean of 100 exactly on the line (interval of width 0), and within
    the interval where +-1 fps alternates about the line; both read
    "fault"."""
    n = 41
    line = 110.0 - 0.5 * np.arange(n)  # mean 100
    v = soak_streaming.verdict(_series(line))
    assert v["fps_slope_pct_per_10min"] == pytest.approx(-25.0)
    assert v["fps_slope_ci_pct_per_10min"] == pytest.approx([-25.0, -25.0])
    assert (v["fps_slope_verdict"], v["fps_slow_passes"]) == ("fault", 0)
    assert v["fps_drift_pct"] == round(100 * (line[-1] - line[0]) / line[0], 2)
    noisy = soak_streaming.verdict(_series(line + np.where(np.arange(n) % 2, 1.0, -1.0)))
    lo, hi = noisy["fps_slope_ci_pct_per_10min"]
    assert lo < -25.0 < hi and hi < -soak_streaming.DRIFT_BAND
    assert noisy["fps_slope_verdict"] == "fault"


@pytest.mark.parametrize("where", [10, 39])
def test_one_slow_pass_moves_the_drift_not_the_slope(where):
    """A flat series (100 +- 2) with one pass at 55: at the end it makes
    the reference's drift about -45 %; anywhere it counts as the one slow
    pass, and the slope's interval still holds 0 ("noise")."""
    fps = 100.0 + 2.0 * np.where(np.arange(40) % 2, 1.0, -1.0)
    fps[where] = 55.0
    v = soak_streaming.verdict(_series(fps))
    assert v["fps_slow_passes"] == 1
    lo, hi = v["fps_slope_ci_pct_per_10min"]
    assert lo < 0.0 < hi and v["fps_slope_verdict"] == "noise"
    if where == 39:
        assert v["fps_drift_pct"] < -40.0


def test_too_few_passes_or_no_time_read_no_slope():
    """Two steady passes, or passes of no duration, give no line; the
    reference's keys are there all the same."""
    for series in (_series([100.0, 90.0]), _series([100.0, 90.0, 80.0], wall_s=0.0)):
        v = soak_streaming.verdict(series)
        assert v["fps_slope_pct_per_10min"] is None and v["fps_slope_verdict"] is None
        assert v["fps_slope_ci_pct_per_10min"] is None and "fps_drift_pct" in v
