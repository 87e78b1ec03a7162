"""Readings for setting a cell's limits: the program's comparison numbers
on many seeds and the control's (the reference in float8 in the
program's place) on a few, at the cell's own size, in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 7 8 9

on the card. Each program seed runs the cell with a window of WINDOW_S
seconds (the comparison judges the same number of batches at any length);
each seed prints one JSON line: the readings, the run's end-to-end
numbers, and which side it is."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
WINDOW_S = 3.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    a = p.parse_args(argv)
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    from harness import cells

    cells.set_caches()
    for seed in a.seeds:
        out = cells.run_cell(a.workload, seed, WINDOW_S, False, time.perf_counter())
        print(json.dumps({"side": "program", "seed": seed,
                          "readings": out["readings"],
                          "e2e": {k: m["value"] for k, m in out["e2e"].items()}}), flush=True)
    for seed in a.control_seeds:
        print(json.dumps({"side": "control", "seed": seed,
                          "readings": cells.control_readings(a.workload, seed)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
