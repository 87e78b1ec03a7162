"""The benchmark of the PyTorch/CUDA port, one run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs as many CUDA cards as the cell asks
for, and fails without them. The last line of standard output is the run's
JSON result; the numbers compared for ``correct`` end standard error."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    from harness import cells

    cells.set_caches()
    bench = cells.benchmark()
    cell = cells.find_cell(bench, a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {a.workload} needs {cell['chips']} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    out = cells.run_cell(a.workload, a.seed, a.seconds, bool(a.trace), T_START)
    found = sorted(set(out["forbidden"]) | set(cells.forbidden_modules()))
    if found:
        print(f"error: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in out["setup_phases"].items()),
          file=sys.stderr)
    for k, v in out["readings"].items():
        if k not in out["checks"]:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result_line(out, bool(a.trace))), flush=True)
    return 0


def result_line(out: dict, trace: bool) -> dict:
    """The contract's last line: the cell's end-to-end metrics, or with
    ``trace`` its per-layer ones and the breakdown; the numbers compared,
    each with its limit, last."""
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["per_layer"] if trace else out["e2e"], "device": out["device"]}
    if trace and "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    return line


if __name__ == "__main__":
    sys.exit(main())
