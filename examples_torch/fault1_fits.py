"""Fit the Shopformer once on an extracted PoseLift dataset, by one of two
recipes, and print the fit's AUCs: the spread of fits on ONE extraction.

The extracted-pose sweep (``sweep_extracted.py``) and the synthetic example
(``end_to_end_synthetic.py``) fit the same recipe (hidden 32, 4 tokens, lr
1e-3, 100 + 100 epochs, ``scan_epoch``, ``cosine_warmup``, batch 64, stride
6) through their own functions and differ in the seed only: the sweep's
``fit_one`` seeds experiment ``1000 + s``, the example's ``train_scorer``
keeps the configuration's experiment seed (42). This script runs either
function on a PoseLift directory, one fit a process, so fits of both
recipes on one extraction can be compared as one distribution.

    python examples_torch/fault1_fits.py --poselift DIR/PoseLift_256 \\
        --out OUT --fit tok4:3        # the sweep's fit_one, seed 3
    python examples_torch/fault1_fits.py --poselift DIR/PoseLift_256 \\
        --out OUT --fit example       # the example's train_scorer

Prints one ``fit {...}`` JSON line. Default device: the CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import end_to_end_synthetic as example  # noqa: E402
import sweep_extracted as sweep  # noqa: E402
from cvsd_tpu_torch.utils.device import resolve_device  # noqa: E402

EXAMPLE_EPOCHS = 100  # the example's default --epochs


def run_fit(fit: str, poselift_dir: str, out: str, device) -> Dict[str, Any]:
    """One fit: ``example`` (the example's ``train_scorer``) or
    ``CONFIG:SEED`` (the sweep's ``fit_one``)."""
    t0 = time.time()
    if fit == "example":
        cfg = example.detection_config(128)
        trainer, artifact = example.train_scorer(cfg, poselift_dir, EXAMPLE_EPOCHS,
                                                 os.path.join(out, "example"), device)
        vm = artifact.get("video_metrics") or {}
        auc, vauc = artifact["test_metrics"]["auc_roc"], vm.get("mean", {}).get("auc_roc")
        seed = cfg["experiment"]["seed"]
    else:
        name, s = fit.split(":")
        overrides = dict(sweep.CONFIGS)[name]
        auc, vauc = sweep.fit_one(name, overrides, int(s), poselift_dir, out, str(device))
        seed = 1000 + int(s)
    return {"fit": fit, "experiment_seed": seed, "window_auc": auc,
            "video_auc_mean": vauc, "poselift": poselift_dir,
            "seconds": time.time() - t0}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--poselift", required=True, help="an extracted PoseLift directory")
    p.add_argument("--out", required=True)
    p.add_argument("--fit", required=True, help="'example' or CONFIG:SEED (e.g. tok4:3)")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    record = run_fit(args.fit, args.poselift, args.out, resolve_device(args.device))
    print("fit " + json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
