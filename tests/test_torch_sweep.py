"""The port's sweep (cvsd_tpu_torch/sweep/, cli/sweep.py) against
cvsd_tpu/sweep/ on the CPU: the generated configs in every mode, a quick
sweep of two configs, the failure capture and the per-config time bound."""

import json
import os

import pytest

from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.config import merge_configs as merge_configs_jax
from cvsd_tpu.sweep import generate_configs as generate_configs_jax
from cvsd_tpu.sweep import run_sweep as run_sweep_jax
from cvsd_tpu_torch.config import get_default_config, merge_configs
from cvsd_tpu_torch.sweep import (QUICK_SEARCH_SPACE, RECOMMENDED_CONFIGS, SEARCH_SPACE,
                                  analyze_results, generate_configs, run_sweep)
from cvsd_tpu.sweep import QUICK_SEARCH_SPACE as QUICK_SEARCH_SPACE_JAX
from cvsd_tpu.sweep import RECOMMENDED_CONFIGS as RECOMMENDED_CONFIGS_JAX
from cvsd_tpu.sweep import SEARCH_SPACE as SEARCH_SPACE_JAX

BASE = {
    "data": {"dataset": "synthetic", "batch_size": 16,
             "synthetic": {"num_train": 32, "num_test": 32}},
    "model": {"hidden_channels": 8},
    "training": {"stage1_epochs": 1, "stage2_epochs": 1},
}


@pytest.mark.parametrize("mode,kwargs", [
    ("recommended", {}),
    ("quick", {}),
    ("quick", {"base_config": BASE}),
    ("random", {"num_random": 7, "seed": 1}),
    ("grid", {"search_space": {"training.lr": [1e-4, 5e-5], "model.dropout": [0.1, 0.2, 0.3]}}),
])
def test_generate_configs_match_jax(mode, kwargs):
    assert (SEARCH_SPACE, QUICK_SEARCH_SPACE, RECOMMENDED_CONFIGS) == (
        SEARCH_SPACE_JAX, QUICK_SEARCH_SPACE_JAX, RECOMMENDED_CONFIGS_JAX)
    got, ref = generate_configs(mode, **kwargs), generate_configs_jax(mode, **kwargs)
    assert len(got) == len(ref) > 0
    assert [dict(c) for c in got] == [dict(c) for c in ref]
    with pytest.raises(ValueError, match="unknown sweep mode"):
        generate_configs("nope")


def test_run_sweep_matches_jax(tmp_path):
    """Two quick configs in each package: the same statuses, the same files
    and the same keys in analysis.json and in each result."""
    out = {}
    for name, gen, run, extra in (("jax", generate_configs_jax, run_sweep_jax, {}),
                                  ("port", generate_configs, run_sweep, {"device": "cpu"})):
        d = tmp_path / name
        results = run(gen("quick", base_config=BASE)[:2], str(d), **extra)
        with open(d / "analysis.json") as f:
            analysis = json.load(f)
        with open(d / "sweep_results.json") as f:
            assert len(json.load(f)) == 2
        out[name] = (results, analysis, sorted(os.listdir(d)))
    (ref, ref_a, ref_files), (got, got_a, got_files) = out["jax"], out["port"]
    assert [r["status"] for r in got] == [r["status"] for r in ref] == ["ok", "ok"]
    assert [sorted(r) for r in got] == [sorted(r) for r in ref]
    assert got_files == ref_files
    assert sorted(got_a) == sorted(ref_a) and got_a["num_ok"] == ref_a["num_ok"] == 2
    assert [sorted(t) for t in got_a["top"]] == [sorted(t) for t in ref_a["top"]]
    assert sorted(got_a["param_importance"]) == sorted(ref_a["param_importance"])
    assert all(0.0 <= r["best_auc"] <= 1.0 for r in got)


def test_sweep_captures_failures(tmp_path):
    """An invalid num_heads fails its config with the reference's message
    and does not abort the sweep."""
    bad = merge_configs(get_default_config(), {"model": {"num_heads": 7}})
    bad["experiment"]["name"] = "bad"
    bad_jax = merge_configs_jax(get_default_config_jax(), {"model": {"num_heads": 7}})
    bad_jax["experiment"]["name"] = "bad"
    got = run_sweep([bad], str(tmp_path / "port"), device="cpu")
    ref = run_sweep_jax([bad_jax], str(tmp_path / "jax"))
    assert got[0]["status"] == ref[0]["status"] == "failed"
    assert "divisible" in got[0]["error"] and got[0]["error"] == ref[0]["error"]


def test_sweep_per_config_timeout(tmp_path):
    """A slow config is stopped by the per-config wall-clock budget between
    epochs (training.max_seconds) without stalling the sweep."""
    slow = merge_configs(get_default_config(), {
        **BASE, "training": {"stage1_epochs": 200, "stage2_epochs": 200}})
    slow["experiment"]["name"] = "slow"
    results = run_sweep([slow], str(tmp_path / "sweep"), timeout_seconds=0.5, device="cpu")
    assert results[0]["status"] == "timeout"
    hist = json.load(open(tmp_path / "sweep" / "slow" / "training_history.json"))
    n_epochs = len(hist["stage1"]) + len(hist["stage2"])
    assert 0 < n_epochs < 400
    assert any("max_seconds" in str(r.get("aborted", "")) for s in ("stage1", "stage2")
               for r in hist[s])


def test_analyze_results_importance():
    results = [
        {"status": "ok", "name": "a", "best_auc": 0.8,
         "config": {"training": {"lr": 1e-4}, "model": {"dropout": 0.1}}},
        {"status": "ok", "name": "b", "best_auc": 0.6,
         "config": {"training": {"lr": 5e-5}, "model": {"dropout": 0.1}}},
        {"status": "failed", "name": "c", "config": {}},
    ]
    analysis = analyze_results(results)
    assert analysis["num_ok"] == 2 and analysis["num_failed"] == 1
    assert analysis["top"][0]["name"] == "a"
    assert analysis["param_importance"] == {"training.lr": {"0.0001": 0.8, "5e-05": 0.6}}


def test_sweep_cli(tmp_path, capsys):
    """``cli.sweep --mode quick --max_configs 1 --device cpu`` on a tiny base
    config prints the analysis of an ``ok`` run."""
    from cvsd_tpu_torch.cli import sweep

    sets = ["data.dataset=synthetic", "data.batch_size=16", "data.synthetic.num_train=32",
            "data.synthetic.num_test=32", "training.stage1_epochs=1", "training.stage2_epochs=1"]
    sweep.main(["--mode", "quick", "--max_configs", "1", "--output_dir", str(tmp_path),
                "--device", "cpu", *[a for s in sets for a in ("--set", s)]])
    out = capsys.readouterr().out
    analysis = json.loads(out[out.rindex("\n{") + 1:])
    assert analysis["num_ok"] == 1 and analysis["num_failed"] == 0
