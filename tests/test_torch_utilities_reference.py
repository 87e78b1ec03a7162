"""The port's soak, leak bisect and sweep against the reference scripts'
own logic: ``examples/soak_streaming.py``, ``examples/leak_bisect.py`` and
``examples/sweep_extracted.py`` are loaded by path and their ``main`` runs
beside the port's on one scripted series (a fake pipeline, RSS, tracemalloc
and live-buffer readings) or with one recording trainer, so the rows,
checksums, verdicts, slopes, fit configurations and written JSON are the
reference's own. Then one tiny fit of the sweep's configuration in both
packages from one initial checkpoint."""

import collections
import copy
import importlib.util
import json
import os
import pickle
import resource
import sys
import tracemalloc
import types

import jax
import numpy as np
import pytest
import torch

import cvsd_tpu.data.render as render_jax
import cvsd_tpu.eval.evaluate as evaluate_jax
import cvsd_tpu.models.shopformer as shopformer_jax
import cvsd_tpu.pipeline.streaming as streaming_jax
import cvsd_tpu.train.loop as loop_jax
from cvsd_tpu.utils.checkpoint import save_checkpoint as save_checkpoint_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples_torch"))

import leak_bisect  # noqa: E402
import soak_streaming  # noqa: E402
import sweep_extracted  # noqa: E402

Event = collections.namedtuple("Event", "video track_id frame_end score")


def _reference_module(name):
    spec = importlib.util.spec_from_file_location(f"{name}_reference",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Pipe:
    """A streaming pipeline that returns one scripted result a pass."""

    def __init__(self, outputs):
        self.outputs = iter(outputs)
        self.detection = types.SimpleNamespace(device=torch.device("cpu"))

    def stream_videos_concurrent(self, paths, max_streams):
        return next(self.outputs)


def _script(values):
    """A reading that returns the next of ``values`` at each call."""
    it = iter(values)
    return lambda *a, **k: next(it)


def _fake_reference_stack(monkeypatch, outputs):
    """The reference's imports inside ``main``, faked: no rendering, no
    model, the scripted pipeline."""
    monkeypatch.setattr(render_jax, "render_pose_video",
                        lambda path, poses, seed: open(path, "wb").close())
    monkeypatch.setattr(shopformer_jax, "build_shopformer",
                        lambda cfg: types.SimpleNamespace(init_variables=lambda key: {}))
    monkeypatch.setattr(evaluate_jax, "ShopformerScorer", lambda *a, **k: None)
    monkeypatch.setattr(streaming_jax, "StreamingPipeline",
                        lambda *a, **k: _Pipe(copy.deepcopy(outputs)))


def _fake_port_stack(monkeypatch, module, outputs):
    monkeypatch.setattr(module, "require_cv2", lambda: None)
    monkeypatch.setattr(module, "render_videos",
                        lambda out, videos, frames: [f"v{i}.mp4" for i in range(videos)])
    monkeypatch.setattr(module, "build_pipeline", lambda cfg, device: _Pipe(copy.deepcopy(outputs)))


def _soak_outputs(scenario):
    """Three passes: the events come in another order each pass; ``noise``
    moves a score below the checksum's 5 decimals in pass 2, ``bleed``
    moves it above them."""
    events = [Event("v0", 1, 30, 0.123456789), Event("v1", 2, 60, 0.5),
              Event("v0", 3, 45, 0.25), Event("v1", 1, 72, 0.75)]
    outputs = []
    for p in range(3):
        ev = events[p:] + events[:p]
        if p == 2 and scenario != "repeat":
            ev[-1] = ev[-1]._replace(score=ev[-1].score + (4e-7 if scenario == "noise" else 2e-4))
        outputs.append({"fps": 97.3 - 4.1 * p, "videos_per_hour": 3210.7 + 11 * p, "events": ev})
    return outputs


@pytest.mark.parametrize("scenario", ["repeat", "noise", "bleed"])
def test_soak_rows_and_verdict_are_the_reference(scenario, tmp_path, monkeypatch):
    """Both soaks over one scripted series of three passes (fps, videos an
    hour, events in a new order each pass, the peak RSS): the rows, less
    their wall time, and every verdict key of the reference's are equal,
    the event check included (a score moved by 4e-7 matches, by 2e-4 does
    not); the port's artifact keeps the reference's config keys."""
    outputs = _soak_outputs(scenario)
    rss = [512 * 1024, 530 * 1024 + 77, 541 * 1024 + 310]
    flags = ["--minutes", "0", "--videos", "2", "--frames", "8"]
    _fake_reference_stack(monkeypatch, outputs)
    monkeypatch.setattr(resource, "getrusage",
                        _script([types.SimpleNamespace(ru_maxrss=r) for r in rss]))
    monkeypatch.setattr(sys, "argv", ["soak_streaming.py", *flags, "--out", str(tmp_path / "r"),
                                      "--artifact", str(tmp_path / "ref.json")])
    _reference_module("soak_streaming").main()
    with open(tmp_path / "ref.json") as f:
        ref = json.load(f)

    _fake_port_stack(monkeypatch, soak_streaming, outputs)
    monkeypatch.setattr(resource, "getrusage",
                        _script([types.SimpleNamespace(ru_maxrss=r) for r in rss]))
    monkeypatch.setattr(soak_streaming, "vmrss_mb", _script([400.0, 401.5, 403.0]))
    soak_streaming.main([*flags, "--out", str(tmp_path / "p"),
                         "--artifact", str(tmp_path / "port.json"), "--device", "cpu"])
    with open(tmp_path / "port.json") as f:
        got = json.load(f)

    assert len(got["series"]) == len(ref["series"]) == 3
    for g, r in zip(got["series"], ref["series"]):
        r.pop("wall_s")
        assert {k: g[k] for k in r} == r
    assert {k: got["verdict"][k] for k in ref["verdict"]} == ref["verdict"]
    assert ref["verdict"]["all_event_sets_match"] is (scenario != "bleed")
    assert got["verdict"]["vmrss_growth_mb_per_pass"] == 1.5
    assert {k: got["config"][k] for k in ref["config"]} == ref["config"]


def test_leak_bisect_rows_and_slopes_are_the_reference(tmp_path, monkeypatch, capsys):
    """Both bisects over one scripted series of five passes (RSS,
    tracemalloc's current bytes, the live device buffers): the rows, less
    the gc object count, and the slopes a pass are the reference's."""
    outputs = [{"fps": 50.0, "videos_per_hour": 100.0, "events": [Event("v0", 1, 30, 0.5)] * p}
               for p in range(5)]
    rss = [500.04, 530.25, 541.5, 560.75, 566.0]
    traced = [(1_000_000, 0), (3_512_345, 0), (3_600_000, 0), (4_200_001, 0), (4_251_000, 0)]
    live = [10, 12, 12, 15, 16]
    flags = ["--passes", "5", "--videos", "2", "--frames", "8"]
    ref_mod = _reference_module("leak_bisect")
    _fake_reference_stack(monkeypatch, outputs)
    monkeypatch.setattr(ref_mod, "rss_mb", _script(rss))
    monkeypatch.setattr(tracemalloc, "get_traced_memory", _script(traced))
    monkeypatch.setattr(jax, "live_arrays", _script([[None] * n for n in live]))
    monkeypatch.setattr(sys, "argv", ["leak_bisect.py", *flags, "--out", str(tmp_path / "r")])
    capsys.readouterr()
    try:
        ref_mod.main()
    finally:
        tracemalloc.stop()  # the reference leaves it on
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    ref_rows, ref_slopes = lines[:-1], lines[-1]

    _fake_port_stack(monkeypatch, leak_bisect, outputs)
    monkeypatch.setattr(leak_bisect, "vmrss_mb", _script(rss))
    monkeypatch.setattr(tracemalloc, "get_traced_memory", _script(traced))
    monkeypatch.setattr(leak_bisect, "live_tensors", _script(live))
    got = leak_bisect.main([*flags, "--out", str(tmp_path / "p"), "--device", "cpu"])

    assert len(got["series"]) == len(ref_rows) == 5
    for g, r in zip(got["series"], ref_rows):
        r.pop("gc_objects")
        assert {k: g[k] for k in r} == r
    assert {**got["slopes"], "native": "auto"} == {**ref_slopes,
                                                   "device_allocated_mb_per_pass": None}
    assert ref_slopes["rss_mb_per_pass"] > 0 and ref_slopes["live_arrays_per_pass"] > 0


class _RecordingTrainer:
    """A trainer that records its configuration and returns an artifact
    whose AUCs follow the run's name and seed (no video AUC for seed 1)."""

    configs = {}

    def __init__(self, cfg, verbose=True, device=None):
        self.cfg = copy.deepcopy(cfg)

    def setup(self):
        return self

    def fit(self):
        run = os.path.basename(self.cfg["experiment"]["checkpoint_dir"])
        self.configs[run] = self.cfg
        seed = self.cfg["experiment"]["seed"] - 1000
        auc = 0.5 + (sum(map(ord, run)) % 97) / 251 + 0.0123 * seed
        return {"test_metrics": {"auc_roc": auc},
                "video_metrics": None if seed == 1 else {"mean": {"auc_roc": auc / 2}}}


def test_sweep_fit_configs_and_rows_are_the_reference(tmp_path, monkeypatch):
    """Both sweeps over every config of ``CONFIGS`` and 3 seeds, on one
    dataset directory, each fit handed to a recording trainer: every fit's
    configuration equals the reference's (data, schedule, seed 1000 + s,
    the config's overrides, the run directory under ``--out``), and the
    written ``sweep_extracted.json`` (rows, means, standard deviations,
    video AUCs with a missing one) is the reference's."""
    data = str(tmp_path / "PoseLift")
    ref_mod = _reference_module("sweep_extracted")
    monkeypatch.setattr(ref_mod, "build_dataset", lambda *a, **k: data)
    monkeypatch.setattr(loop_jax, "Trainer", _RecordingTrainer)
    monkeypatch.setattr(sys, "argv", ["sweep_extracted.py", "--seeds", "3",
                                      "--out", str(tmp_path / "out")])
    ref_mod.main()
    ref_cfgs = dict(_RecordingTrainer.configs)
    with open(tmp_path / "out" / "sweep_extracted.json") as f:
        ref = json.load(f)
    _RecordingTrainer.configs = {}

    monkeypatch.setattr(sweep_extracted, "build_dataset", lambda *a, **k: data)
    monkeypatch.setattr(sweep_extracted, "Trainer", _RecordingTrainer)
    monkeypatch.setattr(sweep_extracted.example, "require_cv2", lambda: None)
    sweep_extracted.main(["--seeds", "3", "--out", str(tmp_path / "out"), "--device", "cpu"])
    with open(tmp_path / "out" / "sweep_extracted.json") as f:
        got = json.load(f)

    assert len(ref_cfgs) == 3 * len(sweep_extracted.CONFIGS)
    assert _RecordingTrainer.configs == ref_cfgs
    assert got == ref


def _poselift(root):
    """A small PoseLift tree: two train videos of two people, two test
    videos with frame-level ground truth (one half anomalous)."""
    rng = np.random.default_rng(23)
    for split in ("Train", "Test", "GT"):
        os.makedirs(os.path.join(root, "Pickle_files", split))

    def video(n_frames, n_people, jitter):
        base = rng.uniform(100, 200, (n_people, 17, 3))
        return {f: {p: [np.array([0, 0, 50, 50]),
                        base[p] + rng.normal(0, jitter, (17, 3))] for p in range(n_people)}
                for f in range(n_frames)}

    for name, vid in (("cam1_vid1", video(160, 2, 1.0)), ("cam1_vid2", video(160, 2, 1.0)),
                      ("cam2_vid1", video(96, 1, 1.0)), ("cam2_vid2", video(96, 1, 8.0))):
        split = "Train" if name.startswith("cam1") else "Test"
        with open(os.path.join(root, "Pickle_files", split, f"{name}.pkl"), "wb") as f:
            pickle.dump(vid, f)
        if split == "Test":
            gt = np.zeros(96)
            gt[48:] = name.endswith("2")
            np.save(os.path.join(root, "Pickle_files", "GT", f"{name}.npy"), gt)
    return root


def test_sweep_fit_matches_jax(tmp_path, monkeypatch):
    """One fit of ``tok4``'s configuration cut to 2 + 2 epochs with dropout
    off, seed 0, in both sweeps' ``main`` on one PoseLift directory, both
    from the JAX trainer's initial variables: the window AUC within 0.01
    (``test_torch_train.py``'s fit tolerance; the runs drift by the
    rounding-noise Adam steps it describes) and the same row keys."""
    data = _poselift(str(tmp_path / "PoseLift"))
    init = str(tmp_path / "init.msgpack")
    tok4 = dict(dict(sweep_extracted.CONFIGS)["tok4"], **{
        "training.stage1_epochs": 2, "training.stage2_epochs": 2, "model.dropout": 0.0})

    class JaxFromInit(loop_jax.Trainer):
        def fit(self):
            save_checkpoint_jax(init, jax.tree_util.tree_map(
                np.asarray, {"params": self._params, "batch_stats": self._batch_stats}),
                config=self.config)
            return super().fit(resume_checkpoint=init)

    class PortFromInit(sweep_extracted.Trainer):
        def fit(self):
            return super().fit(resume_checkpoint=init)

    ref_mod = _reference_module("sweep_extracted")
    monkeypatch.setattr(ref_mod, "build_dataset", lambda *a, **k: data)
    monkeypatch.setattr(ref_mod, "CONFIGS", [("tok4", tok4)])
    monkeypatch.setattr(loop_jax, "Trainer", JaxFromInit)
    monkeypatch.setattr(sys, "argv", ["sweep_extracted.py", "--seeds", "1",
                                      "--out", str(tmp_path / "jax")])
    ref_mod.main()
    with open(tmp_path / "jax" / "sweep_extracted.json") as f:
        ref = json.load(f)["results"][0]

    monkeypatch.setattr(sweep_extracted, "build_dataset", lambda *a, **k: data)
    monkeypatch.setattr(sweep_extracted, "CONFIGS", [("tok4", tok4)])
    monkeypatch.setattr(sweep_extracted, "Trainer", PortFromInit)
    monkeypatch.setattr(sweep_extracted.example, "require_cv2", lambda: None)
    got = sweep_extracted.main(["--seeds", "1", "--out", str(tmp_path / "port"),
                                "--device", "cpu"])[0]
    assert got.keys() == ref.keys()
    assert 0.0 < ref["window_aucs"][0] < 1.0
    assert abs(got["window_aucs"][0] - ref["window_aucs"][0]) <= 0.01
