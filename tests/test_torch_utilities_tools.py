"""The port's utility tools (``examples_torch/train_detector_hard.py``,
``eval_int8_accuracy.py``, ``soak_streaming.py``, ``leak_bisect.py``,
``sweep_extracted.py``) on the CPU at their smallest flags: each ``main``
runs with ``--device cpu`` and writes the reference's JSON keys, and the
soak's passes repeat their events. Their parity with the JAX package is
``test_torch_utilities.py``'s."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples_torch"))

import eval_int8_accuracy  # noqa: E402
import leak_bisect  # noqa: E402
import soak_streaming  # noqa: E402
import sweep_extracted  # noqa: E402
import train_detector_hard  # noqa: E402

from cvsd_tpu_torch.models.detector import PersonDetector  # noqa: E402
from cvsd_tpu_torch.train.detector_train import DetectorTrainer  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _reference_keys(name):
    """The keys of the JAX example's committed results file."""
    with open(os.path.join(ROOT, "examples", name)) as f:
        return set(json.load(f))


def test_soak_passes_repeat_their_events(tmp_path):
    """Three passes of the soak's loop over two rendered videos with
    ``--config configs/streaming_production.yaml`` (the byte tracker, frame
    stride 2) cut to the test size (width 0.25, img 128, float32, batch 8),
    conf 0.01 so the random detector keeps people: every pass scores
    windows and the steady passes' order-insensitive checksums equal pass
    1's; the verdict carries the reference's keys."""
    pytest.importorskip("cv2")
    pytest.importorskip("yaml")
    args = soak_streaming.parser().parse_args(
        ["--config", os.path.join(ROOT, "configs", "streaming_production.yaml"),
         "--device", "cpu"])
    cfg = soak_streaming.soak_config(args)
    assert cfg["detector"]["tracker"] == "byte" and cfg["detector"]["frame_stride"] == 2
    cfg["detector"].update(img_size=128, width_mult=0.25, depth_mult=0.34, dtype="float32",
                           batch_size=8, conf_threshold=0.01)
    paths = soak_streaming.render_videos(str(tmp_path), 2, 24)
    pipe = soak_streaming.build_pipeline(cfg, torch.device("cpu"))
    series, verdict = soak_streaming.soak(pipe, paths, max_streams=2, minutes=0)
    assert len(series) == 3 and min(r["events"] for r in series) > 0
    assert [r.get("events_match_pass1") for r in series] == [None, None, True]
    assert verdict["all_event_sets_match"] is True
    assert {"passes", "fps_first_steady", "fps_last", "fps_drift_pct", "fps_min", "fps_max",
            "rss_first_steady_mb", "rss_last_mb", "rss_growth_mb"} <= set(verdict)


def test_render_workers_draw_the_same_chunks():
    """``chunks`` renders each chunk in a spawned process from its own seed:
    the chunks, in order, are ``scene_chunk``'s in this process byte for
    byte, from a resumed start too."""
    args = train_detector_hard.parser().parse_args(
        ["--steps", "5", "--img", "64", "--batch", "2", "--scan-chunk", "2", "--device", "cpu"])
    src = train_detector_hard.scene_source()
    assert train_detector_hard.render_workers(3) in (1, 2, 3)
    for start in (0, 2):
        got = list(train_detector_hard.chunks(args, src, start, 5))
        assert [s for s, _ in got] == list(range(start, 5, 2))
        for s, g in got:
            ref = train_detector_hard.scene_chunk(args.seed, s, min(2, 5 - s), args.batch,
                                                  args.img, args.max_persons, src)
            assert [x.tobytes() for x in g] == [x.tobytes() for x in ref]
    assert list(train_detector_hard.chunks(args, src, 5, 5)) == []


def _detector_checkpoint(path):
    """A pose-head detector at img 64 saved by the port's trainer."""
    tr = DetectorTrainer(PersonDetector(img_size=64, width_mult=0.25, depth_mult=0.34,
                                        num_keypoints=17, dtype=torch.float32), device="cpu")
    tr.save(path, use_ema=False)
    return path


def _run_hard(tmp):
    out = os.path.join(tmp, "hard.json")
    ckpt = os.path.join(tmp, "hard.msgpack")
    summary = train_detector_hard.main(
        ["--steps", "2", "--img", "64", "--batch", "2", "--scan-chunk", "2", "--eval-size", "2",
         "--width", "0.25", "--out", out, "--save-checkpoint", ckpt,
         "--device", "cpu"])
    with open(out) as f:
        written = json.load(f)
    assert set(written) >= _reference_keys("detector_hard_results.json")
    assert os.path.exists(ckpt) and not any(
        os.path.exists(p) for p in train_detector_hard.partial_paths(out))
    return summary["train_loss_last50"]


def _run_int8(tmp):
    out = os.path.join(tmp, "int8.json")
    res = eval_int8_accuracy.main(
        ["--checkpoint", _detector_checkpoint(os.path.join(tmp, "det.msgpack")),
         "--eval-size", "2", "--calib-batches", "1", "--calib-batch", "2", "--qat-steps", "2",
         "--qat-batch", "2", "--out", out, "--device", "cpu"])
    with open(out) as f:
        assert set(json.load(f)) == _reference_keys("int8_accuracy_results.json")
    assert res["int8_qat"]["steps"] == 2
    return res["int8_qat"]["ap50"]


def _run_soak(tmp):
    pytest.importorskip("cv2")
    artifact = os.path.join(tmp, "soak.json")
    soak_streaming.main(["--minutes", "0", "--videos", "1", "--frames", "16", "--img", "64",
                         "--batch", "4", "--out", tmp, "--artifact", artifact,
                         "--device", "cpu"])
    with open(artifact) as f:
        written = json.load(f)
    assert set(written) == {"series", "verdict", "config"} and len(written["series"]) == 3
    return written["verdict"]["fps_last"]


def _run_bisect(tmp):
    pytest.importorskip("cv2")
    out = leak_bisect.main(["--passes", "3", "--videos", "1", "--frames", "16", "--img", "64",
                            "--batch", "4", "--native-decode", "off", "--malloc-trim",
                            "--out", tmp, "--device", "cpu"])
    assert [r["pass"] for r in out["series"]] == [0, 1, 2]
    assert set(out["slopes"]) == {"rss_mb_per_pass", "tracemalloc_mb_per_pass",
                                  "live_arrays_per_pass", "device_allocated_mb_per_pass"}
    return out["slopes"]["rss_mb_per_pass"]


def _run_sweep(tmp):
    pytest.importorskip("cv2")
    rows = sweep_extracted.main(
        ["--train-videos", "2", "--test-videos", "2", "--seeds", "1",
         "--steps", "2", "--pose-steps", "2", "--img-size", "64", "--configs", "tok4",
         "--out", tmp, "--device", "cpu"])
    with open(os.path.join(tmp, "sweep_extracted.json")) as f:
        written = json.load(f)
    assert set(written) == _reference_keys("sweep_extracted_results.json")
    with open(os.path.join(ROOT, "examples", "sweep_extracted_results.json")) as f:
        assert set(written["results"][0]) == set(json.load(f)["results"][0])
    assert [r["config"] for r in rows] == ["tok4"] and len(rows[0]["window_aucs"]) == 1
    return rows[0]["window_auc_mean"]


@pytest.mark.parametrize("run", [_run_hard, _run_int8, _run_soak, _run_bisect, _run_sweep],
                         ids=["train_detector_hard", "eval_int8_accuracy", "soak_streaming",
                              "leak_bisect", "sweep_extracted"])
def test_main_at_smallest_flags(run, tmp_path):
    """Each tool's ``main`` end to end on the CPU at its smallest flags,
    writing the reference's JSON keys; its headline number is finite."""
    assert np.isfinite(run(str(tmp_path)))
