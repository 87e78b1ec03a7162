"""The port's annotated-video writer (cvsd_tpu_torch/viz/annotate.py,
cli/annotate.py) against the JAX package's on the CPU: the streaming
fixture's detector and Shopformer (img 64, conf 0.0, two detections,
float32; hidden 8, stride 6) with the same flax variables on both sides,
cv2 decode on both (the reference's batcher kept off its native decoder)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.data.video import VideoBatcher as VideoBatcherJax
from cvsd_tpu.data.video import write_test_video
from cvsd_tpu.eval.evaluate import ShopformerScorer as ShopformerScorerJax
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.shopformer import build_shopformer as build_shopformer_jax
from cvsd_tpu.pipeline.preprocess import DetectionPipeline as DetectionPipelineJax
from cvsd_tpu.pipeline.streaming import StreamingPipeline as StreamingPipelineJax
from cvsd_tpu.utils.checkpoint import save_checkpoint as save_checkpoint_jax
from cvsd_tpu.viz import annotate as annotate_jax
from cvsd_tpu_torch.cli import annotate as annotate_cli
from cvsd_tpu_torch.cli import quantize_detector
from cvsd_tpu_torch.config import get_default_config
from cvsd_tpu_torch.eval.evaluate import ShopformerScorer
from cvsd_tpu_torch.models.detector import build_detector
from cvsd_tpu_torch.models.shopformer import build_shopformer
from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline
from cvsd_tpu_torch.pipeline.streaming import StreamingPipeline
from cvsd_tpu_torch.utils.weights import flax_to_state_dict
from cvsd_tpu_torch.viz import annotate
from torch_testutil import random_flax_variables

cv2 = pytest.importorskip("cv2")
DET = dict(img_size=64, width_mult=0.25, depth_mult=0.34, batch_size=4, conf_threshold=0.0,
           max_detections=2, dtype="float32", pose_head=True, native_decode=False)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _cv2_decode(monkeypatch):
    monkeypatch.setattr(VideoBatcherJax, "_native_decode_available", staticmethod(lambda: False))


def _configs():
    out = []
    for cfg in (get_default_config_jax(), get_default_config()):
        cfg["detector"].update(DET)
        cfg["model"]["hidden_channels"] = 8
        cfg["data"]["stride"] = 6
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    td = tmp_path_factory.mktemp("annotate")
    video = write_test_video(str(td / "clip.mp4"), num_frames=40, width=160, height=128, seed=3)
    cfg_j, _cfg_t = _configs()
    det = PersonDetectorJax(img_size=64, width_mult=0.25, depth_mult=0.34, num_keypoints=17,
                            dtype=jnp.float32)
    det_vars = random_flax_variables(
        lambda: det.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)),
                         train=False), 71)
    sf = build_shopformer_jax(cfg_j)
    sf_vars = random_flax_variables(lambda: sf.init_variables(jax.random.PRNGKey(0)), 72)
    det_ckpt, sf_ckpt = str(td / "det.msgpack"), str(td / "sf.msgpack")
    save_checkpoint_jax(det_ckpt, jax.device_get(det_vars), config={"detector": DET})
    save_checkpoint_jax(sf_ckpt, jax.device_get(sf_vars), config=cfg_j)
    return td, video, det_vars, sf_vars, det_ckpt, sf_ckpt


def _frames(path):
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_draw_detections_equal_pixels():
    """The same detections on the same frame draw the same pixels, anomaly
    colors, labels, skeletons and banner included."""
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 255, (128, 160, 3), np.uint8)
    dets = [{"track_id": 3, "box": np.array([10.4, 12.6, 70.2, 110.7], np.float32),
             "score": 0.73, "kpts": rng.uniform(10, 110, (17, 2)).astype(np.float32)},
            {"track_id": 11, "box": np.array([90.0, 2.0, 150.0, 60.0], np.float32),
             "score": 0.41, "kpts": None}]
    for anomaly in (None, {3: 0.9, 11: 0.1}):
        a = annotate.draw_detections(frame.copy(), dets, anomaly, 0.5, banner="f7 t=233ms")
        b = annotate_jax.draw_detections(frame.copy(), dets, anomaly, 0.5, banner="f7 t=233ms")
        np.testing.assert_array_equal(a, b)
        assert (a != frame).any()


def test_annotate_video_matches_jax(setup):
    """annotate_video: the same events (keys, frames, stamps; scores within
    1e-4, the stream tests' limit) and frame count as the JAX package's;
    the mp4 holds every source frame."""
    td, video, det_vars, sf_vars, _d, _s = setup
    cfg_j, cfg_t = _configs()
    sf_j = build_shopformer_jax(cfg_j)
    pipe_j = StreamingPipelineJax(cfg_j, ShopformerScorerJax(sf_j, sf_vars, cfg_j),
                                  detector_variables=det_vars)
    sf_t = build_shopformer(cfg_t, device="cpu")
    sf_t.load_state_dict(flax_to_state_dict(sf_vars, sf_t))
    pipe_t = StreamingPipeline(cfg_t, ShopformerScorer(sf_t, cfg_t, device="cpu"),
                               detector_state_dict=flax_to_state_dict(
                                   det_vars, build_detector(cfg_t, device="cpu")), device="cpu")
    out_j, out_t = str(td / "jax.mp4"), str(td / "port.mp4")
    ref = annotate_jax.annotate_video(pipe_j, video, out_j, threshold=0.5)
    got = annotate.annotate_video(pipe_t, video, out_t, threshold=0.5)
    assert got["frames"] == ref["frames"] == _frames(out_t) == 40
    key = lambda e: (e["video"], e["track_id"], e["frame_end"])  # noqa: E731
    assert sorted(map(key, got["events"])) == sorted(map(key, ref["events"]))
    assert len(got["events"]) > 0
    want = {key(e): e for e in ref["events"]}
    for e in got["events"]:
        r = want[key(e)]
        assert e["frames"] == r["frames"] and e["timestamp_ms"] == r["timestamp_ms"]
        assert abs(e["score"] - r["score"]) <= 1e-4
    assert abs(got["max_score"] - ref["max_score"]) <= 1e-4


def test_annotate_video_detections_matches_jax(setup):
    td, video, det_vars, _sf, _d, _s = setup
    cfg_j, cfg_t = _configs()
    det_t = DetectionPipeline(cfg_t, state_dict=flax_to_state_dict(
        det_vars, build_detector(cfg_t, device="cpu")), device="cpu")
    ref = annotate_jax.annotate_video_detections(
        DetectionPipelineJax(cfg_j, variables=det_vars), video, str(td / "dj.mp4"))
    got = annotate.annotate_video_detections(det_t, video, str(td / "dt.mp4"))
    assert (got["frames"], got["detections"]) == (ref["frames"], ref["detections"]) == (40, 80)
    assert _frames(got["out_path"]) == 40


def test_annotate_cli_with_an_int8_checkpoint(setup, tmp_path):
    """cli.annotate with --checkpoint and an int8 --detector_checkpoint (the
    port's quantize CLI on the float one), no --set: an mp4 of every frame
    and a summary; detector-only mode too; neither checkpoint is an error."""
    _td, video, _dv, _sv, det_ckpt, sf_ckpt = setup
    q = str(tmp_path / "int8.msgpack")
    quantize_detector.main(["--detector_checkpoint", det_ckpt, "--output", q,
                            "--calib_frames", "4", "--calib_batch", "2", "--device", "cpu"])
    out_dir, summary = str(tmp_path / "out"), str(tmp_path / "s.json")
    annotate_cli.main(["--checkpoint", sf_ckpt, "--detector_checkpoint", q, "--videos", video,
                       "--out-dir", out_dir, "--output", summary, "--device", "cpu"])
    with open(summary) as f:
        s = json.load(f)[video]
    assert s["frames"] == 40 and _frames(s["out_path"]) == 40 and "num_events" in s
    annotate_cli.main(["--detector_checkpoint", q, "--videos", video, "--out-dir", out_dir,
                       "--output", summary, "--device", "cpu"])
    with open(summary) as f:
        s = json.load(f)[video]
    assert s["frames"] == 40 and s["detections"] > 0
    assert os.path.exists(os.path.join(out_dir, "clip_annotated.mp4"))
    with pytest.raises(SystemExit):
        annotate_cli.main(["--videos", video, "--device", "cpu"])
