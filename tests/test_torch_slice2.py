"""Slice 2 of the port against the JAX package on the CPU: DetectionPipeline
and StreamingPipeline in the slice-2 configuration (ultralytics-u v8dfl head,
top-down crop pose, flip-TTA, 'pallas_seq' NMS) at test size, with the flax
detector and pose-net weights carried across by the bridge."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.data.video import write_test_video
from cvsd_tpu.eval.evaluate import ShopformerScorer as ShopformerScorerJax
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.pose_topdown import TopDownPoseNet as TopDownPoseNetJax
from cvsd_tpu.models.shopformer import build_shopformer as build_shopformer_jax
from cvsd_tpu.pipeline.preprocess import DetectionPipeline as DetectionPipelineJax
from cvsd_tpu.pipeline.streaming import StreamingPipeline as StreamingPipelineJax
from cvsd_tpu_torch.config import get_default_config
from cvsd_tpu_torch.eval.evaluate import ShopformerScorer
from cvsd_tpu_torch.models.detector import build_detector
from cvsd_tpu_torch.models.pose_topdown import TopDownPoseNet, build_pose_topdown, pose_from_boxes
from cvsd_tpu_torch.models.shopformer import build_shopformer
from cvsd_tpu_torch.ops.letterbox import letterbox_batch
from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline
from cvsd_tpu_torch.pipeline.streaming import StreamingPipeline
from cvsd_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from torch_testutil import random_flax_variables

# the slice-2 detector settings, at test size (img 128, width 0.25, depth 0.34,
# float32, pose net width 8 on 32-pixel crops, 16 detections)
SLICE2 = dict(head_variant="v8dfl", num_classes=80, reg_max=16, pose_head=False,
              pose_mode="topdown", tta_flip=True, nms_method="pallas_seq",
              conf_threshold=0.25, iou_threshold=0.45)
SMALL = dict(img_size=128, width_mult=0.25, depth_mult=0.34, dtype="float32",
             pose_topdown={"num_keypoints": 17, "width": 8, "crop_size": 32},
             max_detections=16, batch_size=2)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _models(img, seed, crop=32, width=8):
    """(detector flax variables, pose model JAX, pose flax variables, pose
    model torch) at img size ``img``."""
    det_j = PersonDetectorJax(img_size=img, width_mult=0.25, depth_mult=0.34,
                              head_variant="v8dfl", dtype=jnp.float32)
    det_vars = random_flax_variables(
        lambda: det_j.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, img, img, 3)),
                           train=False), seed)
    pose_j = TopDownPoseNetJax(num_keypoints=17, width=width, crop_size=crop)
    pose_vars = random_flax_variables(lambda: pose_j.init_variables(jax.random.PRNGKey(0)),
                                      seed + 1)
    pose_t = load_flax_variables(TopDownPoseNet(17, width, crop), pose_vars).eval()
    return det_vars, pose_j, pose_vars, pose_t


def _configs(**extra):
    cfg_j, cfg_t = get_default_config_jax(), get_default_config()
    for c in (cfg_j, cfg_t):
        c["detector"].update(SLICE2, **extra)
    return cfg_j, cfg_t


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (2, 240, 320, 3)).astype(np.uint8)


def test_detection_pipeline_slice2_matches_jax(frames):
    """valid exact; boxes within 2e-3 px, keypoints within 2e-3 px (their
    confidences 1e-5) and scores within 1e-5: float32 convolutions summed in
    another order (tests/test_torch_v8.py, test_torch_pose_topdown.py) and
    the device letterbox's resampling (test_torch_ops.py)."""
    cfg_j, cfg_t = _configs(**SMALL)
    det_vars, pose_j, pose_vars, pose_t = _models(128, 31)
    ref = DetectionPipelineJax(cfg_j, variables=det_vars, pose_model=pose_j,
                               pose_variables=pose_vars).detect_frames(frames)
    sd = flax_to_state_dict(det_vars, build_detector(cfg_t, device="cpu"))
    got = DetectionPipeline(cfg_t, state_dict=sd, device="cpu",
                            pose_model=pose_t).detect_frames(frames)
    assert len(got) == len(ref) == 5
    assert got[4].shape == (2, 16, 17, 3)
    assert got[3].sum() > 8  # random weights still keep detections
    names = ("boxes_src", "xywhn", "scores", "valid")
    for name, r, g, tol in zip(names, ref, got, (2e-3, 1e-5, 1e-5, 0)):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if tol == 0:
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, atol=tol, rtol=0, err_msg=name)
    np.testing.assert_allclose(got[4][..., :2], ref[4][..., :2], atol=2e-3, rtol=0)
    np.testing.assert_allclose(got[4][..., 2], ref[4][..., 2], atol=1e-5, rtol=0)


def test_topdown_pose_reads_the_detector_canvas(frames):
    """With a bf16 detector the pose net crops the canvas the detector saw,
    rounded to bf16, then cast to float32 (as the reference crops
    ``images.astype(float32)``), not the frames at full precision."""
    _cfg_j, cfg = _configs(**{**SMALL, "dtype": "bfloat16"})
    pose = build_pose_topdown(cfg, device="cpu", seed=2)
    pipe = DetectionPipeline(cfg, device="cpu", seed=1, pose_model=pose)
    x = torch.from_numpy(frames)
    got = pipe.fetch_detections(pipe.detect_frames_async(x))[4]
    canvas = letterbox_batch(x, size=128, dtype=torch.bfloat16)
    boxes_lb = pipe._detect(canvas)[0]
    want, _ = pose_from_boxes(pose, canvas.to(torch.float32), boxes_lb)
    np.testing.assert_array_equal(got, want.numpy())
    full, _ = pose_from_boxes(pose, letterbox_batch(x, size=128, dtype=torch.float32), boxes_lb)
    assert not np.array_equal(full.numpy(), got)


def test_topdown_without_pose_model_is_seeded_and_warns():
    """No pose_model and no checkpoint: a random net from seed + 1, with the
    reference's RuntimeWarning."""
    _cfg_j, cfg = _configs(**{**SMALL, "img_size": 64})
    with pytest.warns(RuntimeWarning, match="RANDOMLY-INITIALIZED"):
        pipe = DetectionPipeline(cfg, device="cpu", seed=4)
    ref = build_pose_topdown(cfg, device="cpu", seed=5).state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in pipe.pose_model.state_dict().items())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        DetectionPipeline(cfg, device="cpu", pose_model=build_pose_topdown(cfg, device="cpu"))


def _stream_config(cfg):
    cfg["detector"].update(img_size=64, width_mult=0.25, depth_mult=0.34, batch_size=4,
                           conf_threshold=0.0, max_detections=2, dtype="float32",
                           pose_topdown={"num_keypoints": 17, "width": 8, "crop_size": 32},
                           native_decode=False)
    cfg["model"]["hidden_channels"] = 8
    cfg["data"]["stride"] = 6
    return cfg


def ekey(e):
    return (e.video, e.track_id, e.frame_end)


def test_streaming_slice2_matches_jax(tmp_path):
    """The repo's rendered test videos (6 x 40 frames at 160x128, 4 streams)
    through StreamingPipeline in the slice-2 configuration: the same event
    keys, frames and stamps as the reference; scores within 1e-4 of the
    largest score (the keypoints' float32 gap, magnified by
    normalize_sequence over random-weight windows)."""
    vids = [write_test_video(str(tmp_path / f"v{i}.mp4"), num_frames=40, width=160, height=128,
                             seed=i) for i in range(6)]
    cfg_j, cfg_t = (_stream_config(c) for c in _configs())
    det_vars, pose_j, pose_vars, pose_t = _models(64, 41)
    sf_j = build_shopformer_jax(cfg_j)
    sf_vars = random_flax_variables(lambda: sf_j.init_variables(jax.random.PRNGKey(0)), 42)
    out_j = StreamingPipelineJax(cfg_j, ShopformerScorerJax(sf_j, sf_vars, cfg_j),
                                 detector_variables=det_vars, pose_model=pose_j,
                                 pose_variables=pose_vars).stream_videos_concurrent(
        vids, max_streams=4)

    sf_t = build_shopformer(cfg_t, device="cpu")
    sf_t.load_state_dict(flax_to_state_dict(sf_vars, sf_t))
    det_sd = flax_to_state_dict(det_vars, build_detector(cfg_t, device="cpu"))
    pipe = StreamingPipeline(cfg_t, ShopformerScorer(sf_t, cfg_t, device="cpu"),
                             detector_state_dict=det_sd, device="cpu", pose_model=pose_t)
    assert pipe.detection.model.head_variant == "v8dfl" and not pipe.detection.model.num_keypoints
    out_t = pipe.stream_videos_concurrent(vids, max_streams=4)
    ev_j, ev_t = out_j["events"], out_t["events"]
    assert len(ev_t) > 20
    assert sorted(map(ekey, ev_t)) == sorted(map(ekey, ev_j))
    ref = {ekey(e): e for e in ev_j}
    top = max(abs(e.score) for e in ev_j)
    for e in ev_t:
        r = ref[ekey(e)]
        assert e.frames == r.frames and e.timestamp_ms == r.timestamp_ms
        assert abs(e.score - r.score) <= 1e-4 * top, ekey(e)
    assert out_t["frames"] == out_j["frames"] == 240
