"""Checkpoints the JAX package writes, loaded by the port on the CPU:
load_model's Shopformer scores against JAX load_model's, and a
TopDownPoseTrainer file set as detector.pose_topdown_checkpoint against the
JAX pipeline's keypoints."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.eval.evaluate import load_model as load_model_jax
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.pose_topdown import TopDownPoseNet as TopDownPoseNetJax
from cvsd_tpu.models.shopformer import build_shopformer as build_shopformer_jax
from cvsd_tpu.pipeline.preprocess import DetectionPipeline as DetectionPipelineJax
from cvsd_tpu.train.pose_topdown_train import TopDownPoseTrainer
from cvsd_tpu.utils.checkpoint import save_checkpoint as save_checkpoint_jax
from cvsd_tpu_torch.config import get_default_config
from cvsd_tpu_torch.eval.evaluate import load_model
from cvsd_tpu_torch.models.detector import build_detector
from cvsd_tpu_torch.models.pose_topdown import load_pose_topdown_checkpoint
from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline
from cvsd_tpu_torch.utils.weights import flax_to_state_dict
from torch_testutil import random_flax_variables


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def shopformer_checkpoint(tmp_path_factory):
    """A seeded flax Shopformer (v1, hidden 8, batch 4) saved by the JAX
    package, its config embedded."""
    cfg = get_default_config_jax()
    cfg["model"].update(hidden_channels=8, variant="v1")
    cfg["data"]["batch_size"] = 4
    jm = build_shopformer_jax(cfg)
    variables = random_flax_variables(lambda: jm.init_variables(jax.random.PRNGKey(0)), 41)
    path = str(tmp_path_factory.mktemp("ckpt") / "stage2_best.msgpack")
    save_checkpoint_jax(path, variables, config=cfg, epoch=2, metrics={"auc_roc": 0.5})
    return path, cfg


@pytest.fixture(scope="module")
def windows():
    return np.random.default_rng(8).normal(size=(9, 12, 18, 2)).astype(np.float32)


def test_load_model_matches_jax(shopformer_checkpoint, windows):
    """The config comes from the checkpoint (v1, hidden 8, batch 4: 9
    windows score in 3 padded batches); scores within the Shopformer
    tolerance, rtol 1e-5 / atol 1e-6."""
    path, _cfg = shopformer_checkpoint
    ref = load_model_jax(path).score(windows)
    scorer = load_model(path, device="cpu")
    assert scorer.config["model"]["variant"] == "v1" and scorer.model.variant == "v1"
    assert scorer.config["data"]["batch_size"] == 4 and scorer.device.type == "cpu"
    got = scorer.score(windows)
    assert got.shape == ref.shape == (9,)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_load_model_config_sources(shopformer_checkpoint, windows, tmp_path):
    """An explicit config wins over the embedded one; with none embedded, a
    sibling config.json is read, as in the reference."""
    path, cfg = shopformer_checkpoint
    explicit = load_model(path, config={"model": {"hidden_channels": 8, "variant": "v1"}},
                          device="cpu")
    assert explicit.config["data"]["batch_size"] == 32  # the default, not the embedded 4
    from cvsd_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    state, _meta = load_checkpoint(path)
    bare = str(tmp_path / "bare.msgpack")
    save_checkpoint(bare, state)  # config None
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump(cfg, f)
    sidecar = load_model(bare, device="cpu")
    assert sidecar.config["data"]["batch_size"] == 4
    np.testing.assert_array_equal(sidecar.score(windows), explicit.score(windows))


def test_pose_topdown_checkpoint_drives_the_pipeline(tmp_path):
    """A TopDownPoseTrainer.save file (temperature 0.5 in its config) set as
    detector.pose_topdown_checkpoint: the port's DetectionPipeline gives the
    JAX pipeline's keypoints within the slice-2 pipeline tolerance (x, y
    2e-3 px, confidence 1e-5)."""
    pose_j = TopDownPoseNetJax(num_keypoints=17, width=8, crop_size=32, temperature=0.5)
    trainer = TopDownPoseTrainer(pose_j)
    trainer.variables = random_flax_variables(
        lambda: pose_j.init_variables(jax.random.PRNGKey(0)), 42)
    path = str(tmp_path / "pose.msgpack")
    trainer.save(path, epoch=1)
    net = load_pose_topdown_checkpoint(path, device="cpu")
    assert (net.crop_size, net.width, net.temperature, net.training) == (32, 8, 0.5, False)

    det_j = PersonDetectorJax(img_size=128, width_mult=0.25, depth_mult=0.34, dtype=jnp.float32)
    det_vars = random_flax_variables(
        lambda: det_j.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 128, 128, 3)),
                           train=False), 43)
    det = dict(img_size=128, width_mult=0.25, depth_mult=0.34, dtype="float32", pose_head=False,
               pose_mode="topdown", pose_topdown_checkpoint=path, conf_threshold=0.0,
               max_detections=8)
    cfg_j, cfg_t = get_default_config_jax(), get_default_config()
    cfg_j["detector"].update(det)
    cfg_t["detector"].update(det)
    frames = np.random.default_rng(9).integers(0, 256, (2, 96, 128, 3)).astype(np.uint8)
    ref = DetectionPipelineJax(cfg_j, variables=det_vars).detect_frames(frames)
    sd = flax_to_state_dict(det_vars, build_detector(cfg_t, device="cpu"))
    got = DetectionPipeline(cfg_t, state_dict=sd, device="cpu").detect_frames(frames)
    assert got[4].shape == ref[4].shape == (2, 8, 17, 3)
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_allclose(got[4][..., :2], ref[4][..., :2], atol=2e-3, rtol=0)
    np.testing.assert_allclose(got[4][..., 2], ref[4][..., 2], atol=1e-5, rtol=0)
