"""The port's DetectionPipeline against the JAX pipeline on the CPU, in the
device, canvas and content letterbox modes (CPU-sized detector: img 128,
width 0.25, depth 0.34, float32, pose head; 240x320 frames)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.pipeline.preprocess import DetectionPipeline as DetectionPipelineJax
from cvsd_tpu_torch.config import get_default_config
from cvsd_tpu_torch.models.detector import build_detector
from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline
from cvsd_tpu_torch.utils.weights import flax_to_state_dict
from torch_testutil import cuda_mesh_config, random_flax_variables

S = 128
DET = dict(img_size=S, width_mult=0.25, depth_mult=0.34, dtype="float32", pose_head=True,
           conf_threshold=0.0, max_detections=16, batch_size=2)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jm = PersonDetectorJax(img_size=S, width_mult=0.25, depth_mult=0.34, num_keypoints=17,
                           dtype=jnp.float32)
    variables = random_flax_variables(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, S, S, 3)), train=False), 11)
    cfg = get_default_config()
    cfg["detector"].update(DET)
    return variables, flax_to_state_dict(variables, build_detector(cfg, device="cpu"))


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (2, 240, 320, 3)).astype(np.uint8)


@pytest.mark.parametrize("mode", [False, True, "content"], ids=["device", "canvas", "content"])
def test_detect_frames_matches_jax(mode, weights, frames):
    """valid exact; boxes and keypoints within 2e-3 px and scores within 1e-5:
    the detector's f32 sums run in another order (test_torch_detector.py),
    and the device letterbox resamples to within 1e-5 (test_torch_ops.py)."""
    variables, state_dict = weights
    cfg_j = get_default_config_jax()
    cfg_j["detector"].update(DET, host_letterbox=mode)
    cfg_t = get_default_config()
    cfg_t["detector"].update(DET, host_letterbox=mode)
    ref = DetectionPipelineJax(cfg_j, variables=variables).detect_frames(frames)
    got = DetectionPipeline(cfg_t, state_dict=state_dict, device="cpu").detect_frames(frames)
    assert len(got) == len(ref) == 5
    names = ("boxes_src", "xywhn", "scores", "valid", "kpts")
    tols = (2e-3, 1e-5, 1e-5, 0, 2e-3)
    for name, r, g, tol in zip(names, ref, got, tols):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if tol == 0:
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, atol=tol, rtol=0, err_msg=name)


def test_detect_frames_takes_a_tensor(weights, frames):
    """Frames already in a tensor give the same detections as the numpy path."""
    cfg = get_default_config()
    cfg["detector"].update(DET)
    pipe = DetectionPipeline(cfg, state_dict=weights[1], device="cpu")
    ref = pipe.detect_frames(frames)
    got = pipe.fetch_detections(pipe.detect_frames_async(torch.from_numpy(frames)))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)


def test_unported_pipeline_options_raise(tmp_path):
    """A card's mesh raises on a host without a card, as the pipeline
    without a mesh does (the meshed pipeline itself:
    tests/test_torch_parallel_detection.py)."""
    cfg = get_default_config()
    cfg["detector"].update(DET)
    with cuda_mesh_config(tmp_path) as mc, pytest.raises(RuntimeError, match="CUDA"):
        DetectionPipeline(cfg, mesh_config=mc)
    # topdown pose and its checkpoint are ported: the pipeline reads the file
    # (test_torch_load_model.py holds the loaded net against JAX)
    cfg["detector"].update(pose_mode="topdown", pose_topdown_checkpoint="no/such/pose.msgpack")
    with pytest.raises(FileNotFoundError):
        DetectionPipeline(cfg, device="cpu")
