"""The port's PoseLift export (cvsd_tpu_torch/pipeline/pose_export.py,
cli/pose_export.py) against the JAX package's on the CPU: two rendered
videos, the streaming fixture's detector (img 64, conf 0.0, two
detections, float32, pose head) with the same flax variables on both sides,
cv2 decode on both (the reference's batcher kept off its native decoder,
which fails parity on this host)."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.cli.pose_export import main as pose_export_jax
from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.data.ucf_crime import TemporalAnnotation as TemporalAnnotationJax
from cvsd_tpu.data.video import VideoBatcher as VideoBatcherJax
from cvsd_tpu.data.video import write_test_video
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.pipeline.pose_export import export_poselift_dataset as export_jax
from cvsd_tpu.pipeline.preprocess import DetectionPipeline as DetectionPipelineJax
from cvsd_tpu.utils.checkpoint import save_checkpoint as save_checkpoint_jax
from cvsd_tpu_torch.cli import pose_export, quantize_detector
from cvsd_tpu_torch.config import get_default_config
from cvsd_tpu_torch.data.ucf_crime import TemporalAnnotation
from cvsd_tpu_torch.models.detector import build_detector
from cvsd_tpu_torch.pipeline.pose_export import export_poselift_dataset, extract_pose_data
from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline
from cvsd_tpu_torch.utils.weights import flax_to_state_dict
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


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    td = tmp_path_factory.mktemp("pose_export")
    videos = [write_test_video(str(td / f"clip{i}.mp4"), num_frames=24, width=160, height=128,
                               seed=i) for i in range(2)]
    det = PersonDetectorJax(img_size=64, width_mult=0.25, depth_mult=0.34, num_keypoints=17,
                            dtype=jnp.float32)
    variables = random_flax_variables(
        lambda: det.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)),
                         train=False), 61)
    ckpt = str(td / "det.msgpack")
    save_checkpoint_jax(ckpt, jax.device_get(variables), config={"detector": DET})
    return td, videos, variables, ckpt


def _pipelines(variables):
    cfg_j, cfg_t = get_default_config_jax(), get_default_config()
    cfg_j["detector"].update(DET)
    cfg_t["detector"].update(DET)
    sd = flax_to_state_dict(variables, build_detector(cfg_t, device="cpu"))
    return (DetectionPipelineJax(cfg_j, variables=variables),
            DetectionPipeline(cfg_t, state_dict=sd, device="cpu"))


def _load(root, split, name):
    with open(os.path.join(root, "Pickle_files", split, f"{name}.pkl"), "rb") as f:
        return pickle.load(f)


def _assert_same_poses(got, ref):
    """Same frames and person ids; boxes and keypoint x, y within 1e-3 px of
    the 160x128 source (float32 detectors summing in another order),
    keypoint confidences within 1e-5; float64 arrays as PoseLift keeps."""
    assert got.keys() == ref.keys() and len(ref) > 0
    for frame, people in ref.items():
        assert got[frame].keys() == people.keys(), frame
        for pid, (box, kpts) in people.items():
            gbox, gk = got[frame][pid]
            assert gbox.dtype == gk.dtype == np.float64 and gk.shape == (17, 3)
            np.testing.assert_allclose(gbox, box, atol=1e-3)
            np.testing.assert_allclose(gk[:, :2], kpts[:, :2], atol=1e-3)
            np.testing.assert_allclose(gk[:, 2], kpts[:, 2], atol=1e-5)


def test_export_matches_jax(setup):
    """export_poselift_dataset on the Test split: the pickles agree with the
    JAX package's, the GT files are byte-equal (the annotation's ranges as
    labels), and the stats agree."""
    td, videos, variables, _ckpt = setup
    pipe_j, pipe_t = _pipelines(variables)
    ann_j = {"clip0": TemporalAnnotationJax("clip0.mp4", "Shoplifting", [(5, 12)])}
    ann_t = {"clip0": TemporalAnnotation("clip0.mp4", "Shoplifting", [(5, 12)])}
    out_j, out_t = str(td / "jax"), str(td / "port")
    stats_j = export_jax(pipe_j, videos, out_j, split="Test", annotations=ann_j, verbose=False)
    stats_t = export_poselift_dataset(pipe_t, videos, out_t, split="Test", annotations=ann_t,
                                      verbose=False)
    assert stats_t == stats_j and stats_t["videos"] == 2
    for name in ("clip0", "clip1"):
        _assert_same_poses(_load(out_t, "Test", name), _load(out_j, "Test", name))
        gt = [open(os.path.join(o, "Pickle_files", "GT", f"{name}.npy"), "rb").read()
              for o in (out_t, out_j)]
        assert gt[0] == gt[1]
    labels = np.load(os.path.join(out_t, "Pickle_files", "GT", "clip0.npy"))
    assert labels.sum() == 8 and labels[4:12].all()


def test_extract_needs_keypoints(setup):
    _td, videos, variables, _ckpt = setup
    cfg = get_default_config()
    cfg["detector"].update({**DET, "pose_head": False})
    with pytest.raises(ValueError, match="keypoint source"):
        extract_pose_data(DetectionPipeline(cfg, device="cpu"), videos[0])


def test_pose_export_cli(setup, tmp_path):
    """cli.pose_export on the float checkpoint agrees with the JAX CLI's
    (Train split); on an int8 checkpoint from the port's quantize CLI it
    builds the int8 detector without --set, and writes the pickles the
    library gives for that checkpoint, bit for bit."""
    _td, videos, _variables, ckpt = setup
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    pose_export_jax(["--videos", *videos, "--output", out_j, "--detector_checkpoint", ckpt,
                     "--set", "detector.batch_size=4", "--set", "detector.conf_threshold=0.0",
                     "--set", "detector.max_detections=2", "--set", "detector.native_decode=false"])
    pose_export.main(["--videos", *videos, "--output", out_t, "--detector_checkpoint", ckpt,
                      "--set", "detector.batch_size=4", "--set", "detector.conf_threshold=0.0",
                      "--set", "detector.max_detections=2", "--device", "cpu"])
    for name in ("clip0", "clip1"):
        _assert_same_poses(_load(out_t, "Train", name), _load(out_j, "Train", name))

    q = str(tmp_path / "int8.msgpack")
    quantize_detector.main(["--detector_checkpoint", ckpt, "--output", q, "--calib_frames", "4",
                            "--calib_batch", "2", "--device", "cpu"])
    out_q = str(tmp_path / "int8")
    pose_export.main(["--videos", videos[0], "--output", out_q, "--detector_checkpoint", q,
                      "--set", "detector.conf_threshold=0.0", "--device", "cpu"])
    from cvsd_tpu_torch.cli.common import load_detector_cli

    cfg = get_default_config()
    cfg["detector"]["conf_threshold"] = 0.0
    sd, cfg = load_detector_cli(q, cfg)
    cfg["detector"]["pose_head"] = True
    pipe = DetectionPipeline(cfg, state_dict=sd, device="cpu")
    assert type(pipe.model).__name__ == "QuantPersonDetector"
    ref = extract_pose_data(pipe, videos[0])
    got = _load(out_q, "Train", "clip0")
    assert got.keys() == ref.keys() and len(got) == 24
    for frame, people in ref.items():
        for pid, (box, kpts) in people.items():
            np.testing.assert_array_equal(got[frame][pid][0], box)
            np.testing.assert_array_equal(got[frame][pid][1], kpts)
