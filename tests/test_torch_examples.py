"""The port's end-to-end examples (``examples_torch/``) against the JAX
package's (``examples/``) on the CPU, at the smallest size: the rendered
data for the seeds the examples use; the synthetic chain's stream-and-
evaluate stage and Pipeline A's preprocess -> windows -> ``predict_proba``
with test-size weights carried across from flax; and each script's ``main``
run as a subprocess at its smallest flags."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.data import render as render_jax
from cvsd_tpu.data.bbox_schema import read_bboxes as read_bboxes_jax
from cvsd_tpu.data.synthetic import SyntheticPoseLiftDataset as SyntheticJax
from cvsd_tpu.data.ucf_crime import ANOMALY_CSV, NORMAL_CSV
from cvsd_tpu.data.video import VideoBatcher as VideoBatcherJax
from cvsd_tpu.eval.evaluate import ShopformerScorer as ShopformerScorerJax
from cvsd_tpu.eval.streaming_eval import evaluate_streaming as evaluate_streaming_jax
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.pose_topdown import TopDownPoseNet as TopDownPoseNetJax
from cvsd_tpu.models.shopformer import build_shopformer as build_shopformer_jax
from cvsd_tpu.models.xception_time import XceptionTime as XceptionTimeJax
from cvsd_tpu.models.xception_time import XceptionTimeClassifier as XceptionTimeClassifierJax
from cvsd_tpu.models.xception_time import windows_from_bbox_csv as windows_jax
from cvsd_tpu.pipeline.preprocess import DetectionPipeline as DetectionPipelineJax
from cvsd_tpu.pipeline.preprocess import preprocess_ucf_crime as preprocess_jax
from cvsd_tpu.pipeline.streaming import StreamingPipeline as StreamingPipelineJax
from cvsd_tpu.utils.metrics import compute_auc_roc as compute_auc_roc_jax
from cvsd_tpu_torch.data import render
from cvsd_tpu_torch.data.bbox_schema import read_bboxes
from cvsd_tpu_torch.data.synthetic import SyntheticPoseLiftDataset
from cvsd_tpu_torch.eval.evaluate import ShopformerScorer
from cvsd_tpu_torch.eval.streaming_eval import evaluate_streaming
from cvsd_tpu_torch.models.detector import build_detector
from cvsd_tpu_torch.models.pose_topdown import TopDownPoseNet
from cvsd_tpu_torch.models.shopformer import build_shopformer
from cvsd_tpu_torch.models.xception_time import XceptionTimeClassifier
from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline
from cvsd_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from torch_testutil import random_flax_variables

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parent.parent
IMG = 64
# the fixture limits of tests/test_torch_streaming.py (events) and
# tests/test_torch_tabular.py (probabilities, relative to the largest)
TOL_SCORE = 1e-4
TOL_PROBA = 1e-5


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


synthetic = _load(REPO / "examples_torch" / "end_to_end_synthetic.py", "e2e_synthetic_torch")
pipeline_a = _load(REPO / "examples_torch" / "end_to_end_pipeline_a.py", "e2e_pipeline_a_torch")
pipeline_a_jax = _load(REPO / "examples" / "end_to_end_pipeline_a.py", "e2e_pipeline_a_jax")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cv2_decode_in_jax(monkeypatch):
    # the reference's batcher picks its native decoder wherever it is built,
    # and that decoder fails its parity tests on this host
    monkeypatch.setattr(VideoBatcherJax, "_native_decode_available", staticmethod(lambda: False))


def _auc_bound(labels, ref_scores, gap):
    """How far an AUC may move when every score moves by at most ``gap``:
    only a positive and a negative whose reference scores lie within
    2 * gap can change order, each by 1 / (positives x negatives)."""
    labels, s = np.asarray(labels, bool), np.asarray(ref_scores, np.float64)
    pos, neg = s[labels], s[~labels]
    close = np.abs(pos[:, None] - neg[None, :]) <= 2 * gap
    return float(close.sum()) / max(len(pos) * len(neg), 1)


def _same_files(a: Path, b: Path):
    names = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file()) and names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def test_example_data_matches_jax(tmp_path):
    """What the examples render from their seeds is the JAX examples' data:
    the first detector and pose-crop batches of ``default_rng(0)`` at the
    examples' shapes, the pose datasets of the synthetic chain's seeds (20,
    30, 31), one of its videos, and Pipeline A's dataset directory (videos
    and list) byte for byte. Other seeds and shapes:
    tests/test_torch_detection_data.py."""
    for name, args in (("rendered_detection_batch", (8, 128)), ("rendered_pose_crop_batch", (32,))):
        got = getattr(render, name)(np.random.default_rng(0), *args)
        ref = getattr(render_jax, name)(np.random.default_rng(0), *args)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    for seed, ratio in ((20, 0.0), (30, 0.0), (31, 1.0)):
        np.testing.assert_array_equal(
            SyntheticPoseLiftDataset(2, seq_len=synthetic.T_VID, anomaly_ratio=ratio, seed=seed).poses,
            SyntheticJax(2, seq_len=synthetic.T_VID, anomaly_ratio=ratio, seed=seed).poses)
    poses = SyntheticPoseLiftDataset(1, seq_len=8, anomaly_ratio=1.0, seed=31).poses[0]
    a = render.render_pose_video(str(tmp_path / "a.mp4"), poses, seed=300)
    b = render_jax.render_pose_video(str(tmp_path / "b.mp4"), poses, seed=300)
    assert Path(a).read_bytes() == Path(b).read_bytes()
    pipeline_a.build_dataset_dir(str(tmp_path / "port"), "train", 1, 8, seed0=40)
    pipeline_a_jax.build_dataset_dir(str(tmp_path / "jax"), "train", 1, 8, seed0=40)
    _same_files(tmp_path / "port" / "train", tmp_path / "jax" / "train")


def _detector_variables(seed):
    det = PersonDetectorJax(img_size=IMG, width_mult=0.25, depth_mult=0.34, dtype=jnp.float32)
    return random_flax_variables(
        lambda: det.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, IMG, IMG, 3)),
                         train=False), seed)


def _stream_config(cfg):
    """The synthetic example's configurations (detector, then the scorer's
    recipe), cut to the test size: random weights keep boxes at conf 0."""
    cfg["detector"].update(img_size=IMG, width_mult=0.25, depth_mult=0.34, batch_size=16,
                           conf_threshold=0.0, max_detections=2, dtype="float32",
                           pose_mode="topdown", native_decode=False,
                           pose_topdown={"num_keypoints": 17, "width": 8, "crop_size": 32})
    cfg["data"].update(batch_size=64, stride=6)
    cfg["model"].update(hidden_channels=8, num_tokens=4)
    return cfg


def test_synthetic_stream_and_evaluate_matches_jax(tmp_path, cv2_decode_in_jax):
    """Stage 4 of the synthetic chain on one normal and one anomalous
    rendered video (72 frames), with test-size detector, pose-net and
    Shopformer weights carried from flax: the JAX example's calls and
    ``stream_and_evaluate`` give the same event keys, frames and stamps,
    scores within 1e-4 of the largest; the port's evaluation of the
    reference's events equal to the reference's; and the stage's own event
    AUCs and max-aggregated video AUC equal to the reference's to 1e-6."""
    _, test_videos, annotations, truth = synthetic.render_videos(str(tmp_path), 0, 2)
    cfg_t = _stream_config(synthetic.detection_config(IMG))
    cfg_j = _stream_config(get_default_config_jax())
    det_vars = _detector_variables(51)
    pose_j = TopDownPoseNetJax(num_keypoints=17, width=8, crop_size=32)
    pose_vars = random_flax_variables(lambda: pose_j.init_variables(jax.random.PRNGKey(0)), 52)
    # a peaked heatmap head: at 1/sqrt(fan_in) every keypoint sits near its
    # crop's centre, and normalize_sequence magnifies the packages' float32
    # keypoint gap ~100x into the scores (5.4e-4 here, 2.3e-5 with the head)
    pose_vars["params"]["Conv_6"]["kernel"] = pose_vars["params"]["Conv_6"]["kernel"] * 20
    sf_j = build_shopformer_jax(cfg_j)
    sf_vars = random_flax_variables(lambda: sf_j.init_variables(jax.random.PRNGKey(0)), 53)

    out_j = StreamingPipelineJax(cfg_j, ShopformerScorerJax(sf_j, sf_vars, cfg_j),
                                 detector_variables=det_vars, pose_model=pose_j,
                                 pose_variables=pose_vars).stream_videos_concurrent(
        test_videos, max_streams=8)
    ref = {how: evaluate_streaming_jax(out_j["events"], list(annotations.values()),
                                       include_eventless_videos=test_videos,
                                       aggregation=how).as_dict()
           for how in ("max", "mean")}

    sf_t = build_shopformer(cfg_t, device="cpu")
    sf_t.load_state_dict(flax_to_state_dict(sf_vars, sf_t))
    pose_t = load_flax_variables(TopDownPoseNet(17, 8, 32), pose_vars).eval()
    det_sd = flax_to_state_dict(det_vars, build_detector(cfg_t, device="cpu"))
    got = synthetic.stream_and_evaluate(cfg_t, ShopformerScorer(sf_t, cfg_t, device="cpu"),
                                        det_sd, pose_t, test_videos, annotations, truth, [],
                                        torch.device("cpu"))
    ev_t, ev_j = got["events"], out_j["events"]
    key = lambda e: (e.video, e.track_id, e.frame_end)  # noqa: E731
    assert len(ev_t) > 10 and sorted(map(key, ev_t)) == sorted(map(key, ev_j))
    by_key = {key(e): e for e in ev_j}
    top = max(abs(e.score) for e in ev_j)
    for e in ev_t:
        r = by_key[key(e)]
        assert e.frames == r.frames and e.timestamp_ms == r.timestamp_ms, key(e)
        assert abs(e.score - r.score) <= TOL_SCORE * top, key(e)
    assert got["frames"] == out_j["frames"] == 144
    # evaluation: the port's evaluate_streaming on the reference's events
    # gives the reference's results
    for how in ("max", "mean"):
        mine = evaluate_streaming(ev_j, list(annotations.values()),
                                  include_eventless_videos=test_videos, aggregation=how)
        assert mine.as_dict() == ref[how], how
    # the stage's own AUCs: each event moved by at most ``gap``, so a video's
    # max moved by at most ``gap``, and the AUC is well posed where the two
    # videos' maxima lie more than 2 * gap apart. Their means do not: with
    # random weights both videos' windows score alike and the means tie to
    # ~1e-6, below the float32 gap, so the mean aggregation is held above.
    gap = max(abs(e.score - by_key[key(e)].score) for e in ev_t)
    a, n = (max(e.score for e in ev_j if e.video.startswith(f"test_{kind}"))
            for kind in ("anomalous", "normal"))
    assert abs(a - n) > 2 * gap, (a, n, gap)
    g, r = got["streaming"]["max"], ref["max"]
    assert g["n_videos"] == r["n_videos"] == 2 and g["n_events"] == r["n_events"]
    for k in ("video_auc", "event_auc"):
        assert np.isfinite(g[k]) and abs(g[k] - r[k]) <= 1e-6, k
    assert abs(got["streaming"]["mean"]["event_auc"] - ref["mean"]["event_auc"]) <= 1e-6
    assert {v["label"] for v in got["videos"].values()} == {0, 1}


def test_pipeline_a_preprocess_to_auc_matches_jax(tmp_path, cv2_decode_in_jax):
    """Pipeline A's held-out half on one video per class (40 frames): the
    port's ``preprocess_splits`` and the JAX ``preprocess_ucf_crime`` with
    carried detector weights write the same rows, boxes within 2e-3 px of
    the source size (tests/test_torch_pipeline_a.py's limit: the float32
    detectors sum in another order, and the CSV prints every digit); an XceptionTime
    classifier written by the JAX package and loaded by the port gives
    probabilities within 1e-5 of the largest and the window and video AUCs
    of the JAX example's stage 5 through ``evaluate_classifier``, on the
    reference's CSVs, each within what the probabilities' gap can reorder."""
    dir_t = pipeline_a.build_dataset_dir(str(tmp_path / "port"), "test", 1, 40, seed0=60)
    dir_j = pipeline_a_jax.build_dataset_dir(str(tmp_path / "jax"), "test", 1, 40, seed0=60)
    det_vars = _detector_variables(61)
    cfg_t = pipeline_a.detection_config(IMG)
    cfg_j = get_default_config_jax()
    for c in (cfg_t, cfg_j):
        c["detector"].update(img_size=IMG, width_mult=0.25, depth_mult=0.34, batch_size=16,
                             conf_threshold=0.0, max_detections=4, dtype="float32",
                             host_letterbox="content", native_decode=False)
    pipe = DetectionPipeline(cfg_t, state_dict=flax_to_state_dict(
        det_vars, build_detector(cfg_t, device="cpu")), device="cpu")
    pipeline_a.preprocess_splits(cfg_t, pipe, {"test": dir_t}, max_streams=2)
    preprocess_jax(cfg_j, dir_j, pipeline=DetectionPipelineJax(cfg_j, variables=det_vars),
                   verbose=False, max_streams=2)
    key = ("clip", "name", "frame", "person", "is_anomaly", "anomaly")
    for name in (ANOMALY_CSV, NORMAL_CSV):
        rows_t = read_bboxes(os.path.join(dir_t, name))
        rows_j = read_bboxes_jax(os.path.join(dir_j, name))
        assert len(rows_t) == len(rows_j) > 0, name
        assert [tuple(getattr(r, k) for k in key) for r in rows_t] == \
               [tuple(getattr(r, k) for k in key) for r in rows_j]
        for field, size in (("left", 320), ("top", 240), ("width", 320), ("height", 240)):
            np.testing.assert_allclose([getattr(r, field) * size for r in rows_t],
                                       [getattr(r, field) * size for r in rows_j],
                                       rtol=0, atol=2e-3, err_msg=field)

    seq_len, stride = 16, 8
    csvs_j = [os.path.join(dir_j, ANOMALY_CSV), os.path.join(dir_j, NORMAL_CSV)]
    Xt, yt, clips = windows_jax(csvs_j, seq_len=seq_len, stride=stride, return_clips=True)
    clf_j = XceptionTimeClassifierJax(seq_len=seq_len, num_channels=Xt.shape[-1], nf=4)
    clf_j.variables = random_flax_variables(
        lambda: XceptionTimeJax(num_classes=2, nf=4).init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, seq_len, Xt.shape[-1])),
            train=False), 62, conv1d=True)
    clf_j.standardizer.fit(Xt)
    clf_j.save(str(tmp_path / "xt.msgpack"))
    p_ref = clf_j.predict_proba(Xt)[:, 1]
    window_auc, _, _ = compute_auc_roc_jax(yt, p_ref)
    vids = {}
    for c, p, lab in zip(clips, p_ref, yt):
        vids.setdefault(int(c), {"probs": [], "label": int(lab)})["probs"].append(float(p))
    labels = [v["label"] for v in vids.values()]
    mean_auc = compute_auc_roc_jax(labels, [float(np.mean(v["probs"])) for v in vids.values()])[0]
    max_auc = compute_auc_roc_jax(labels, [float(np.max(v["probs"])) for v in vids.values()])[0]

    clf_t = XceptionTimeClassifier.load(str(tmp_path / "xt.msgpack"), device="cpu")
    # the reference's CSVs: the port's rows differ from them in the last digits
    metrics, probs = pipeline_a.evaluate_classifier(clf_t, dir_j, seq_len, stride)
    gap = float(np.max(np.abs(probs - p_ref)))
    assert gap <= TOL_PROBA * np.max(np.abs(p_ref))
    assert metrics["test_windows"] == len(yt) and metrics["test_videos"] == len(vids) == 2
    # random weights leave windows tied to an ulp, so an AUC is held to the
    # pairs that the probabilities' gap can reorder (0 where none can), plus
    # the stage's rounding to 4 digits
    v_mean = [float(np.mean(v["probs"])) for v in vids.values()]
    v_max = [float(np.max(v["probs"])) for v in vids.values()]
    for k, r, bound in (("window_auc", window_auc, _auc_bound(yt, p_ref, gap)),
                        ("video_auc_mean_agg", mean_auc, _auc_bound(labels, v_mean, gap)),
                        ("video_auc_max_agg", max_auc, _auc_bound(labels, v_max, gap))):
        assert abs(metrics[k] - float(r)) <= bound + 5e-5, (k, metrics[k], r, bound)
    assert _auc_bound(yt, p_ref, gap) < 0.05  # the window AUC is held, not waved through


# the keys each JAX example writes (examples/end_to_end_*.py)
SYNTHETIC_KEYS = {"videos", "frames", "fps", "extracted_pose_auc", "video_metrics", "streaming",
                  "frame_stride"}
PIPELINE_A_KEYS = {"window_auc", "video_auc_mean_agg", "video_auc_max_agg", "test_windows",
                   "test_videos", "train_windows", "preprocess", "config"}


def _run(script, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, str(REPO / "examples_torch" / script), "--device", "cpu",
                        *args], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "stage_seconds" in r.stdout
    return r


def _auc(x):
    return np.isfinite(x) and 0.0 <= x <= 1.0


def test_synthetic_example_runs_on_the_cpu(tmp_path):
    """The synthetic chain's ``main`` at its smallest flags writes the JAX
    example's keys with finite AUCs in [0, 1]."""
    _run("end_to_end_synthetic.py", "--steps", "2", "--pose-steps", "2", "--train-videos", "2",
         "--test-videos", "2", "--epochs", "1", "--img_size", "64", "--out", str(tmp_path))
    res = json.loads((tmp_path / "e2e_results.json").read_text())
    assert set(res) == SYNTHETIC_KEYS
    assert _auc(res["extracted_pose_auc"]) and res["frames"] == 144 and len(res["videos"]) == 2
    for how in ("max", "mean"):
        assert _auc(res["streaming"][how]["video_auc"]) and _auc(res["streaming"][how]["event_auc"])
    assert _auc(res["frame_stride"]["1"]["video_auc"])


def test_pipeline_a_example_runs_on_the_cpu(tmp_path):
    """Pipeline A's ``main`` at its smallest flags (4 epochs: XceptionTime's
    one-cycle schedule is NaN below 4 steps, as the reference's) writes the
    JAX example's keys with finite AUCs in [0, 1]."""
    art = tmp_path / "r.json"
    _run("end_to_end_pipeline_a.py", "--videos-per-class", "2", "--test-per-class", "1",
         "--frames", "40", "--img", "64", "--det-steps", "2", "--epochs", "4", "--seq-len", "16",
         "--stride", "8", "--out", str(tmp_path), "--artifact", str(art))
    res = json.loads(art.read_text())
    assert set(res) == PIPELINE_A_KEYS
    for k in ("window_auc", "video_auc_mean_agg", "video_auc_max_agg"):
        assert _auc(res[k]), k
    assert res["test_videos"] == 2 and res["preprocess"]["train"]["videos"] == 4


def test_examples_name_cv2_without_it(tmp_path):
    """Without cv2 each example stops before any work, naming cv2."""
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "cv2.py").write_text("raise ImportError('no cv2 here')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(stub)] + [p for p in [os.environ.get("PYTHONPATH")]
                                                         if p]))
    for script in ("end_to_end_synthetic.py", "end_to_end_pipeline_a.py"):
        r = subprocess.run([sys.executable, str(REPO / "examples_torch" / script), "--device",
                            "cpu", "--out", str(tmp_path / "o")], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and "cv2" in r.stderr, script
        assert not (tmp_path / "o").exists()
