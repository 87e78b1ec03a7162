"""The port's detector data and evaluation against the JAX package on the
CPU: the renderer (cvsd_tpu_torch/data/render.py) bit for bit from the same
seeds, the YOLO-format loader on a layout written with cv2, detection
mAP / OKS (eval/detection.py) on fixed lists and through evaluate_detector
with the test-sized detector (img 64, width 0.25, depth 0.34, float32) and
the same flax weights, and the top-down pose trainer's loss and step."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.data import render as jrender
from cvsd_tpu.data import yolo_dataset as jyolo
from cvsd_tpu.eval import detection as jdet
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.detector import make_detect_fn as make_detect_fn_jax
from cvsd_tpu.models.pose_topdown import TopDownPoseNet as TopDownPoseNetJax
from cvsd_tpu.train import pose_topdown_train as jpt
from cvsd_tpu_torch.data import render, yolo_dataset
from cvsd_tpu_torch.eval import detection
from cvsd_tpu_torch.models.detector import PersonDetector, make_detect_fn
from cvsd_tpu_torch.models.pose_topdown import TopDownPoseNet
from cvsd_tpu_torch.train.pose_topdown_train import TopDownPoseTrainer, pose_loss
from cvsd_tpu_torch.utils.weights import load_flax_variables
from torch_testutil import random_flax_variables, write_yolo_layout

S = 64


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _equal(a, b):
    """Nested tuples / dicts of arrays and scalars equal bit for bit (NaN == NaN)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f")


# -- the renderer --------------------------------------------------------------------


@pytest.mark.parametrize("name,args,kwargs", [
    ("rendered_detection_batch", (3, 48), {}),
    ("render_scene", (40, 56), {"max_persons": 3}),
    ("rendered_scene_batch", (2, 64), {"max_persons": 4}),
    ("rendered_pose_crop_batch", (3,), {"frame_size": 48}),
])
def test_render_bit_identical(name, args, kwargs):
    """The same seed gives the same frames, boxes, keypoints and visibility."""
    for seed in (0, 11):
        got = getattr(render, name)(np.random.default_rng(seed), *args, **kwargs)
        ref = getattr(jrender, name)(np.random.default_rng(seed), *args, **kwargs)
        _equal(got, ref)


def test_render_pose_frame_and_video_bit_identical(tmp_path):
    from cvsd_tpu_torch.data.synthetic import SyntheticPoseLiftDataset

    poses = SyntheticPoseLiftDataset(1, seq_len=4, seed=3).poses[0]
    _equal(render.render_pose_frame(poses[0], 60, 80, np.random.default_rng(1)),
           jrender.render_pose_frame(poses[0], 60, 80, np.random.default_rng(1)))
    pytest.importorskip("cv2")
    a = render.render_pose_video(str(tmp_path / "a.mp4"), poses, 80, 60, seed=2)
    b = jrender.render_pose_video(str(tmp_path / "b.mp4"), poses, 80, 60, seed=2)
    assert open(a, "rb").read() == open(b, "rb").read()


# -- the YOLO-format loader ------------------------------------------------------------


def test_yolo_loader_matches_jax(tmp_path):
    """Labels (NaN for invisible keypoints), samples, seeded batches with a
    zero-padded last batch and data.yaml: equal to the JAX package's."""
    img_dir, lbl_dir = write_yolo_layout(str(tmp_path))
    assert yolo_dataset._labels_dir_for(img_dir) == jyolo._labels_dir_for(img_dir) == lbl_dir
    for f in ("im0.txt", "im1.txt", "missing.txt"):
        for kw in ({}, {"num_keypoints": 4}, {"classes": None, "num_keypoints": 4}):
            _equal(yolo_dataset.parse_yolo_label(os.path.join(lbl_dir, f), **kw),
                   jyolo.parse_yolo_label(os.path.join(lbl_dir, f), **kw))
    kw = dict(img_size=S, max_persons=3, num_keypoints=4)
    ds, jds = yolo_dataset.YOLODetectionDataset(img_dir, **kw), jyolo.YOLODetectionDataset(img_dir, **kw)
    assert ds.files == jds.files and ds.labels_dir == jds.labels_dir
    for i in range(len(ds)):
        _equal(ds.load(i), jds.load(i))
    _equal(list(ds.batches(3, rng=np.random.default_rng(5))),
           list(jds.batches(3, rng=np.random.default_rng(5))))
    assert not ds.load(len(ds) - 1)[2].any()  # the background image
    with open(tmp_path / "data.yaml", "w") as f:
        f.write(f"path: {tmp_path}\ntrain: images/train\nkpt_shape: [4, 3]\n")
    a = yolo_dataset.YOLODetectionDataset.from_data_yaml(str(tmp_path / "data.yaml"), img_size=S)
    b = jyolo.YOLODetectionDataset.from_data_yaml(str(tmp_path / "data.yaml"), img_size=S)
    assert (a.images_dir, a.num_keypoints) == (b.images_dir, b.num_keypoints) == (img_dir, 4)
    with pytest.raises(KeyError, match="val"):
        yolo_dataset.YOLODetectionDataset.from_data_yaml(str(tmp_path / "data.yaml"), split="val")


# -- detection evaluation --------------------------------------------------------------


def _lists(seed=0, n=6, K=17):
    """Per-image predictions and GT: jittered GT plus false positives, an
    image without GT and one without predictions."""
    rng = np.random.default_rng(seed)
    pb, ps, gb, pk, gk = [], [], [], [], []
    for i in range(n):
        m = 0 if i == 2 else int(rng.integers(1, 4))
        xy = rng.uniform(0, 200, (m, 2))
        g = np.concatenate([xy, xy + rng.uniform(20, 80, (m, 2))], 1).astype(np.float32)
        k = (g[:, None, :2] + rng.uniform(0, 20, (m, K, 2))).astype(np.float32)
        keep = rng.uniform(size=m) < 0.8
        p = g[keep] + rng.normal(0, 4, (int(keep.sum()), 4)).astype(np.float32)
        q = k[keep] + rng.normal(0, 3, (int(keep.sum()), K, 2)).astype(np.float32)
        extra = 0 if i == 4 else int(rng.integers(0, 3))
        xy = rng.uniform(0, 200, (extra, 2))
        p = np.concatenate([p, np.concatenate([xy, xy + 30], 1)]).astype(np.float32)
        q = np.concatenate([q, rng.uniform(0, 250, (extra, K, 2))]).astype(np.float32)
        if i == 4:
            p, q = p[:0], q[:0]
        pb.append(p)
        ps.append(rng.uniform(0.2, 1.0, len(p)).astype(np.float32))
        gb.append(g)
        pk.append(q)
        gk.append(k)
    return pb, ps, gb, pk, gk


def test_detection_metrics_match_jax():
    pb, ps, gb, pk, gk = _lists()
    for i in range(len(pb)):
        _equal(detection.match_detections(pb[i], ps[i], gb[i], 0.5),
               jdet.match_detections(pb[i], ps[i], gb[i], 0.5))
        areas = np.clip(gb[i][:, 2] - gb[i][:, 0], 0, None) * np.clip(gb[i][:, 3] - gb[i][:, 1], 0, None)
        _equal(detection.oks_matrix(pk[i], gk[i], areas), jdet.oks_matrix(pk[i], gk[i], areas))
    for t in (0.3, 0.5):
        _equal(detection.detection_pr(pb, ps, gb, t), jdet.detection_pr(pb, ps, gb, t))
    _equal(detection.detection_map(pb, ps, gb), jdet.detection_map(pb, ps, gb))
    _equal(detection.pose_map(pk, ps, gk, gb), jdet.pose_map(pk, ps, gk, gb))
    n = len(gk[0])
    _equal(detection.keypoint_rms(pk[0][:n], gk[0], gb[0]), jdet.keypoint_rms(pk[0][:n], gk[0], gb[0]))
    _equal(detection.keypoint_rms(pk[0][:0], gk[0][:0]), jdet.keypoint_rms(pk[0][:0], gk[0][:0]))


def test_evaluate_detector_matches_jax():
    """The test-sized detector with its 17-keypoint head and the same weights
    on rendered scenes (6 images in chunks of 4, the last one padded): the
    same keep sets, and equal AP, mAP50-95 and OKS pose mAP. The reference
    runs its plain NMS (use_pallas=False), as its own CPU tests do."""
    jm = PersonDetectorJax(img_size=S, width_mult=0.25, depth_mult=0.34, num_keypoints=17,
                           dtype=jnp.float32)
    variables = random_flax_variables(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, S, S, 3)), train=False), 3)
    tm = load_flax_variables(PersonDetector(img_size=S, width_mult=0.25, depth_mult=0.34,
                                            num_keypoints=17, dtype=torch.float32), variables).eval()
    images, boxes, valid, kpts = render.rendered_scene_batch(np.random.default_rng(4), 6, S)
    jdetect = make_detect_fn_jax(jm, conf_thresh=0.5, iou_thresh=0.45, max_detections=32,
                                 use_pallas=False)
    detect = make_detect_fn(tm, conf_thresh=0.5, iou_thresh=0.45, max_detections=32)
    got_valid = detect(torch.from_numpy(images[:4]))[2].numpy()
    assert np.array_equal(got_valid, np.asarray(jdetect(variables, jnp.asarray(images[:4]))[2]))
    assert got_valid.any()
    got = detection.evaluate_detector(detect, images, boxes, valid, kpts, batch_size=4,
                                      coco_map=True, device="cpu")
    ref = jdet.evaluate_detector(jdetect, variables, images, boxes, valid, kpts, batch_size=4,
                                 coco_map=True)
    assert got.keys() == ref.keys() and "keypoints" in got and "pose_map50_95" in got
    for k in ("num_gt", "num_pred"):
        assert got[k] == ref[k]
    for k in ("ap", "map50", "map50_95", "pose_map50", "pose_map50_95"):
        assert abs(got[k] - ref[k]) <= 1e-6, k
    np.testing.assert_allclose(got["precision"], ref["precision"], rtol=0, atol=1e-6)
    for k in ("rms_px", "rms_norm"):
        assert abs(got["keypoints"][k] - ref["keypoints"][k]) <= 1e-4 * ref["keypoints"][k]


def test_evaluate_detector_on_oracle():
    """An oracle detect function returning the GT scores AP 1.0, as in the
    reference's test; the padded chunk is cut off."""
    rng = np.random.default_rng(0)
    gt_boxes = np.zeros((5, 2, 4), np.float32)
    gt_valid = np.zeros((5, 2), bool)
    for b in range(5):
        for p in range(rng.integers(1, 3)):
            x, y = rng.uniform(0, 50, 2)
            gt_boxes[b, p] = [x, y, x + 20, y + 20]
            gt_valid[b, p] = True
    seen = []

    def oracle(imgs):
        n = imgs.shape[0]
        seen.append(n)
        idx = imgs[:, 0, 0, 0].long()
        return (torch.from_numpy(gt_boxes)[idx], torch.where(torch.from_numpy(gt_valid)[idx], 0.9, 0.0),
                torch.from_numpy(gt_valid)[idx] & (imgs[:, 0, 0, 1] > 0)[:, None])

    images = np.zeros((5, 4, 4, 3), np.float32)
    images[:, 0, 0, 0] = np.arange(5)
    images[:, 0, 0, 1] = 1.0
    res = detection.evaluate_detector(oracle, images, gt_boxes, gt_valid, batch_size=4,
                                      device="cpu")
    assert res["ap"] == 1.0 and seen == [4, 4]


# -- the top-down pose trainer ----------------------------------------------------------


@pytest.fixture(scope="module")
def pose_setup():
    jm = TopDownPoseNetJax(num_keypoints=17, width=8, crop_size=32)
    variables = random_flax_variables(lambda: jm.init_variables(jax.random.PRNGKey(0)), 4)
    frames, boxes, kpts = render.rendered_pose_crop_batch(np.random.default_rng(2), 6, 64)
    return jm, variables, (frames, boxes, kpts)


def _pose_stats_gap(model, flax_stats):
    gap = 0.0
    for i in range(6):
        bn, ref = getattr(model, f"BatchNorm_{i}"), flax_stats[f"BatchNorm_{i}"]
        for mine, theirs in ((bn.running_mean, ref["mean"]), (bn.running_var, ref["var"])):
            r = np.asarray(theirs, np.float64)
            gap = max(gap, float(np.abs(mine.detach().numpy() - r).max() / np.abs(r).max()))
    return gap


def test_pose_loss_matches_jax(pose_setup):
    """pose_loss in train mode within 1e-5 relative, the new statistics within
    1e-5; crops are cut inside the loss by the port's crop_and_resize."""
    jm, variables, (frames, boxes, kpts) = pose_setup
    ref, ref_bs = jax.jit(lambda p, b: jpt.pose_loss(jm, p, b, jnp.asarray(frames),
                                                     jnp.asarray(boxes), jnp.asarray(kpts)))(
        variables["params"], variables["batch_stats"])
    m = load_flax_variables(TopDownPoseNet(17, 8, 32), variables).train()
    got = pose_loss(m, torch.from_numpy(frames), torch.from_numpy(boxes), torch.from_numpy(kpts))
    assert abs(float(got.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    assert _pose_stats_gap(m, ref_bs) <= 1e-5


def test_pose_trainer_step_matches_jax(pose_setup, monkeypatch):
    """One TopDownPoseTrainer.train_step from the same variables as the JAX
    package's: the loss within 1e-5 relative, the statistics within 1e-5;
    then train_steps_scan over 2 steps equals 2 train_step calls bit for bit,
    and save writes the JAX package's bytes."""
    jm, variables, (frames, boxes, kpts) = pose_setup
    monkeypatch.setattr(TopDownPoseNetJax, "init_variables",
                        lambda self, rng, batch_size=1: variables)
    jtr = jpt.TopDownPoseTrainer(jm, lr=1e-3, total_steps=10, warmup_steps=2)
    ref = jtr.train_step(frames, boxes, kpts)
    kw = dict(lr=1e-3, total_steps=10, warmup_steps=2, variables=variables, device="cpu")
    tr = TopDownPoseTrainer(TopDownPoseNet(17, 8, 32), **kw)
    got = tr.train_step(frames, boxes, kpts)
    assert abs(got - ref) <= 1e-5 * abs(ref)
    assert _pose_stats_gap(tr.model, jtr.variables["batch_stats"]) <= 1e-5
    second = tr.train_step(frames[::-1].copy(), boxes[::-1].copy(), kpts[::-1].copy())
    scan = TopDownPoseTrainer(TopDownPoseNet(17, 8, 32), **kw)
    losses = scan.train_steps_scan(np.stack([frames, frames[::-1]]), np.stack([boxes, boxes[::-1]]),
                                   np.stack([kpts, kpts[::-1]]))["losses"]
    assert np.array_equal(losses, np.float32([got, second]))
    assert all(torch.equal(a, b) for a, b in zip(tr.model.state_dict().values(),
                                                 scan.model.state_dict().values()))


def test_pose_trainer_save_matches_jax(tmp_path, pose_setup, monkeypatch):
    """save from equal variables writes the JAX package's bytes, which the
    port's loader (re-exported by the trainer's module) reads."""
    from cvsd_tpu_torch.train.pose_topdown_train import load_pose_topdown_checkpoint

    jm, variables, _batch = pose_setup
    monkeypatch.setattr(TopDownPoseNetJax, "init_variables",
                        lambda self, rng, batch_size=1: variables)
    jpt.TopDownPoseTrainer(jm).save(str(tmp_path / "j.msgpack"), step=1)
    TopDownPoseTrainer(TopDownPoseNet(17, 8, 32), variables=variables, device="cpu").save(
        str(tmp_path / "p.msgpack"), step=1)
    assert (tmp_path / "j.msgpack").read_bytes() == (tmp_path / "p.msgpack").read_bytes()
    net = load_pose_topdown_checkpoint(str(tmp_path / "j.msgpack"), device="cpu")
    assert (net.width, net.crop_size) == (8, 32)

