"""A whole run, with the look for a card skipped, on a program broken
underneath: ``correct`` comes out false, under the cell's own limits."""

import time

import pytest
from conftest import tiny
from harness import cells


CELLS = ["v5m-pose-detect-b128", "yolov5mu-topdown-detect-b32"]


def _run(cell, **detector):
    _, cfg, traffic = tiny(cell)
    cfg["detector"].update(detector)
    return cells.run_cell(cell, 2 ** 33 + 3, 3.0, False, time.perf_counter(), device="cpu",
                          config=cfg, traffic=traffic)


def _detect_outputs_altered(monkeypatch, alter):
    """``alter`` applied to the detect function's outputs (boxes on the
    canvas, scores, valid[, the pose head's keypoints]) where they are made."""
    import cvsd_tpu_torch.pipeline.preprocess as pre

    real = pre.make_detect_fn

    def make(*a, **k):
        fn = real(*a, **k)
        return lambda images: alter(fn(images))

    monkeypatch.setattr(pre, "make_detect_fn", make)


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    # the pose head's cell: the answer for one frame of every batch, each of
    # its detections moved and its score halved, as NMS hands it on (an
    # answer for a frame is all of its detections: the comparison holds the
    # share of detections off, and bfloat16 alone puts a few per cent of
    # them off on some seeds, so one detection in a frame is no answer it sees)
    import cvsd_tpu_torch.models.detector as det_mod

    real = det_mod.batched_nms

    def altered(*a, **k):
        boxes, scores, valid, idx = real(*a, **k)
        boxes, scores = boxes.clone(), scores.clone()
        boxes[0] += 24.0
        scores[0] *= 0.5
        return boxes, scores, valid, idx

    monkeypatch.setattr(det_mod, "batched_nms", altered)
    out = _run("v5m-pose-detect-b128")
    assert not out["correct"], out["checks"]


def test_a_pose_answer_altered_where_it_is_produced(monkeypatch):
    # the top-down cell: the keypoints moved by 4 px as the pose net hands
    # them on (at a test's size most boxes touch the frame's edge, and
    # their keypoints are not judged, so every box's are moved)
    import cvsd_tpu_torch.pipeline.preprocess as pre

    real = pre.pose_from_boxes

    def altered(*a, **k):
        kpts, crops = real(*a, **k)
        kpts = kpts.clone()
        kpts[..., :2] += 4.0
        return kpts, crops

    monkeypatch.setattr(pre, "pose_from_boxes", altered)
    out = _run("yolov5mu-topdown-detect-b32")
    assert not out["correct"], out["checks"]


def test_boxes_alone_altered(monkeypatch):
    # the top-down cell: every box moved 6 canvas px along x, its score and
    # keypoints as they were; the box is then tied to an anchor whose score
    # differs. (The pose head's cell compares no box reading: no share of
    # boxes separates its bfloat16 runs from the float8 control over seeds.)
    def alter(out):
        boxes = out[0].clone()
        boxes[..., 0::2] += 6.0
        return (boxes,) + tuple(out[1:])

    _detect_outputs_altered(monkeypatch, alter)
    out = _run("yolov5mu-topdown-detect-b32")
    assert not out["correct"], out["checks"]


def test_pose_head_keypoints_alone_altered(monkeypatch):
    # the pose head's keypoints moved 4 canvas px; boxes and scores as they were
    def alter(out):
        kpts = out[3].clone()
        kpts[..., :2] += 4.0
        return tuple(out[:3]) + (kpts,) + tuple(out[4:])

    _detect_outputs_altered(monkeypatch, alter)
    out = _run("v5m-pose-detect-b128")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_another_frames_detections_served(cell, monkeypatch):
    # each frame is served the detections of the frame before it in the batch
    _detect_outputs_altered(monkeypatch, lambda out: tuple(o.roll(1, 0) for o in out))
    out = _run(cell)
    assert not out["correct"], out["checks"]


# At a test's size the pose head's boxes are about a stride wide and seldom
# overlap, so NMS at the cell's 0.45 keeps every candidate it is given; at
# 0.05 it has work to do. The sound program at that threshold is correct.
NMS_TEST = {"v5m-pose-detect-b128": {"iou_threshold": 0.05}, "yolov5mu-topdown-detect-b32": {}}


@pytest.mark.parametrize("cell", CELLS)
def test_nms_skipped(cell, monkeypatch):
    import cvsd_tpu_torch.ops.nms as nms_mod

    sound = _run(cell, **NMS_TEST[cell])
    assert sound["correct"], sound["checks"]
    keep_all = lambda boxes, alive, thr: alive > 0.5  # noqa: E731
    monkeypatch.setattr(nms_mod, "nms_fixpoint_op", keep_all)
    monkeypatch.setattr(nms_mod, "nms_seq_op", keep_all)
    out = _run(cell, **NMS_TEST[cell])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out(cell, monkeypatch):
    import cvsd_tpu_torch.models.detector as det_mod

    real = det_mod.batched_nms

    def left_out(*a, **k):
        boxes, scores, valid, idx = real(*a, **k)
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False  # the batch's second half is served nothing
        return boxes, scores, valid, idx

    monkeypatch.setattr(det_mod, "batched_nms", left_out)
    out = _run(cell)
    assert not out["correct"], out["checks"]


def test_the_sound_program_is_correct_at_a_small_size():
    # the cells' limits hold a sound run at a test's size too (else the
    # tests above would prove nothing)
    for cell in CELLS:
        out = _run(cell)
        assert all(c["limit"] is not None for c in out["checks"].values())
        assert out["correct"], (cell, out["checks"])
