"""The port's NMS against the JAX reference on the CPU.

Keep masks, valid, anchor_idx, boxes and scores must match EXACTLY: both
sides gather from identical float32 inputs, and the IoU is computed in the
same operation order, so there is nothing to round differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.ops.nms import batched_nms as batched_nms_jax
from cvsd_tpu.ops.nms import nms_fixpoint_jax, nms_jax, nms_pallas_fixpoint
from cvsd_tpu_torch.config import get_default_config
from cvsd_tpu_torch.ops.iou import box_iou_matrix
from cvsd_tpu_torch.ops.nms import (batched_nms, nms_fixpoint, nms_fixpoint_torch,
                                    nms_torch, prefilter, suppress_torch)
from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _numpy_greedy_nms(boxes, iou_t):
    n = len(boxes)
    keep = np.ones(n, bool)
    for i in range(n):
        if not keep[i]:
            continue
        for j in range(i + 1, n):
            if not keep[j]:
                continue
            xx1 = max(boxes[i, 0], boxes[j, 0]); yy1 = max(boxes[i, 1], boxes[j, 1])
            xx2 = min(boxes[i, 2], boxes[j, 2]); yy2 = min(boxes[i, 3], boxes[j, 3])
            inter = max(xx2 - xx1, 0) * max(yy2 - yy1, 0)
            a1 = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
            a2 = (boxes[j, 2] - boxes[j, 0]) * (boxes[j, 3] - boxes[j, 1])
            if inter / max(a1 + a2 - inter, 1e-9) > iou_t:
                keep[j] = False
    return keep


def _random_boxes(rng, n, lo=50, hi=590):
    cxy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(20, 120, (n, 2))
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], 1).astype(np.float32)


def _chain(K):
    boxes = np.zeros((1, K, 4), np.float32)
    for i in range(K):
        boxes[0, i] = [i * 6.0, 0.0, i * 6.0 + 10.0, 10.0]  # neighbour IoU = 0.25
    return boxes


def _cases():
    """(name, boxes (B,K,4), alive (B,K), iou_thresh) — the fixpoint cases of
    tests/test_ops_detector.py plus a ragged K = 84 batch."""
    rng = np.random.default_rng(0)
    base = _random_boxes(rng, 64)
    yield "random", np.stack([base + 7 * i for i in range(5)]), np.ones((5, 64), np.float32), 0.45
    yield "chain", _chain(64), np.ones((1, 64), np.float32), 0.2
    dead = np.asarray([[[0, 0, 10, 10], [1, 1, 11, 11], [100, 100, 110, 110]]], np.float32)
    yield "initial_dead", dead, np.asarray([[0.0, 1.0, 1.0]], np.float32), 0.45
    over = np.tile(np.array([[10, 10, 50, 50]], np.float32), (32, 1))
    over = over + rng.normal(0, 0.5, over.shape).astype(np.float32)
    yield "all_overlap", over[None], np.ones((1, 32), np.float32), 0.5
    zero = np.asarray([[[5, 5, 5, 5], [0, 0, 10, 10]]], np.float32)
    yield "zero_area", zero, np.ones((1, 2), np.float32), 0.45
    ragged = np.stack([_random_boxes(rng, 84, 10, 120) for _ in range(3)])
    alive = (rng.uniform(size=(3, 84)) > 0.2).astype(np.float32)
    yield "ragged_k84", ragged, alive, 0.45


@pytest.mark.parametrize("case", list(_cases()), ids=lambda c: c[0])
def test_nms_fixpoint_torch_matches_jax(case):
    _name, boxes, alive, t = case
    ref = np.asarray(nms_fixpoint_jax(jnp.asarray(boxes), jnp.asarray(alive), t))
    pallas = np.asarray(nms_pallas_fixpoint(jnp.asarray(boxes), jnp.asarray(alive), t, group=2))
    np.testing.assert_array_equal(pallas, ref)
    got = nms_fixpoint_torch(torch.from_numpy(boxes), torch.from_numpy(alive), t).numpy()
    np.testing.assert_array_equal(got, ref)
    # the dispatching wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        nms_fixpoint(torch.from_numpy(boxes), torch.from_numpy(alive), t).numpy(), ref)
    # the sequential greedy loop gives the same mask
    tb = torch.from_numpy(boxes)
    np.testing.assert_array_equal(
        suppress_torch(box_iou_matrix(tb, tb), torch.from_numpy(alive) > 0.5, t).numpy(), ref)
    for b in range(boxes.shape[0]):
        if alive[b].all():
            np.testing.assert_array_equal(got[b], _numpy_greedy_nms(boxes[b], t))


def test_nms_torch_sequential_matches_jax():
    boxes = _random_boxes(np.random.default_rng(1), 64)
    scores = np.sort(np.random.default_rng(2).uniform(0.01, 1.0, 64).astype(np.float32))[::-1].copy()
    ref = np.asarray(nms_jax(jnp.asarray(boxes), jnp.asarray(scores), 0.5))
    got = nms_torch(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5).numpy()
    np.testing.assert_array_equal(got, ref)


def _batched_inputs():
    rng = np.random.default_rng(3)
    B, A = 3, 120
    boxes = np.stack([_random_boxes(rng, A, 20, 200) for _ in range(B)])
    scores = rng.uniform(size=(B, A)).astype(np.float32)
    yield "random", boxes, scores, dict(conf_thresh=0.25, max_detections=16, pre_topk=32)
    # many EXACTLY equal scores (letterbox pad regions, bf16 heads): the
    # stable top-K must keep the lower anchor first, like lax.top_k
    eq = np.round(rng.uniform(size=(B, A)) * 4).astype(np.float32) / 4
    yield "equal_scores", boxes, eq, dict(conf_thresh=0.2, max_detections=24, pre_topk=40)
    yield "k84", boxes[:, :84], scores[:, :84], dict(conf_thresh=0.0, max_detections=100,
                                                      pre_topk=256)
    low = np.full((B, A), 0.1, np.float32)
    yield "none_above_conf", boxes, low, dict(conf_thresh=0.5, max_detections=4, pre_topk=8)
    zero = np.asarray([[[5, 5, 5, 5], [0, 0, 10, 10]]], np.float32)
    yield "zero_area", zero, np.asarray([[0.9, 0.8]], np.float32), dict(
        conf_thresh=0.1, max_detections=4, pre_topk=2)


@pytest.mark.parametrize("jax_method", ["pallas_fixpoint", "fixpoint", "xla"])
@pytest.mark.parametrize("case", list(_batched_inputs()), ids=lambda c: c[0])
def test_batched_nms_matches_jax_exactly(case, jax_method):
    """The port's one batched_nms equals each of the reference's methods."""
    _name, boxes, scores, kw = case
    ref = [np.asarray(o) for o in batched_nms_jax(jnp.asarray(boxes), jnp.asarray(scores),
                                                  method=jax_method, **kw)]
    got = [o.numpy() for o in batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                          **kw)]
    for name, r, g in zip(("boxes", "scores", "valid", "anchor_idx"), ref, got):
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_prefilter_stable_on_ties():
    scores = torch.tensor([[0.5, 0.7, 0.5, 0.7, 0.5]])
    boxes = torch.zeros(1, 5, 4)
    top_scores, top_idx, _, alive = prefilter(boxes, scores, 0.0, 5)
    assert top_idx.tolist() == [[1, 3, 0, 2, 4]]
    assert alive.all()


def _pipeline_with_nms_method(method):
    cfg = get_default_config()
    cfg["detector"].update(nms_method=method, img_size=64, width_mult=0.25, depth_mult=0.34,
                           dtype="float32")
    return DetectionPipeline(cfg, device="cpu")


def test_pallas_seq_is_accepted():
    """'pallas_seq' (the sequential kernel, csrc/nms_seq.cu) builds a pipeline
    whose detections equal the default 'pallas_fixpoint' pipeline's: both
    compute the same greedy mask."""
    frames = np.random.default_rng(5).integers(0, 256, (2, 48, 64, 3)).astype(np.uint8)
    seq = _pipeline_with_nms_method("pallas_seq").detect_frames(frames)
    fix = _pipeline_with_nms_method("pallas_fixpoint").detect_frames(frames)
    for s, f in zip(seq, fix):
        np.testing.assert_array_equal(s, f)


@pytest.mark.parametrize("method", ["fixpoint", "xla"])
def test_only_the_kernel_nms_method_is_accepted(method):
    """Only the kernel methods ('pallas_fixpoint', 'pallas_seq') are ported;
    the pipeline refuses the plain-XLA ones before building a model."""
    with pytest.raises(NotImplementedError, match="pallas_fixpoint"):
        _pipeline_with_nms_method(method)


def test_unknown_nms_method_raises():
    with pytest.raises(ValueError, match="unknown NMS method"):
        _pipeline_with_nms_method("bogus")
