"""The port's sequential greedy NMS (the plain versions of csrc/nms_seq.cu)
against the reference's ``nms_pallas`` and ``nms_pallas_multi`` (Pallas
interpret mode on the CPU) and ``nms_jax``, bit for bit, and
``batched_nms(method="pallas_seq")`` against the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import NEAR_THRESH, near_threshold_boxes
from cvsd_tpu.ops.nms import batched_nms as batched_nms_jax
from cvsd_tpu.ops.nms import nms_jax, nms_pallas, nms_pallas_multi
from cvsd_tpu_torch.config import get_default_config
from cvsd_tpu_torch.models.detector import build_detector, make_detect_fn
from cvsd_tpu_torch.ops.nms import (batched_nms, nms_fixpoint_torch, nms_seq, nms_seq_cuda,
                                    nms_seq_multi, nms_seq_multi_cuda, nms_seq_multi_torch,
                                    nms_seq_torch)

B = 5  # Pallas interpret mode stays fast at B <= 5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cases(K):
    """The seven cases chip_smoke.py holds the kernels to, at (B, K):
    (boxes (B,K,4), alive (B,K) 0/1, iou_thresh). In ``near_threshold`` each
    pair's float32 IoU lies within 2 ulps of the threshold."""
    rng = np.random.default_rng(K)

    def boxes(lo, hi, wmin, wmax):
        cxy = rng.uniform(lo, hi, (B, K, 2))
        wh = rng.uniform(wmin, wmax, (B, K, 2))
        return np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)

    ones = np.ones((B, K), np.float32)
    chain = np.zeros((B, K, 4), np.float32)
    chain[:, :, 0] = np.arange(K) * 6.0  # neighbour IoU 0.25
    chain[:, :, 2] = chain[:, :, 0] + 10.0
    chain[:, :, 3] = 10.0
    over = np.tile(np.array([10, 10, 50, 50], np.float32), (B, K, 1))
    over += rng.normal(0, 0.5, over.shape).astype(np.float32)
    zero = boxes(10, 600, 8, 120)
    zero[:, ::3, 2:] = zero[:, ::3, :2]  # every third box has zero area
    return {
        "random": (boxes(10, 600, 8, 120), ones, 0.45),
        "dense": (boxes(100, 200, 40, 120), ones, 0.45),
        "initial_dead": (boxes(10, 600, 8, 120),
                         (rng.uniform(size=(B, K)) > 0.3).astype(np.float32), 0.45),
        "chain": (chain, ones, 0.2),
        "all_overlap": (over, ones, 0.5),
        "zero_area": (zero, ones, 0.45),
        "near_threshold": (near_threshold_boxes(rng, B, K), ones, NEAR_THRESH),
    }


CASES = [(name, K) for K in (256, 84) for name in _cases(K)]


@pytest.mark.parametrize("name,K", CASES, ids=[f"{n}-K{k}" for n, k in CASES])
def test_nms_seq_matches_pallas_bit_for_bit(name, K):
    boxes, alive, t = _cases(K)[name]
    jb, ja = jnp.asarray(boxes), jnp.asarray(alive)
    tb, ta = torch.from_numpy(boxes), torch.from_numpy(alive)
    ref = np.asarray(nms_pallas(jb, ja, t))
    assert ref.dtype == np.float32
    got = nms_seq_torch(tb, ta, t).numpy()
    assert got.dtype == np.float32 and got.shape == (B, K)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(nms_seq(tb, ta, t).numpy(), ref)  # CPU tensor: plain version
    for b in range(B):  # the reference greedy, image by image
        np.testing.assert_array_equal(got[b] > 0.5, np.asarray(nms_jax(jb[b], ja[b], t, 0.5)))
    for group in (2, 8):  # B=5: a ragged last group either way
        multi = np.asarray(nms_pallas_multi(jb, ja, t, group=group))
        np.testing.assert_array_equal(multi, ref)
        np.testing.assert_array_equal(nms_seq_multi_torch(tb, ta, t, group).numpy(), multi)
        np.testing.assert_array_equal(nms_seq_multi(tb, ta, t, group).numpy(), multi)
    # the fixpoint computes the same greedy mask
    np.testing.assert_array_equal(nms_fixpoint_torch(tb, ta, t).numpy(), ref > 0.5)


def _batched_inputs():
    rng = np.random.default_rng(3)
    Bb, A = 3, 120
    cxy = rng.uniform(20, 200, (Bb, A, 2))
    wh = rng.uniform(20, 120, (Bb, A, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(size=(Bb, A)).astype(np.float32)
    yield "random", boxes, scores, dict(conf_thresh=0.25, max_detections=16, pre_topk=32)
    eq = np.round(rng.uniform(size=(Bb, A)) * 4).astype(np.float32) / 4
    yield "equal_scores", boxes, eq, dict(conf_thresh=0.2, max_detections=24, pre_topk=40)
    yield "k84", boxes[:, :84], scores[:, :84], dict(conf_thresh=0.0, max_detections=100,
                                                      pre_topk=256)
    low = np.full((Bb, A), 0.1, np.float32)
    yield "none_above_conf", boxes, low, dict(conf_thresh=0.5, max_detections=4, pre_topk=8)


@pytest.mark.parametrize("case", list(_batched_inputs()), ids=lambda c: c[0])
def test_batched_nms_pallas_seq_matches_jax(case):
    """All four outputs equal the reference's batched_nms(method='pallas_seq')."""
    _name, boxes, scores, kw = case
    ref = [np.asarray(o) for o in batched_nms_jax(jnp.asarray(boxes), jnp.asarray(scores),
                                                  method="pallas_seq", **kw)]
    got = [o.numpy() for o in batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                          method="pallas_seq", **kw)]
    for name, r, g in zip(("boxes", "scores", "valid", "anchor_idx"), ref, got):
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_nms_seq_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run the plain version: a CPU tensor is
    refused before any launch is counted."""
    for wrapper in (nms_seq_cuda, nms_seq_multi_cuda):
        before = wrapper.launches
        with pytest.raises(ValueError, match="CUDA device"):
            wrapper(torch.zeros(1, 4, 4), torch.ones(1, 4))
        assert wrapper.launches == before


def test_nms_methods_outside_the_kernels_raise():
    boxes, scores = torch.zeros(1, 8, 4), torch.ones(1, 8)
    for method in ("fixpoint", "xla"):
        with pytest.raises(NotImplementedError, match="pallas_seq"):
            batched_nms(boxes, scores, method=method)
    with pytest.raises(ValueError, match="unknown NMS method"):
        batched_nms(boxes, scores, method="bogus")
    cfg = get_default_config()
    cfg["detector"].update(img_size=64, width_mult=0.25, depth_mult=0.34, dtype="float32")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_detect_fn(build_detector(cfg, device="cpu"), nms_method="xla")


@pytest.mark.parametrize("group", [1, 5, 32])
def test_nms_seq_multi_group_changes_nothing_in_the_mask(group):
    """The reference's ``group`` is a VMEM budget: one image per step, all B
    in one step, or a step padded far past B, it gives ``nms_pallas``'s mask,
    and so does the port's grouped plain version."""
    boxes, alive, t = _cases(84)["dense"]
    jb, ja = jnp.asarray(boxes), jnp.asarray(alive)
    ref = np.asarray(nms_pallas(jb, ja, t))
    np.testing.assert_array_equal(np.asarray(nms_pallas_multi(jb, ja, t, group=group)), ref)
    tb, ta = torch.from_numpy(boxes), torch.from_numpy(alive)
    np.testing.assert_array_equal(nms_seq_multi(tb, ta, t, group).numpy(), ref)


@pytest.mark.parametrize("group", [0, 33])
def test_nms_seq_multi_cuda_refuses_a_group_outside_1_to_32(group):
    before = nms_seq_multi_cuda.launches
    with pytest.raises(ValueError, match="1 <= group <= 32"):
        nms_seq_multi_cuda(torch.zeros(1, 4, 4), torch.ones(1, 4), group=group)
    assert nms_seq_multi_cuda.launches == before
