"""The port's ultralytics-u (v8dfl) detector and flip-TTA against the JAX
PersonDetector on the CPU, with the JAX weights carried across by the bridge
(the CPU-sized detector of bench.py: img 128, width 0.25, depth 0.34,
float32; the v8dfl head with 80 classes and 16 DFL bins)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.data.augment import flip_permutation as flip_permutation_jax
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.detector import decode_predictions_v8 as decode_v8_jax
from cvsd_tpu.models.detector import decode_raw as decode_raw_jax
from cvsd_tpu.models.detector import flip_anchor_permutation as flip_anchor_permutation_jax
from cvsd_tpu.models.detector import make_detect_fn as make_detect_fn_jax
from cvsd_tpu.ops.nms import batched_nms as batched_nms_jax
from cvsd_tpu_torch.data.augment import flip_permutation
from cvsd_tpu_torch.models.detector import (PersonDetector, build_detector, decode_predictions_v8,
                                            decode_with_tta, flip_anchor_permutation,
                                            make_detect_fn)
from cvsd_tpu_torch.ops.nms import batched_nms
from cvsd_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from torch_testutil import random_flax_variables

S = 128
VARIANTS = {"v8dfl": ("v8dfl", 0), "v8dfl_pose": ("v8dfl", 17), "anchor_free_pose": ("anchor_free", 17)}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_PAIRS = {}


def _pair(name):
    """(jax model, flax variables, bridged torch model) of one variant."""
    if name not in _PAIRS:
        head, nk = VARIANTS[name]
        jm = PersonDetectorJax(img_size=S, width_mult=0.25, depth_mult=0.34, num_keypoints=nk,
                               head_variant=head, dtype=jnp.float32)
        variables = random_flax_variables(
            lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, S, S, 3)),
                            train=False), 7 + nk)
        tm = PersonDetector(img_size=S, width_mult=0.25, depth_mult=0.34, num_keypoints=nk,
                            head_variant=head, dtype=torch.float32)
        load_flax_variables(tm, variables)
        _PAIRS[name] = (jm, variables, tm.eval())
    return _PAIRS[name]


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).uniform(0, 1, (2, S, S, 3)).astype(np.float32)


_RAW = {}


def _raw_jax(name, images):
    if name not in _RAW:
        jm, variables, _tm = _pair(name)
        out = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(images))
        _RAW[name] = {k: np.array(v) for k, v in out.items()}
    return _RAW[name]


@pytest.mark.parametrize("name", ["v8dfl", "v8dfl_pose"])
def test_v8_bridge_is_strict(name):
    """Every flax leaf of the v8dfl detector fills one torch tensor; the
    heads carry the flax names (V8DFLHead_i / ConvBNAct_0..4 / Conv_0..2)."""
    _jm, variables, tm = _pair(name)
    sd = flax_to_state_dict(variables, tm)
    assert set(sd) == set(tm.state_dict())
    assert set(variables["params"]) == {"Backbone_0", "PANNeck_0", "V8DFLHead_0", "V8DFLHead_1",
                                        "V8DFLHead_2"}
    head = variables["params"]["V8DFLHead_0"]
    assert head["Conv_1"]["kernel"].shape[-1] == 80  # class logits
    assert head["Conv_0"]["kernel"].shape[-1] == 64  # 4 * reg_max DFL bins
    d = {"img_size": S, "width_mult": 0.25, "depth_mult": 0.34, "dtype": "float32",
         "head_variant": "v8dfl", "pose_head": bool(tm.num_keypoints)}
    built = build_detector({"detector": d}, device="cpu", seed=1)
    assert set(built.state_dict()) == set(sd)


@pytest.mark.parametrize("name", ["v8dfl", "v8dfl_pose"])
def test_v8_raw_maps_match_jax(name, images):
    """float32 on both sides; every map within 1e-5 of its largest value:
    the two conv backends sum in another order through ~60 layers."""
    ref = _raw_jax(name, images)
    with torch.no_grad():
        got = _pair(name)[2](torch.from_numpy(images))
    nk = VARIANTS[name][1]
    for level, stride in (("p3", 8), ("p4", 16), ("p5", 32)):
        r, g = ref[level], got[level].numpy()
        assert g.shape == r.shape == (2, S // stride, S // stride, 64 + 80 + 3 * nk)
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max(), level


@pytest.mark.parametrize("name", ["v8dfl", "v8dfl_pose"])
def test_decode_predictions_v8_matches_jax(name, images):
    """The same raw maps in; the DFL softmax expectation and the sigmoids
    differ only in the last ulps, so each output is within 1e-5 of its
    largest value (a 1e-6 ulp of a DFL distance is 3e-5 px at stride 32)."""
    raw = _raw_jax(name, images)
    nk = VARIANTS[name][1]
    ref = jax.jit(decode_v8_jax, static_argnums=(1, 2, 3))(
        {k: jnp.asarray(v) for k, v in raw.items()}, 80, 16, nk)
    got = decode_predictions_v8({k: torch.from_numpy(v) for k, v in raw.items()}, 80, 16, nk)
    assert (got[2] is None) == (nk == 0)
    for r, g in zip(ref, got):
        if r is None:
            continue
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= 1e-5 * np.abs(r).max()


@pytest.mark.parametrize("h,w", [(128, 128), (64, 96), (640, 640)])
def test_flip_permutations_match_jax(h, w):
    np.testing.assert_array_equal(flip_anchor_permutation(h, w),
                                  flip_anchor_permutation_jax(h, w))
    for nk in (5, 17, 18):
        np.testing.assert_array_equal(flip_permutation(nk), flip_permutation_jax(nk))


def _tta_decode_jax(jm, variables, images):
    """The reference's flip-TTA decode (make_detect_fn's inner function in
    cvsd_tpu/models/detector.py), written out with its public pieces so the
    test can see the anchor indices NMS keeps."""
    B, S_ = images.shape[0], images.shape[2]
    both = jnp.concatenate([images, images[:, :, ::-1, :]], axis=0)
    boxes2, scores2, kpts2 = decode_raw_jax(jm, jm.apply(variables, both, train=False))
    perm = jnp.asarray(flip_anchor_permutation_jax(int(images.shape[1]), int(S_)))
    fb = boxes2[B:][:, perm]
    fb = jnp.stack([S_ - fb[..., 2], fb[..., 1], S_ - fb[..., 0], fb[..., 3]], -1)
    boxes = 0.5 * (boxes2[:B] + fb)
    scores = 0.5 * (scores2[:B] + scores2[B:][:, perm])
    kpts = None
    if kpts2 is not None:
        fk = kpts2[B:][:, perm][:, :, jnp.asarray(flip_permutation_jax(jm.num_keypoints))]
        kpts = 0.5 * (kpts2[:B] + jnp.stack([S_ - fk[..., 0], fk[..., 1], fk[..., 2]], -1))
    return boxes, scores, kpts


@pytest.mark.parametrize("name", list(VARIANTS))
def test_tta_detect_matches_jax(name, images):
    """make_detect_fn(tta_flip=True), both head variants: valid and the kept
    anchor indices equal; boxes, scores and keypoints within 1e-4 (relative
    to the pixel scale for boxes and keypoints), from conv sums in another
    order."""
    jm, variables, tm = _pair(name)
    x = torch.from_numpy(images)
    ref_dec = jax.jit(lambda v, im: _tta_decode_jax(jm, v, im))(variables, jnp.asarray(images))
    with torch.no_grad():
        got_dec = decode_with_tta(tm, x, tta_flip=True)
    np.testing.assert_allclose(got_dec[0].numpy(), np.asarray(ref_dec[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_dec[1].numpy(), np.asarray(ref_dec[1]), atol=1e-5)
    idx_j = np.asarray(batched_nms_jax(ref_dec[0], ref_dec[1], 0.0, 0.45, 16,
                                       method="pallas_seq")[3])
    idx_t = batched_nms(got_dec[0], got_dec[1], 0.0, 0.45, 16, method="pallas_seq")[3].numpy()
    np.testing.assert_array_equal(idx_t, idx_j)

    ref = make_detect_fn_jax(jm, conf_thresh=0.0, max_detections=16, nms_method="pallas_seq",
                             tta_flip=True)(variables, jnp.asarray(images))
    got = make_detect_fn(tm, conf_thresh=0.0, max_detections=16, nms_method="pallas_seq",
                         tta_flip=True)(x)
    assert len(got) == len(ref) == (4 if tm.num_keypoints else 3)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-5)
    if tm.num_keypoints:
        np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("head", ["anchor_free", "v8dfl"])
def test_tta_flip_detect_is_mirror_equivariant(head):
    """The property of tests/test_ops_detector.py's test of the same name, in
    the port: detect(tta_flip=True) on [img, flip(img)] returns mirrored
    results for the two rows, for any weights (anchor permutation, x -> S-x
    and the COCO left/right keypoint swap, through NMS)."""
    S_ = 64
    model = build_detector({"detector": {"img_size": S_, "width_mult": 0.25, "depth_mult": 0.34,
                                         "dtype": "float32", "head_variant": head,
                                         "pose_head": True, "num_keypoints": 5}},
                           device="cpu", seed=3)
    # seeded output biases spread the scores: with zero biases the random
    # v8dfl logits sit so near 0 that many anchors tie at exactly one score,
    # and equal scores break ties by anchor index, which mirroring reorders
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen))
    img = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (1, S_, S_, 3)).astype(np.float32))
    batch = torch.cat([img, img.flip(2)], 0)
    boxes, scores, valid, kpts = make_detect_fn(model, conf_thresh=0.0, iou_thresh=0.45,
                                                max_detections=8, tta_flip=True)(batch)
    b0, b1 = boxes[0].numpy(), boxes[1].numpy()
    np.testing.assert_allclose(scores[0].numpy(), scores[1].numpy(), atol=1e-4)
    keep = valid[0].numpy()
    assert keep.any()
    np.testing.assert_allclose(b1[keep, 0], S_ - b0[keep, 2], atol=1e-2)
    np.testing.assert_allclose(b1[keep, 2], S_ - b0[keep, 0], atol=1e-2)
    np.testing.assert_allclose(b1[keep, 1], b0[keep, 1], atol=1e-2)
    kperm = flip_permutation(5)
    k0, k1 = kpts[0].numpy(), kpts[1].numpy()
    np.testing.assert_allclose(k1[keep][:, kperm, 0], S_ - k0[keep][:, :, 0], atol=1e-2)
    np.testing.assert_allclose(k1[keep][:, kperm, 1], k0[keep][:, :, 1], atol=1e-2)
