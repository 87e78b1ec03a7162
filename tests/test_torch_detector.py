"""The port's detector against the JAX PersonDetector on the CPU, with the
JAX weights carried across by the bridge (the CPU-sized detector of
bench.py: img 128, width 0.25, depth 0.34, float32, pose head)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.detector import decode_predictions as decode_jax
from cvsd_tpu.models.detector import make_detect_fn as make_detect_fn_jax
from cvsd_tpu.ops.nms import batched_nms as batched_nms_jax
from cvsd_tpu_torch.models.detector import (PersonDetector, build_detector, decode_predictions,
                                            make_detect_fn)
from cvsd_tpu_torch.ops.nms import batched_nms
from cvsd_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from torch_testutil import random_flax_variables

S = 128


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    jm = PersonDetectorJax(img_size=S, width_mult=0.25, depth_mult=0.34, num_keypoints=17,
                           dtype=jnp.float32)
    variables = random_flax_variables(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, S, S, 3)), train=False), 0)
    tm = PersonDetector(img_size=S, width_mult=0.25, depth_mult=0.34, num_keypoints=17,
                        dtype=torch.float32)
    load_flax_variables(tm, variables)
    return jm, variables, tm.eval()


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).uniform(0, 1, (2, S, S, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def raw_jax(pair, images):
    jm, variables, _tm = pair
    out = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(images))
    return {k: np.array(v) for k, v in out.items()}


def test_bridge_is_strict(pair):
    _jm, variables, tm = pair
    sd = flax_to_state_dict(variables, tm)
    assert set(sd) == set(tm.state_dict())
    params = dict(variables["params"])
    head = dict(params["DetectHead_2"])
    del head["Conv_2"]  # a missing flax leaf leaves a torch tensor unfilled
    with pytest.raises(KeyError, match="not filled"):
        flax_to_state_dict({"params": {**params, "DetectHead_2": head},
                            "batch_stats": variables["batch_stats"]}, tm)
    extra = {**params, "Extra_0": {"kernel": np.zeros((1, 1, 3, 3), np.float32)}}
    with pytest.raises(KeyError, match="no torch counterpart"):
        flax_to_state_dict({"params": extra, "batch_stats": variables["batch_stats"]}, tm)
    small = PersonDetector(img_size=S, width_mult=0.125, depth_mult=0.34, num_keypoints=17,
                           dtype=torch.float32)
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict(variables, small)


def test_raw_maps_match_jax(pair, images, raw_jax):
    """float32 on both sides; tolerance 1e-4 absolute on the head maps: the
    two conv backends sum in a different order through ~60 layers."""
    _jm, _variables, tm = pair
    ref = raw_jax
    with torch.no_grad():
        got = tm(torch.from_numpy(images))
    for name in ("p3", "p4", "p5"):
        r = np.asarray(ref[name])
        assert tuple(got[name].shape) == r.shape
        np.testing.assert_allclose(got[name].numpy(), r, atol=1e-4, rtol=1e-4, err_msg=name)


def test_decode_matches_jax(raw_jax):
    """Same raw maps in -> decode is elementwise, so 1e-5 relative suffices
    (exp/sigmoid implementations differ in the last ulp)."""
    raw = raw_jax
    ref = jax.jit(decode_jax, static_argnums=(1, 2))(
        {k: jnp.asarray(v) for k, v in raw.items()}, S, 17)
    got = decode_predictions({k: torch.from_numpy(v) for k, v in raw.items()}, S, 17)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_make_detect_fn_matches_jax(pair, images, raw_jax):
    """valid and anchor_idx exact, boxes within 1e-3 px, keypoints 1e-3 px,
    scores 1e-5: the raw maps differ only by summation order (see above)."""
    jm, variables, tm = pair
    b_j, s_j, _ = jax.jit(decode_jax, static_argnums=(1, 2))(
        {k: jnp.asarray(v) for k, v in raw_jax.items()}, S, 17)
    with torch.no_grad():
        b_t, s_t, _ = decode_predictions(tm(torch.from_numpy(images)), S, 17)
    idx_j = np.asarray(batched_nms_jax(b_j, s_j, 0.0, 0.45, 16)[3])
    idx_t = batched_nms(b_t, s_t, 0.0, 0.45, 16)[3].numpy()
    np.testing.assert_array_equal(idx_t, idx_j)
    ref = make_detect_fn_jax(jm, conf_thresh=0.0, max_detections=16)(variables, jnp.asarray(images))
    got = make_detect_fn(tm, conf_thresh=0.0, max_detections=16)(torch.from_numpy(images))
    rb, rs, rv, rk = (np.asarray(x) for x in ref)
    gb, gs, gv, gk = (x.numpy() for x in got)
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_allclose(gb, rb, atol=1e-3)
    np.testing.assert_allclose(gs, rs, atol=1e-5)
    np.testing.assert_allclose(gk, rk, atol=1e-3)


def test_build_detector_seeded_and_unported_options():
    """Seeded builds repeat; v8dfl and flip-TTA build (tests/test_torch_v8.py
    holds them to JAX); int8 builds the QuantPersonDetector
    (tests/test_torch_int8.py holds it to JAX); the plain-XLA NMS methods
    build too, and an unknown one raises."""
    cfg = {"detector": {"img_size": 64, "width_mult": 0.25, "depth_mult": 0.34,
                        "dtype": "float32", "pose_head": True}}
    a = build_detector(cfg, device="cpu", seed=3).state_dict()
    b = build_detector(cfg, device="cpu", seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    v8 = build_detector({"detector": {**cfg["detector"], "head_variant": "v8dfl"}}, device="cpu")
    assert v8.head_variant == "v8dfl" and hasattr(v8, "V8DFLHead_2")
    make_detect_fn(build_detector(cfg, device="cpu"), tta_flip=True)
    q = build_detector({"detector": {**cfg["detector"], "quantized": True}}, device="cpu")
    assert type(q).__name__ == "QuantPersonDetector" and q.num_keypoints == 17
    make_detect_fn(build_detector(cfg, device="cpu"), nms_method="fixpoint")
    with pytest.raises(ValueError, match="unknown NMS method"):
        make_detect_fn(build_detector(cfg, device="cpu"), nms_method="bogus")
