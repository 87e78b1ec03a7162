"""The port's top-down pose net against cvsd_tpu/models/pose_topdown.py on
the CPU: crops, soft-argmax, the net (flax weights carried across by the
bridge) and pose_from_boxes, on seeded numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.models.pose_topdown import TopDownPoseNet as TopDownPoseNetJax
from cvsd_tpu.models.pose_topdown import crop_and_resize as crop_and_resize_jax
from cvsd_tpu.models.pose_topdown import pose_from_boxes as pose_from_boxes_jax
from cvsd_tpu.models.pose_topdown import soft_argmax as soft_argmax_jax
from cvsd_tpu_torch.models.pose_topdown import (TopDownPoseNet, build_pose_topdown,
                                                crop_and_resize, pose_from_boxes, soft_argmax)
from cvsd_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from torch_testutil import random_flax_variables


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _nets(crop, width, seed=0):
    jm = TopDownPoseNetJax(num_keypoints=17, width=width, crop_size=crop)
    variables = random_flax_variables(lambda: jm.init_variables(jax.random.PRNGKey(0)), seed)
    tm = load_flax_variables(TopDownPoseNet(17, width, crop), variables).eval()
    return jm, variables, tm


BOXES = np.asarray([[
    [4.0, 4.0, 40.0, 44.0],      # inside the frame
    [10.0, 10.0, 20.0, 30.0],    # small
    [12.0, 12.0, 12.0, 12.0],    # degenerate: zero area
    [30.0, 20.0, 22.0, 10.0],    # degenerate: x2 < x1, y2 < y1
    [-20.0, -15.0, 15.0, 10.0],  # partly out of frame (top-left)
    [50.0, 30.0, 90.0, 70.0],    # partly out of frame (bottom-right)
    [-80.0, -80.0, -60.0, -50.0],  # wholly out of frame
], [
    [0.0, 0.0, 64.0, 48.0], [5.0, 5.0, 25.0, 25.0], [1.5, 2.25, 7.75, 30.5],
    [60.0, 40.0, 63.0, 47.0], [-5.0, 20.0, 70.0, 30.0], [20.0, -10.0, 30.0, 60.0],
    [0.0, 0.0, 1.0, 1.0],
]], np.float32)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("out_size", [8, 32])
def test_crop_and_resize_matches_jax(frames, out_size):
    """Batched over (B, M) boxes against the reference's per-box function
    vmapped twice, including degenerate and out-of-frame boxes: origin and
    scale within 1e-6, crops within 1e-6 (the same bilinear weights in the
    same order; images are in [0, 1])."""
    ref = jax.jit(jax.vmap(lambda img, bs: jax.vmap(
        lambda b: crop_and_resize_jax(img, b, out_size))(bs)))(jnp.asarray(frames),
                                                              jnp.asarray(BOXES))
    got = crop_and_resize(torch.from_numpy(frames), torch.from_numpy(BOXES), out_size)
    assert got[0].shape == (2, BOXES.shape[1], out_size, out_size, 3)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def test_crop_and_resize_identity():
    """A box covering the frame with no padding reproduces the frame."""
    img = torch.arange(8 * 8 * 3, dtype=torch.float32).reshape(1, 8, 8, 3)
    crops, origin, scale = crop_and_resize(img, torch.tensor([[[0.0, 0.0, 8.0, 8.0]]]), 8,
                                           pad_frac=0.0)
    np.testing.assert_allclose(crops[0, 0].numpy(), img[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(origin.numpy(), [[[0.0, 0.0]]], atol=1e-6)
    np.testing.assert_allclose(scale.numpy(), [[[1.0, 1.0]]], atol=1e-6)


def test_soft_argmax_matches_jax():
    logits = (np.random.default_rng(1).normal(size=(3, 4, 8, 6, 17)) * 4).astype(np.float32)
    for temperature in (1.0, 0.5):
        rc, rconf = soft_argmax_jax(jnp.asarray(logits), temperature)
        gc, gconf = soft_argmax(torch.from_numpy(logits), temperature)
        assert gc.shape == (3, 4, 17, 2) and gconf.shape == (3, 4, 17)
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gconf.numpy(), np.asarray(rconf), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("crop,width", [(32, 8), (64, 32)])
def test_pose_net_matches_jax(crop, width):
    """The heatmap logits within 1e-5 of their largest value, at the test size
    and at the slice-2 size. Flax 'SAME' pads a stride-2, k=3 conv on an even
    input by (0, 1); a symmetric (1, 1) pad would shift the sampling grid by
    one pixel and miss this by orders of magnitude."""
    jm, variables, tm = _nets(crop, width)
    x = np.random.default_rng(2).uniform(0, 1, (3, crop, crop, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, crop // 4, crop // 4, 17)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_pose_from_boxes_matches_jax(frames):
    """Keypoints in frame pixels within 1e-4 px (the net's f32 sums in
    another order, scaled by the crop geometry), confidences within 1e-5;
    crops within 1e-6."""
    jm, variables, tm = _nets(32, 8, seed=3)
    ref_k, ref_c = jax.jit(lambda v, im, b: pose_from_boxes_jax(jm, v, im, b))(
        variables, jnp.asarray(frames), jnp.asarray(BOXES))
    got_k, got_c = pose_from_boxes(tm, torch.from_numpy(frames), torch.from_numpy(BOXES))
    assert got_k.shape == (2, BOXES.shape[1], 17, 3)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_k[..., :2].numpy(), np.asarray(ref_k)[..., :2], atol=1e-4)
    np.testing.assert_allclose(got_k[..., 2].numpy(), np.asarray(ref_k)[..., 2], atol=1e-5)


def test_pose_bridge_is_strict():
    """Every flax leaf of TopDownPoseNet fills one torch tensor (Conv_0..6,
    BatchNorm_0..5), and a missing leaf is refused."""
    _jm, variables, tm = _nets(32, 8)
    sd = flax_to_state_dict(variables, tm)
    assert set(sd) == set(tm.state_dict())
    assert {k.split(".")[0] for k in sd} == {f"Conv_{i}" for i in range(7)} | {
        f"BatchNorm_{i}" for i in range(6)}
    params = dict(variables["params"])
    del params["Conv_6"]
    with pytest.raises(KeyError, match="not filled"):
        flax_to_state_dict({"params": params, "batch_stats": variables["batch_stats"]}, tm)


def test_build_pose_topdown_seeded():
    cfg = {"detector": {"pose_topdown": {"num_keypoints": 17, "width": 8, "crop_size": 32}}}
    a = build_pose_topdown(cfg, device="cpu", seed=4)
    b = build_pose_topdown(cfg, device="cpu", seed=4)
    assert (a.crop_size, a.width, a.num_keypoints) == (32, 8, 17)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert all(v.dtype == torch.float32 for k, v in a.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    c = build_pose_topdown(cfg, device="cpu", state_dict=a.state_dict())
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), c.state_dict().values()))
