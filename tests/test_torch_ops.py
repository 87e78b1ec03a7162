"""The port's box geometry and letterbox against the JAX reference on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.ops import iou as iou_jax
from cvsd_tpu.ops import letterbox as lb_jax
from cvsd_tpu_torch.ops import iou, letterbox


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_iou_and_conversions_match_jax():
    rng = np.random.default_rng(0)
    xywh = (np.abs(rng.normal(size=(2, 12, 4))) * 40 + 1).astype(np.float32)
    a = np.array(iou_jax.xywh_to_xyxy(jnp.asarray(xywh)))
    b = iou.xywh_to_xyxy(torch.from_numpy(xywh)).numpy()
    np.testing.assert_array_equal(b, a)  # same elementwise ops: exact
    np.testing.assert_array_equal(iou.xyxy_to_xywh(torch.from_numpy(a)).numpy(),
                                  np.asarray(iou_jax.xyxy_to_xywh(jnp.asarray(a))))
    np.testing.assert_array_equal(
        iou.xyxy_to_xywhn(torch.from_numpy(a), 320.0, 240.0).numpy(),
        np.asarray(iou_jax.xyxy_to_xywhn(jnp.asarray(a), 320.0, 240.0)))
    other = a[:, ::-1].copy()
    np.testing.assert_array_equal(
        iou.box_iou_matrix(torch.from_numpy(a), torch.from_numpy(other)).numpy(),
        np.asarray(iou_jax.box_iou_matrix(jnp.asarray(a), jnp.asarray(other))))
    known = iou.box_iou_matrix(torch.tensor([[0.0, 0, 10, 10]]), torch.tensor([[5.0, 5, 15, 15]]))
    np.testing.assert_allclose(known.numpy(), [[25 / 175]], rtol=1e-6)


@pytest.mark.parametrize("size", [640, 128], ids=["upscale_640", "downscale_128"])
def test_letterbox_batch_matches_jax(size):
    """240x320 -> 640 upscales (plain bilinear); -> 128 downscales, where the
    reference resize antialiases. Tolerance 1e-5 on [0, 1] values: the two
    resamplers sum the same weights in a different order (f32 rounding)."""
    frames = np.random.default_rng(1).integers(0, 256, (2, 240, 320, 3)).astype(np.uint8)
    ref = np.asarray(lb_jax.letterbox_batch(jnp.asarray(frames), size=size, dtype=jnp.float32))
    got = letterbox.letterbox_batch(torch.from_numpy(frames), size=size, dtype=torch.float32)
    assert tuple(got.shape) == ref.shape == (2, size, size, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_letterbox_params_and_unletterbox_match_jax():
    for args in ((240, 320, 640), (128, 160, 64), (480, 640, 640)):
        assert letterbox.letterbox_params(*args) == lb_jax.letterbox_params(*args)
    boxes = np.asarray([[[100.0, 160.0, 300.0, 400.0], [-20.0, 5.0, 700.0, 650.0]]], np.float32)
    ref = np.asarray(lb_jax.unletterbox_boxes(jnp.asarray(boxes), 240, 320, 640))
    got = letterbox.unletterbox_boxes(torch.from_numpy(boxes), 240, 320, 640).numpy()
    np.testing.assert_array_equal(got, ref)
    assert letterbox.PAD_VALUE == lb_jax.PAD_VALUE
