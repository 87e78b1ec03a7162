"""The port's detector trainer on the card.

Marked ``gpu``; without a card every test skips. Run on a machine with a
CUDA card (``--noconftest``: tests/conftest.py sets up JAX, which such a
machine need not have):

    python -m pytest --noconftest -m gpu tests/test_torch_detector_train_gpu.py -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    # decided here, not at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _detector(dtype):
    from cvsd_tpu_torch.models.detector import PersonDetector

    return PersonDetector(img_size=128, width_mult=0.25, depth_mult=0.34, num_keypoints=17,
                          dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_same_seed_twice_identical_on_the_card(cuda, dtype):
    """Four steps through train_steps_scan with EMA, twice from one seed on
    the card, end with the same weights, statistics and EMA bit for bit; the
    master weights and statistics stay float32 whatever the compute dtype."""
    from cvsd_tpu_torch.train.detector_train import DetectorTrainer, synthetic_detection_batch

    rng = np.random.default_rng(0)
    steps = [synthetic_detection_batch(rng, 4, 128, num_keypoints=17) for _ in range(4)]
    batch = [np.stack([s[i] for s in steps]) for i in range(4)]
    runs = []
    for _ in range(2):
        tr = DetectorTrainer(_detector(dtype), seed=3, total_steps=8, ema_decay=0.9, device=cuda)
        losses = tr.train_steps_scan(*batch)["losses"]
        runs.append((losses, [t.cpu() for t in tr.model.state_dict().values()],
                     [e.cpu() for e in tr.ema_params]))
        assert all(t.dtype == torch.float32 for t in tr.model.state_dict().values())
    (la, sa, ea), (lb, sb, eb) = runs
    assert np.array_equal(la, lb) and np.isfinite(la).all()
    assert all(torch.equal(x, y) for x, y in zip(sa + ea, sb + eb))


def test_eval_launches_the_kernel_once_per_chunk(cuda):
    """evaluate_detector on the card pads the last chunk and launches the
    nms_fixpoint kernel once per chunk."""
    from cvsd_tpu_torch.data.render import rendered_scene_batch
    from cvsd_tpu_torch.eval.detection import evaluate_detector
    from cvsd_tpu_torch.models.detector import make_detect_fn
    from cvsd_tpu_torch.ops import nms
    from cvsd_tpu_torch.train.detector_train import DetectorTrainer

    tr = DetectorTrainer(_detector(torch.bfloat16), seed=4, device=cuda)
    images, boxes, valid, kpts = rendered_scene_batch(np.random.default_rng(1), 10, 128)
    detect = make_detect_fn(tr.eval_model(), max_detections=16)
    before = nms.nms_fixpoint_cuda.launches
    res = evaluate_detector(detect, images, boxes, valid, kpts, batch_size=4, coco_map=True,
                            device=cuda)
    assert nms.nms_fixpoint_cuda.launches - before == 3
    assert res["num_gt"] == int(valid.sum()) and 0.0 <= res["map50_95"] <= 1.0
