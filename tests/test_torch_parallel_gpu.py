"""The parallel layer on the card: a one-rank NCCL mesh against no mesh.

Marked ``gpu``; without a card every test skips. Run on a machine with an
H100 and the CUDA toolkit (``--noconftest``: tests/conftest.py sets up JAX,
which such a machine need not have):

    python -m pytest --noconftest -m gpu tests/test_torch_parallel_gpu.py -q
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

pytestmark = pytest.mark.gpu

DET = dict(img_size=128, width_mult=0.25, depth_mult=0.34, batch_size=8, conf_threshold=0.0,
           max_detections=8, dtype="float32", pose_head=True)


@pytest.fixture
def nccl_mesh(tmp_path):
    """A one-rank NCCL group on the card and its MeshConfig."""
    # decided here, not at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cvsd_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        yield MeshConfig(build_mesh((1,), ("data",)))
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_mesh_detection_bit_equal(nccl_mesh):
    """The meshed DetectionPipeline on the card (its rank on cuda:0): the
    unmeshed pipeline's outputs bit for bit, one nms_fixpoint launch a
    batch, also for a batch that does not fill the detector batch."""
    from cvsd_tpu_torch.config import get_default_config
    from cvsd_tpu_torch.models.detector import build_detector
    from cvsd_tpu_torch.ops import nms
    from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline

    assert nccl_mesh.device == torch.device("cuda", 0)
    cfg = get_default_config()
    cfg["detector"].update(DET)
    state = build_detector(cfg, device="cuda", seed=3).state_dict()
    plain = DetectionPipeline(cfg, state_dict=state, device="cuda")
    meshed = DetectionPipeline(cfg, state_dict=state, mesh_config=nccl_mesh)
    frames = np.random.default_rng(0).integers(0, 255, (8, 240, 320, 3)).astype(np.uint8)
    for batch in (frames, frames[:5]):
        ref = plain.detect_frames(batch)
        before = nms.nms_fixpoint_cuda.launches
        got = meshed.detect_frames(batch)
        assert nms.nms_fixpoint_cuda.launches == before + 1
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            np.testing.assert_array_equal(g, r)


def test_one_rank_nccl_mesh_trainer_steps_bit_equal(nccl_mesh, tmp_path):
    """A meshed DetectorTrainer step (its BatchNorm statistics and gradients
    through NCCL) equals the unmeshed step bit for bit on the card."""
    from cvsd_tpu_torch.models.detector import PersonDetector
    from cvsd_tpu_torch.train.detector_train import DetectorTrainer, synthetic_detection_batch

    batch = synthetic_detection_batch(np.random.default_rng(0), 4, 64, max_gt=2)
    out = []
    for mesh in (None, nccl_mesh):
        tr = DetectorTrainer(PersonDetector(img_size=64, width_mult=0.25, depth_mult=0.34,
                                            dtype=torch.float32), seed=0, device="cuda",
                             mesh_config=mesh)
        loss = tr.train_step(*batch)["loss"]
        out.append((loss, {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k
