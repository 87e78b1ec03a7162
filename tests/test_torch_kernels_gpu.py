"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``; without a card every test skips (a CUDA kernel has no CPU
mode). Run on a machine with an H100 and the CUDA toolkit (``--noconftest``:
tests/conftest.py sets up JAX, which such a machine need not have):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q
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


def _boxes(rng, B, K, lo=10.0, hi=600.0):
    cxy = rng.uniform(lo, hi, (B, K, 2))
    wh = rng.uniform(8, 120, (B, K, 2))
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)


@pytest.mark.parametrize("B,K", [(128, 256), (3, 84), (2, 1024), (1, 1)])
def test_nms_fixpoint_kernel_bit_exact(cuda, B, K):
    from cvsd_tpu_torch.ops.nms import nms_fixpoint_cuda, nms_fixpoint_torch

    rng = np.random.default_rng(B * 1000 + K)
    boxes = torch.from_numpy(_boxes(rng, B, K)).to(cuda)
    alive = torch.from_numpy((rng.uniform(size=(B, K)) > 0.1).astype(np.float32)).to(cuda)
    before = nms_fixpoint_cuda.launches
    keep = nms_fixpoint_cuda(boxes, alive, 0.45)
    torch.cuda.synchronize()
    assert nms_fixpoint_cuda.launches == before + 1
    ref = nms_fixpoint_torch(boxes, alive, 0.45)
    assert torch.equal(keep, ref)


def test_nms_fixpoint_kernel_chain(cuda):
    from cvsd_tpu_torch.ops.nms import nms_fixpoint_cuda

    K = 256
    boxes = torch.zeros(1, K, 4)
    for i in range(K):
        boxes[0, i] = torch.tensor([i * 6.0, 0.0, i * 6.0 + 10.0, 10.0])
    keep = nms_fixpoint_cuda(boxes.to(cuda), torch.ones(1, K, device=cuda), 0.2)
    assert keep.cpu()[0].tolist() == [i % 2 == 0 for i in range(K)]


def test_nms_fixpoint_kernel_rejects_bad_inputs(cuda):
    from cvsd_tpu_torch.ops.nms import nms_fixpoint_cuda

    with pytest.raises(ValueError, match="K <= 1024"):
        nms_fixpoint_cuda(torch.zeros(1, 1025, 4, device=cuda), torch.ones(1, 1025, device=cuda))
    with pytest.raises(TypeError):
        nms_fixpoint_cuda(torch.zeros(1, 8, 4, device=cuda, dtype=torch.float64),
                          torch.ones(1, 8, device=cuda))
    with pytest.raises(ValueError):
        nms_fixpoint_cuda(torch.zeros(1, 8, 4, device=cuda)[:, ::2],
                          torch.ones(1, 4, device=cuda))


@pytest.mark.parametrize("B,K,group", [(128, 256, 8), (3, 84, 8), (5, 256, 2), (2, 1024, 8),
                                       (1, 1, 1), (7, 33, 32), (1024, 256, 8), (3, 1024, 32)])
def test_nms_seq_kernels_bit_exact(cuda, B, K, group):
    """Both sequential kernels equal their plain version bit for bit, and the
    fixpoint kernel gives the same mask; ragged K, B=1024, and group 32 at
    K=1024 (the grouped wrapper launches one CTA per image whatever the group)."""
    from cvsd_tpu_torch.ops.nms import (nms_fixpoint_cuda, nms_seq_cuda, nms_seq_multi_cuda,
                                        nms_seq_multi_torch, nms_seq_torch)

    rng = np.random.default_rng(B * 1000 + K + 7)
    boxes = torch.from_numpy(_boxes(rng, B, K, 100.0, 300.0)).to(cuda)
    alive = torch.from_numpy((rng.uniform(size=(B, K)) > 0.1).astype(np.float32)).to(cuda)
    before = (nms_seq_cuda.launches, nms_seq_multi_cuda.launches)
    keep = nms_seq_cuda(boxes, alive, 0.45)
    multi = nms_seq_multi_cuda(boxes, alive, 0.45, group)
    fix = nms_fixpoint_cuda(boxes, alive, 0.45)
    torch.cuda.synchronize()
    assert (nms_seq_cuda.launches, nms_seq_multi_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert keep.dtype == multi.dtype == torch.float32
    assert torch.equal(keep, nms_seq_torch(boxes, alive, 0.45))
    assert torch.equal(multi, nms_seq_multi_torch(boxes, alive, 0.45, group))
    assert torch.equal(fix, keep > 0.5)


def test_nms_seq_kernels_chain(cuda):
    from cvsd_tpu_torch.ops.nms import nms_seq_cuda, nms_seq_multi_cuda

    K = 256
    boxes = torch.zeros(3, K, 4)
    boxes[:, :, 0] = torch.arange(K) * 6.0
    boxes[:, :, 2] = boxes[:, :, 0] + 10.0
    boxes[:, :, 3] = 10.0
    want = [float(i % 2 == 0) for i in range(K)]
    for keep in (nms_seq_cuda(boxes.to(cuda), torch.ones(3, K, device=cuda), 0.2),
                 nms_seq_multi_cuda(boxes.to(cuda), torch.ones(3, K, device=cuda), 0.2, 2)):
        assert all(row == want for row in keep.cpu().tolist())


def test_nms_seq_kernels_reject_bad_inputs(cuda):
    from cvsd_tpu_torch.ops.nms import nms_seq_cuda, nms_seq_multi_cuda

    for fn in (nms_seq_cuda, nms_seq_multi_cuda):
        with pytest.raises(ValueError, match="K <= 1024"):
            fn(torch.zeros(1, 1025, 4, device=cuda), torch.ones(1, 1025, device=cuda))
        with pytest.raises(TypeError):
            fn(torch.zeros(1, 8, 4, device=cuda, dtype=torch.float64), torch.ones(1, 8, device=cuda))
        with pytest.raises(ValueError):
            fn(torch.zeros(1, 8, 4, device=cuda)[:, ::2], torch.ones(1, 4, device=cuda))
    for group in (0, 33):
        with pytest.raises(ValueError, match="group"):
            nms_seq_multi_cuda(torch.zeros(1, 8, 4, device=cuda), torch.ones(1, 8, device=cuda),
                               group=group)


def _edge_inputs(case, B, K):
    """(boxes, alive, iou_thresh) on the card for one tile-edge test case."""
    from chip_smoke import NEAR_THRESH, near_threshold_boxes

    rng = np.random.default_rng(K * 1000 + B)
    if case == "near_threshold":
        return near_threshold_boxes(rng, B, K), np.ones((B, K), np.float32), NEAR_THRESH
    alive = (rng.uniform(size=(B, K)) > 0.1).astype(np.float32)
    if case == "all_dead":
        alive[:] = 0.0
    return _boxes(rng, B, K, 100.0, 300.0), alive, 0.45


@pytest.mark.parametrize("case", ["random", "all_dead", "near_threshold"])
@pytest.mark.parametrize("B", [1, 133])
@pytest.mark.parametrize("K", [31, 32, 33, 63, 64, 65, 1023, 1024])
def test_tiled_kernels_bit_exact_at_tile_edges(cuda, K, B, case):
    """Both kernels build their suppression bits in 32x32 tiles:
    bit-exact against their plain versions where the tiles are full, ragged by
    one row or column, and at K=1024 (528 tiles, opt-in shared memory); the
    grouped wrapper at group 1, 8 and 32."""
    from cvsd_tpu_torch.ops.nms import (nms_fixpoint_cuda, nms_fixpoint_torch, nms_seq_cuda,
                                        nms_seq_multi_cuda, nms_seq_torch)

    boxes, alive, t = _edge_inputs(case, B, K)
    boxes, alive = torch.from_numpy(boxes).to(cuda), torch.from_numpy(alive).to(cuda)
    seq = nms_seq_cuda(boxes, alive, t)
    fix = nms_fixpoint_cuda(boxes, alive, t)
    multi = {group: nms_seq_multi_cuda(boxes, alive, t, group) for group in (1, 8, 32)}
    torch.cuda.synchronize()
    assert torch.equal(seq, nms_seq_torch(boxes, alive, t))
    assert torch.equal(fix, nms_fixpoint_torch(boxes, alive, t))
    assert torch.equal(fix, seq > 0.5)
    for group, keep in multi.items():
        assert torch.equal(keep, seq), group
    if case == "all_dead":
        assert not fix.any()


def test_kernels_replay_in_a_cuda_graph(cuda):
    """chip_smoke.py times the kernels by replaying captured launches: a
    captured launch of each wrapper gives the mask of a direct call."""
    from cvsd_tpu_torch.ops.nms import nms_fixpoint_cuda, nms_seq_cuda, nms_seq_multi_cuda

    rng = np.random.default_rng(5)
    boxes = torch.from_numpy(_boxes(rng, 16, 256, 100.0, 300.0)).to(cuda)
    alive = torch.ones(16, 256, device=cuda)
    for fn in (nms_fixpoint_cuda, nms_seq_cuda, nms_seq_multi_cuda):
        want = fn(boxes, alive, 0.45)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(boxes, alive, 0.45)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = fn(boxes, alive, 0.45)
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


# -- the int8 detector's convolution: im2col + torch._int_mm on the card ------------------


@pytest.mark.parametrize("B,H,W,C,N,k,s", [
    (4, 640, 640, 3, 48, 6, 2),   # slice 1's stem at full width: K = 108 padded to 112
    (4, 160, 160, 48, 48, 3, 1),  # a C3 bottleneck's 3x3 at full width
    (4, 20, 20, 768, 768, 1, 1),  # the 1x1 after SPPF at full width
    (2, 2, 2, 64, 64, 3, 1),      # a p5 map at the test size: M = 8 padded to 32
    (1, 5, 7, 5, 12, 3, 2),       # odd sizes: K = 45 and N = 12 padded
])
def test_int8_conv_route_bit_exact(cuda, B, H, W, C, N, k, s):
    """The card route's int32 accumulators equal the float64 plain version's
    (on the card and on the CPU) bit for bit; int8_conv on a CUDA tensor
    takes the route, never the plain version."""
    from cvsd_tpu_torch.ops.int8_conv import int8_conv, int8_conv_gemm, int8_conv_plain

    g = torch.Generator().manual_seed(H * C + k)
    xq = torch.randint(-127, 128, (B, H, W, C), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, k * k * C), generator=g, dtype=torch.int8)
    before = int8_conv_gemm.launches
    got = int8_conv(xq.to(cuda), w.to(cuda), k, s)
    torch.cuda.synchronize()
    assert int8_conv_gemm.launches == before + 1
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got, int8_conv_plain(xq.to(cuda), w.to(cuda), k, s))
    if H <= 160:
        assert torch.equal(got.cpu(), int8_conv_plain(xq, w, k, s))


def test_int8_detector_forward_on_the_card(cuda):
    """The test-sized int8 detector on the card: every ConvBNAct goes through
    the GEMM route once a forward, and the head maps stay within 1e-3 of the
    CPU's largest entry (float32 activations; an activation one rounding
    apart moves a map by one quantization step)."""
    from cvsd_tpu_torch.models.detector_int8 import ConvBNAct, QuantPersonDetector
    from cvsd_tpu_torch.ops.int8_conv import int8_conv_gemm
    from cvsd_tpu_torch.utils.device import use_float32_math

    use_float32_math()
    torch.manual_seed(0)
    cpu = QuantPersonDetector(64, 0.25, 0.34, num_keypoints=17, dtype=torch.float32)
    for m in cpu.modules():
        if isinstance(m, ConvBNAct):
            m.w_int8.copy_(torch.randint(-127, 128, m.w_int8.shape, dtype=torch.int8))
            m.w_scale.fill_(1.0 / (127 * m.w_int8.shape[1] ** 0.5))
            m.act_scale.fill_(0.02)
    card = QuantPersonDetector(64, 0.25, 0.34, num_keypoints=17, dtype=torch.float32).to(cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(2, 64, 64, 3)
    n_convs = sum(isinstance(m, ConvBNAct) for m in card.modules())
    before = int8_conv_gemm.launches
    with torch.no_grad():
        got = card(x.to(cuda))
        ref = cpu(x)
    torch.cuda.synchronize()
    assert int8_conv_gemm.launches == before + n_convs
    for key, r in ref.items():
        assert float((got[key].cpu() - r).abs().max()) <= 1e-3 * float(r.abs().max()), key


@pytest.mark.parametrize("op_name", ["nms_fixpoint", "nms_seq"])
@pytest.mark.parametrize("B,K", [(128, 256), (3, 84), (2, 1024)])
def test_nms_ops_equal_their_kernel_wrappers(cuda, op_name, B, K):
    """The torch.library operators launch the same kernel as the ctypes
    wrappers (one launch each, counted) and give their masks bit for bit;
    a non-contiguous input is made contiguous, not refused."""
    from cvsd_tpu_torch.ops import nms

    op = getattr(torch.ops.cvsd_tpu_torch, op_name)
    wrapper = nms.nms_fixpoint_cuda if op_name == "nms_fixpoint" else nms.nms_seq_cuda
    rng = np.random.default_rng(B * 7 + K)
    boxes = torch.from_numpy(_boxes(rng, B, K, 100.0, 300.0)).to(cuda)
    alive = torch.from_numpy((rng.uniform(size=(B, K)) > 0.1).astype(np.float32)).to(cuda)
    ref = wrapper(boxes, alive, 0.45) > 0.5
    before = wrapper.launches
    keep = op(boxes, alive, 0.45)
    strided = op(boxes.transpose(0, 1).contiguous().transpose(0, 1), alive, 0.45)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert keep.dtype == torch.bool and torch.equal(keep, ref) and torch.equal(strided, ref)


def test_exported_detector_launches_nms_fixpoint(cuda, tmp_path):
    """A detector exported on the card keeps the fixpoint kernel: the loaded
    artifact launches nms_fixpoint.cu once a call and equals the eager detect
    function (float32, test size)."""
    from cvsd_tpu_torch.models.detector import PersonDetector, make_detect_fn
    from cvsd_tpu_torch.ops import nms
    from cvsd_tpu_torch.serve import export
    from cvsd_tpu_torch.utils.device import use_float32_math
    from cvsd_tpu_torch.utils.weights import init_module

    use_float32_math()
    model = init_module(PersonDetector(img_size=64, width_mult=0.25, depth_mult=0.34,
                                       num_keypoints=17, dtype=torch.float32), 3).to(cuda).eval()
    path = str(tmp_path / "det.pt2")
    export.save_exported(export.export_detector(model, conf_thresh=0.0, max_detections=8), path)
    loaded = export.load_exported(path)
    assert export.exported_device(loaded).type == "cuda"
    eager = make_detect_fn(model, conf_thresh=0.0, max_detections=8)
    for b in (1, 5):
        imgs = torch.from_numpy(np.random.default_rng(b).uniform(0, 1, (b, 64, 64, 3))
                                .astype(np.float32))
        before = nms.nms_fixpoint_cuda.launches
        got = export.call_exported(loaded, imgs)
        torch.cuda.synchronize()
        assert nms.nms_fixpoint_cuda.launches == before + 1
        ref = eager(imgs.to(cuda))
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
