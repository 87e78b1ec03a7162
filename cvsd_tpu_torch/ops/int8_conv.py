"""The int8 convolution of the int8 detector (``models/detector_int8.py``).

The JAX package computes it as one XLA convolution, ``conv_general_dilated``
on int8 operands with ``preferred_element_type=int32``
(``cvsd_tpu/models/detector_int8.py:131-133``); it is no Pallas kernel.
PyTorch's ``conv2d`` takes no int8 on the card, so the card route is a plain
large matrix product, as the JAX package leaves one to XLA:

- ``im2col_int8``: the NHWC int8 input padded ("SAME" for odd kernels, p =
  (k - 1) // 2 on each side, as the reference pads), its strided patches
  copied once into a contiguous (B·Ho·Wo, k·k·Cin) matrix, columns in the
  HWIO order (kh, kw, c). A 1×1 stride-1 convolution needs no copy.
- ``torch._int_mm``: cuBLASLt's int8 tensor-core GEMM, accumulated exactly
  in int32. The weight is kept in the GEMM layout (Cout, k·k·Cin) row-major
  and handed over transposed: cuBLASLt refuses the (K, N) row-major operand
  for small M on the card's torch, and takes this one at every shape.
- ``_int_mm`` on CUDA needs M > 16 and K and N multiples of 8. The operands
  are padded with zero rows and columns (the stem's K = 6·6·3 = 108 becomes
  112, a p5 map at the test size has M ≤ 16): zeros add nothing, so the
  accumulators stay exact.

``int8_conv_plain`` is the plain version beside it: ``F.conv2d`` in float64
on the int8 values, exact because every |sum| < 2^31 ≪ 2^53. ``int8_conv``
runs the plain version for a CPU tensor and the GEMM route for a CUDA
tensor, and never the one for the other. Both give the same int32
accumulators, bit for bit (``tests/test_torch_int8.py`` holds the GEMM
route to the plain version on the CPU, ``chip_smoke.py`` phase 12 on the
card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MIN_ROWS = 32  # rows a GEMM is padded to when it has 16 or fewer (M > 16 needed)


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _out_size(n: int, kernel: int, stride: int) -> int:
    p = (kernel - 1) // 2
    return (n + 2 * p - kernel) // stride + 1


def im2col_int8(xq: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B·Ho·Wo, Kp) int8, row-major, columns (kh, kw, c)
    and then zeros up to Kp, the next multiple of 8 of K = k·k·C."""
    B, H, W, C = xq.shape
    K = kernel * kernel * C
    Kp = _round8(K)
    if kernel == 1 and stride == 1 and Kp == K:
        return xq.reshape(B * H * W, C)
    p = (kernel - 1) // 2
    xp = F.pad(xq, (0, 0, p, p, p, p)) if p else xq
    patches = xp.unfold(1, kernel, stride).unfold(2, kernel, stride)  # (B, Ho, Wo, C, kh, kw)
    Ho, Wo = patches.shape[1], patches.shape[2]
    cols = torch.empty((B, Ho, Wo, Kp), dtype=torch.int8, device=xq.device)
    if Kp > K:
        cols[..., K:] = 0
    cols[..., :K].view(B, Ho, Wo, kernel, kernel, C).copy_(patches.permute(0, 1, 2, 4, 5, 3))
    return cols.view(B * Ho * Wo, Kp)


def int8_conv_gemm(xq: torch.Tensor, w_gemm: torch.Tensor, kernel: int,
                   stride: int) -> torch.Tensor:
    """The card route: (B, H, W, Cin) int8 and the (Cout, k·k·Cin) int8
    weight -> (B, Ho, Wo, Cout) int32 by ``im2col_int8`` and ``torch._int_mm``
    (which also runs on the CPU, where the tests hold it to the plain
    version). Counts its calls in ``int8_conv_gemm.launches``."""
    if xq.dtype != torch.int8 or w_gemm.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {xq.dtype} and {w_gemm.dtype}")
    B, H, W, C = xq.shape
    N, K = w_gemm.shape
    if K != kernel * kernel * C:
        raise ValueError(f"weight K={K} does not match kernel {kernel} and {C} input channels")
    cols = im2col_int8(xq, kernel, stride)
    M, Kp = cols.shape
    Np = _round8(N)
    w = w_gemm if (Kp, Np) == (K, N) else F.pad(w_gemm, (0, Kp - K, 0, Np - N))
    if M <= 16:
        cols = F.pad(cols, (0, 0, 0, _MIN_ROWS - M))
    acc = torch._int_mm(cols, w.t())
    int8_conv_gemm.launches += 1
    Ho, Wo = _out_size(H, kernel, stride), _out_size(W, kernel, stride)
    if acc.shape != (M, N):
        acc = acc[:M, :N]
    return acc.reshape(B, Ho, Wo, N)


int8_conv_gemm.launches = 0


def int8_conv_plain(xq: torch.Tensor, w_gemm: torch.Tensor, kernel: int,
                    stride: int) -> torch.Tensor:
    """The plain version: ``F.conv2d`` in float64 on the int8 values, cast to
    int32 (exact), (B, Ho, Wo, Cout)."""
    N = w_gemm.shape[0]
    C = xq.shape[-1]
    w = w_gemm.to(torch.float64).reshape(N, kernel, kernel, C).permute(0, 3, 1, 2)
    y = F.conv2d(xq.permute(0, 3, 1, 2).to(torch.float64), w, None, stride, (kernel - 1) // 2)
    return y.to(torch.int32).permute(0, 2, 3, 1)


def int8_conv(xq: torch.Tensor, w_gemm: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """int32 accumulators of the int8 convolution: the GEMM route for a CUDA
    tensor, the plain version for a CPU tensor."""
    if xq.device.type == "cuda":
        return int8_conv_gemm(xq, w_gemm, kernel, stride)
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, w_gemm, kernel, stride)
    raise ValueError(f"int8_conv takes a CPU or CUDA tensor, got {xq.device}")
