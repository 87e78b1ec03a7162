"""Non-maximum suppression with static shapes (PyTorch port of
``cvsd_tpu/ops/nms.py``), with a hand-written CUDA kernel for the fixpoint.

1. confidence mask + per-image top-K candidate prefilter (stable sort, so
   equal scores keep the lower anchor first, as ``lax.top_k`` does)
2. greedy suppression over the K score-sorted candidates. ``nms_fixpoint``
   runs the Jacobi fixpoint (exactly greedy NMS, see ``nms_fixpoint_torch``):
   on a CUDA tensor through the kernel in ``csrc/nms_fixpoint.cu``, on a CPU
   tensor through the plain PyTorch version.
3. fixed ``max_detections`` output with a validity mask
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from cvsd_tpu_torch.ops.iou import box_iou_matrix

MAX_KERNEL_K = 1024  # one CUDA thread per candidate


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor: comparisons then happen in float32, as in the
    reference (a Python float would round the threshold differently)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def suppress_torch(iou: torch.Tensor, init_alive: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Sequential greedy suppression over score-desc-sorted candidates.
    iou: (..., K, K); init_alive: (..., K) bool. Returns the alive mask."""
    K = iou.shape[-1]
    cols = torch.arange(K, device=iou.device)
    over = iou > _f32(iou_thresh, iou)
    alive = init_alive.clone()
    for i in range(K):
        suppress = over[..., i, :] & (cols > i) & alive[..., i : i + 1]
        alive = alive & ~suppress
    return alive


def nms_torch(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float = 0.45,
              conf_thresh: float = 0.0) -> torch.Tensor:
    """Reference greedy NMS over (K, 4) score-sorted boxes -> keep mask (K,) bool."""
    return suppress_torch(box_iou_matrix(boxes, boxes), scores >= conf_thresh, iou_thresh)


def _suppression_matrix(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """M[b, i, j] = 1 where candidate i (i < j, higher score) overlaps j
    beyond the threshold."""
    K = boxes.shape[1]
    iou = box_iou_matrix(boxes, boxes)
    upper = torch.ones(K, K, dtype=torch.bool, device=boxes.device).triu(1)
    return ((iou > _f32(iou_thresh, iou)) & upper).to(torch.float32)


def nms_fixpoint_torch(boxes: torch.Tensor, alive: torch.Tensor,
                       iou_thresh: float = 0.45) -> torch.Tensor:
    """Greedy NMS via Jacobi fixpoint iteration -> keep mask (B, K) bool.

    Greedy suppression is the well-founded recursion
    ``alive[j] = init[j] & not any(M[i,j] & alive[i] for i < j)``; Jacobi
    iteration ``a_{k+1} = init & (M^T a_k == 0)`` reaches that unique
    fixpoint in at most K steps (a handful on real detections). The plain
    version of the CUDA kernel: one batched matvec per step."""
    B, K, _ = boxes.shape
    M = _suppression_matrix(boxes.to(torch.float32), iou_thresh)
    init = alive.to(torch.float32).reshape(B, 1, K)
    a = init
    for _ in range(K):
        new = init * (torch.bmm(a, M) < 0.5).to(torch.float32)
        changed = bool((new != a).any())
        a = new
        if not changed:
            break
    return a.reshape(B, K) > 0.5


def nms_fixpoint_cuda(boxes: torch.Tensor, alive: torch.Tensor,
                      iou_thresh: float = 0.45) -> torch.Tensor:
    """Launch ``csrc/nms_fixpoint.cu`` on the current stream.
    boxes (B, K, 4) float32 and alive (B, K) float32 0/1, both contiguous on
    one CUDA device; K <= 1024. Returns keep (B, K) bool. Raises on anything
    else; never falls back to the plain version."""
    from cvsd_tpu_torch.utils import cuda_build

    if boxes.device.type != "cuda" or alive.device != boxes.device:
        raise ValueError(f"nms_fixpoint_cuda needs boxes and alive on one CUDA device, "
                         f"got {boxes.device} and {alive.device}")
    if boxes.dtype != torch.float32 or alive.dtype != torch.float32:
        raise TypeError(f"nms_fixpoint_cuda needs float32, got {boxes.dtype}, {alive.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or tuple(alive.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"nms_fixpoint_cuda needs boxes (B, K, 4) and alive (B, K), got "
                         f"{tuple(boxes.shape)} and {tuple(alive.shape)}")
    if not (boxes.is_contiguous() and alive.is_contiguous()) or boxes.data_ptr() % 16:
        raise ValueError("nms_fixpoint_cuda needs contiguous, 16-byte aligned inputs")
    B, K = int(boxes.shape[0]), int(boxes.shape[1])
    if K > MAX_KERNEL_K:
        raise ValueError(f"nms_fixpoint_cuda supports K <= {MAX_KERNEL_K}, got K={K}")
    keep = torch.empty((B, K), dtype=torch.bool, device=boxes.device)
    if B == 0 or K == 0:
        return keep
    lib = _nms_lib()
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = lib.cvsd_nms_fixpoint(boxes.data_ptr(), alive.data_ptr(), keep.data_ptr(),
                                B, K, float(iou_thresh), stream)
    cuda_build.check(lib, err, "nms_fixpoint kernel launch")
    nms_fixpoint_cuda.launches += 1
    return keep


nms_fixpoint_cuda.launches = 0  # kernel launches made by this wrapper


def _nms_lib() -> ctypes.CDLL:
    from cvsd_tpu_torch.utils import cuda_build

    lib = cuda_build.load("nms_fixpoint")
    if lib.cvsd_nms_fixpoint.argtypes is None:
        lib.cvsd_nms_fixpoint.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                          ctypes.c_void_p]
        lib.cvsd_nms_fixpoint.restype = ctypes.c_int
        lib.cvsd_nms_fixpoint_smem_bytes.argtypes = [ctypes.c_int]
        lib.cvsd_nms_fixpoint_smem_bytes.restype = ctypes.c_longlong
    return lib


def nms_fixpoint(boxes: torch.Tensor, alive: torch.Tensor, iou_thresh: float = 0.45) -> torch.Tensor:
    """Fixpoint NMS keep mask (B, K) bool: the CUDA kernel for CUDA tensors,
    the plain PyTorch version for CPU tensors."""
    if boxes.device.type == "cpu":
        return nms_fixpoint_torch(boxes, alive, iou_thresh)
    return nms_fixpoint_cuda(boxes, alive, iou_thresh)


def _top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics: descending, ties keep the lower index first."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def prefilter(boxes: torch.Tensor, scores: torch.Tensor, conf_thresh: float, pre_topk: int):
    """Confidence mask + top-K: (top_scores, top_idx, cand_boxes (B,K,4),
    init_alive (B,K) bool), candidates sorted by descending score."""
    K = min(pre_topk, boxes.shape[1])
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    masked = torch.where(scores >= _f32(conf_thresh, scores), scores, neg_inf)
    top_scores, top_idx = _top_k_stable(masked, K)
    cand_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    return top_scores, top_idx, cand_boxes, torch.isfinite(top_scores)


def batched_nms(
    boxes: torch.Tensor,  # (B, A, 4) xyxy
    scores: torch.Tensor,  # (B, A)
    conf_thresh: float = 0.25,
    iou_thresh: float = 0.45,
    max_detections: int = 128,
    pre_topk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full detection postprocess: conf mask -> top-K -> greedy NMS ->
    fixed-size (boxes, scores, valid, anchor_idx) outputs. The keep mask is
    ``nms_fixpoint``'s: the CUDA kernel on the card, its plain version on the
    CPU.

    Returns boxes (B, M, 4), scores (B, M), valid (B, M) bool, anchor_idx
    (B, M) int32 into the A anchors (0 where invalid); M = max_detections."""
    top_scores, top_idx, cand_boxes, init_alive = prefilter(boxes, scores, conf_thresh, pre_topk)
    K = top_scores.shape[1]
    keep = nms_fixpoint(cand_boxes.to(torch.float32).contiguous(),
                        init_alive.to(torch.float32), iou_thresh)

    neg_inf = torch.tensor(float("-inf"), dtype=top_scores.dtype, device=top_scores.device)
    final_scores = torch.where(keep & init_alive, top_scores, neg_inf)
    M = min(max_detections, K)
    out_scores, out_idx = _top_k_stable(final_scores, M)
    out_boxes = torch.gather(cand_boxes, 1, out_idx[..., None].expand(-1, -1, 4))
    anchor_idx = torch.gather(top_idx, 1, out_idx)
    valid = torch.isfinite(out_scores)
    out_scores = torch.where(valid, out_scores, torch.zeros_like(out_scores))
    out_boxes = torch.where(valid[..., None], out_boxes, torch.zeros_like(out_boxes))
    anchor_idx = torch.where(valid, anchor_idx, torch.zeros_like(anchor_idx)).to(torch.int32)
    if M < max_detections:
        pad = max_detections - M
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
        anchor_idx = torch.nn.functional.pad(anchor_idx, (0, pad))
    return out_boxes, out_scores, valid, anchor_idx
