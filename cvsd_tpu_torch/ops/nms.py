"""Non-maximum suppression with static shapes (PyTorch port of
``cvsd_tpu/ops/nms.py``), with hand-written CUDA kernels for the greedy mask.

1. confidence mask + per-image top-K candidate prefilter (stable sort, so
   equal scores keep the lower anchor first, as ``lax.top_k`` does)
2. greedy suppression over the K score-sorted candidates, by ``method``:
   ``pallas_fixpoint`` (default) runs the Jacobi fixpoint (exactly greedy
   NMS, see ``nms_fixpoint_torch``) through ``csrc/nms_fixpoint.cu``;
   ``pallas_seq`` runs the sequential greedy loop through
   ``csrc/nms_seq.cu``. Each kernel runs on a CUDA tensor; a CPU tensor goes
   through the kernel's plain PyTorch version. Both are reached through
   PyTorch operators (``torch.ops.cvsd_tpu_torch.nms_fixpoint`` / ``nms_seq``),
   which ``torch.export`` keeps in an exported program. ``fixpoint`` and
   ``xla`` are plain XLA in the reference and run the plain versions here
   on every device (``nms_fixpoint_torch``; ``suppress_torch``, vectorised
   over the batch). All four give the same mask.
3. fixed ``max_detections`` output with a validity mask
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from cvsd_tpu_torch.ops.iou import box_iou_matrix

MAX_KERNEL_K = 1024  # 32 bit words of 32 candidates
KERNEL_METHODS = ("pallas_fixpoint", "pallas_seq")
# the reference's plain-XLA methods run the plain PyTorch versions here
PLAIN_METHODS = ("fixpoint", "xla")


def check_nms_method(method: str) -> None:
    """Raise unless ``method`` names one of the four NMS methods."""
    if method not in KERNEL_METHODS + PLAIN_METHODS:
        raise ValueError(f"unknown NMS method: {method!r}")


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


def nms_seq_torch(boxes: torch.Tensor, alive: torch.Tensor,
                  iou_thresh: float = 0.45) -> torch.Tensor:
    """Batched sequential greedy NMS -> keep mask (B, K) float32 0/1, as
    ``nms_pallas`` returns it; a candidate is alive where ``alive > 0.5``.
    The plain version of ``nms_seq_cuda``.

    ``nms_pallas`` returns the unsuppressed entries of ``alive`` as given, so
    the two agree only where ``alive`` is 0/1, as ``batched_nms`` passes it:
    an entry of 0.3 is dead in both, but ``nms_pallas`` returns 0.3 and this
    returns 0."""
    b = boxes.to(torch.float32)
    return suppress_torch(box_iou_matrix(b, b), alive > 0.5, iou_thresh).to(torch.float32)


def nms_seq_multi_torch(boxes: torch.Tensor, alive: torch.Tensor, iou_thresh: float = 0.45,
                        group: int = 8) -> torch.Tensor:
    """``nms_pallas_multi``'s keep mask (B, K) float32: grouping images
    changes nothing in the mask. The plain version of ``nms_seq_multi_cuda``.
    Like ``nms_seq_torch`` it returns 0/1, where ``nms_pallas_multi`` returns
    the unsuppressed entries of ``alive`` as given (equal for a 0/1 ``alive``)."""
    del group
    return nms_seq_torch(boxes, alive, iou_thresh)


def _check_inputs(name: str, boxes: torch.Tensor, alive: torch.Tensor) -> Tuple[int, int]:
    """The checks every NMS kernel wrapper makes before a launch -> (B, K)."""
    if boxes.device.type != "cuda" or alive.device != boxes.device:
        raise ValueError(f"{name} needs boxes and alive on one CUDA device, "
                         f"got {boxes.device} and {alive.device}")
    if boxes.dtype != torch.float32 or alive.dtype != torch.float32:
        raise TypeError(f"{name} needs float32, got {boxes.dtype}, {alive.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or tuple(alive.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"{name} needs boxes (B, K, 4) and alive (B, K), got "
                         f"{tuple(boxes.shape)} and {tuple(alive.shape)}")
    if not (boxes.is_contiguous() and alive.is_contiguous()) or boxes.data_ptr() % 16:
        raise ValueError(f"{name} needs contiguous, 16-byte aligned inputs")
    B, K = int(boxes.shape[0]), int(boxes.shape[1])
    if K > MAX_KERNEL_K:
        raise ValueError(f"{name} supports K <= {MAX_KERNEL_K}, got K={K}")
    return B, K


# argument types of each library's launcher (after the three data pointers,
# the stream comes last) and of its shared-memory query
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LAUNCHERS = {
    "nms_fixpoint": {"cvsd_nms_fixpoint": [_P, _P, _P, _I, _I, _F, _P],
                     "cvsd_nms_fixpoint_smem_bytes": [_I]},
    "nms_seq": {"cvsd_nms_seq": [_P, _P, _P, _I, _I, _F, _P],
                "cvsd_nms_seq_smem_bytes": [_I]},
}


def kernel_lib(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built and loaded, with its launchers' signatures."""
    from cvsd_tpu_torch.utils import cuda_build

    lib = cuda_build.load(name)
    for fn, argtypes in _LAUNCHERS[name].items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes = argtypes
            f.restype = ctypes.c_longlong if fn.endswith("smem_bytes") else ctypes.c_int
    return lib


def _launch(name: str, fn: str, boxes: torch.Tensor, alive: torch.Tensor, keep: torch.Tensor,
            *args) -> None:
    from cvsd_tpu_torch.utils import cuda_build

    lib = kernel_lib(name)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = getattr(lib, fn)(boxes.data_ptr(), alive.data_ptr(), keep.data_ptr(), *args, stream)
    cuda_build.check(lib, err, f"{fn} kernel launch")


def nms_fixpoint_cuda(boxes: torch.Tensor, alive: torch.Tensor,
                      iou_thresh: float = 0.45) -> torch.Tensor:
    """Launch ``csrc/nms_fixpoint.cu`` on the current stream.
    boxes (B, K, 4) float32 and alive (B, K) float32 0/1, both contiguous on
    one CUDA device; K <= 1024. Returns keep (B, K) bool. Raises on anything
    else; never falls back to the plain version."""
    B, K = _check_inputs("nms_fixpoint_cuda", boxes, alive)
    keep = torch.empty((B, K), dtype=torch.bool, device=boxes.device)
    if B == 0 or K == 0:
        return keep
    _launch("nms_fixpoint", "cvsd_nms_fixpoint", boxes, alive, keep, B, K, float(iou_thresh))
    nms_fixpoint_cuda.launches += 1
    return keep


def _nms_seq_launch(name: str, boxes: torch.Tensor, alive: torch.Tensor,
                    iou_thresh: float) -> Tuple[torch.Tensor, bool]:
    """Launch ``nms_seq_kernel`` -> (keep, whether it launched)."""
    B, K = _check_inputs(name, boxes, alive)
    keep = torch.empty((B, K), dtype=torch.float32, device=boxes.device)
    if B == 0 or K == 0:
        return keep, False
    _launch("nms_seq", "cvsd_nms_seq", boxes, alive, keep, B, K, float(iou_thresh))
    return keep, True


def nms_seq_cuda(boxes: torch.Tensor, alive: torch.Tensor,
                 iou_thresh: float = 0.45) -> torch.Tensor:
    """Launch ``nms_seq_kernel`` of ``csrc/nms_seq.cu`` (one CTA per image)
    on the current stream. Inputs as ``nms_fixpoint_cuda``'s. Returns keep
    (B, K) float32 0/1. Raises on anything else; never falls back."""
    keep, launched = _nms_seq_launch("nms_seq_cuda", boxes, alive, iou_thresh)
    nms_seq_cuda.launches += launched
    return keep


def nms_seq_multi_cuda(boxes: torch.Tensor, alive: torch.Tensor, iou_thresh: float = 0.45,
                       group: int = 8) -> torch.Tensor:
    """``nms_pallas_multi``'s counterpart: the same ``nms_seq_kernel`` launch
    as ``nms_seq_cuda``, one CTA per image. The reference's ``group`` (images
    per grid step, a VMEM budget there) changes nothing in the mask: it must
    lie in 1..32 and is otherwise unused. Inputs as ``nms_fixpoint_cuda``'s.
    Returns keep (B, K) float32 0/1. Raises on anything else."""
    G = int(group)
    if not 1 <= G <= 32:
        raise ValueError(f"nms_seq_multi_cuda needs 1 <= group <= 32, got group={G}")
    keep, launched = _nms_seq_launch("nms_seq_multi_cuda", boxes, alive, iou_thresh)
    nms_seq_multi_cuda.launches += launched
    return keep


# kernel launches made by each wrapper
nms_fixpoint_cuda.launches = 0
nms_seq_cuda.launches = 0
nms_seq_multi_cuda.launches = 0


# The two kernels on an entry point's path as PyTorch operators, so that
# torch.export traces through them (a ctypes launch needs data pointers,
# which a FakeTensor has not) and an exported program calls the kernel. Each
# op dispatches on the tensor's device: the CUDA implementation is the
# wrapper above (its launch counter counts), the CPU one the plain version;
# any other device has neither and raises. The fake returns the (B, K) bool
# shape. Both look their implementation up at call time.


@torch.library.custom_op("cvsd_tpu_torch::nms_fixpoint", mutates_args=(), device_types="cpu")
def nms_fixpoint_op(boxes: torch.Tensor, alive: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Fixpoint NMS keep mask (B, K) bool of score-sorted boxes (B, K, 4)
    float32 and alive (B, K) float32 0/1."""
    return nms_fixpoint_torch(boxes, alive, iou_thresh)


@nms_fixpoint_op.register_kernel("cuda")
def _nms_fixpoint_op_cuda(boxes, alive, iou_thresh):
    return nms_fixpoint_cuda(boxes.contiguous(), alive.contiguous(), iou_thresh)


@torch.library.custom_op("cvsd_tpu_torch::nms_seq", mutates_args=(), device_types="cpu")
def nms_seq_op(boxes: torch.Tensor, alive: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Sequential greedy keep mask (B, K) bool, inputs as ``nms_fixpoint_op``'s."""
    return nms_seq_torch(boxes, alive, iou_thresh) > 0.5


@nms_seq_op.register_kernel("cuda")
def _nms_seq_op_cuda(boxes, alive, iou_thresh):
    return nms_seq_cuda(boxes.contiguous(), alive.contiguous(), iou_thresh) > 0.5


@nms_fixpoint_op.register_fake
@nms_seq_op.register_fake
def _keep_fake(boxes, alive, iou_thresh):
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


def nms_fixpoint(boxes: torch.Tensor, alive: torch.Tensor, iou_thresh: float = 0.45) -> torch.Tensor:
    """Fixpoint NMS keep mask (B, K) bool through ``nms_fixpoint_op``: the
    CUDA kernel for CUDA tensors, the plain PyTorch version for CPU tensors."""
    return nms_fixpoint_op(boxes, alive, float(iou_thresh))


def nms_seq(boxes: torch.Tensor, alive: torch.Tensor, iou_thresh: float = 0.45) -> torch.Tensor:
    """Sequential greedy keep mask (B, K) float32 0/1 through ``nms_seq_op``:
    the CUDA kernel for CUDA tensors, the plain PyTorch version for CPU
    tensors."""
    return nms_seq_op(boxes, alive, float(iou_thresh)).to(torch.float32)


def nms_seq_multi(boxes: torch.Tensor, alive: torch.Tensor, iou_thresh: float = 0.45,
                  group: int = 8) -> torch.Tensor:
    """Grouped sequential greedy keep mask (B, K) float32 0/1: the CUDA
    kernel for CUDA tensors, the plain PyTorch version for CPU tensors."""
    if boxes.device.type == "cpu":
        return nms_seq_multi_torch(boxes, alive, iou_thresh, group)
    return nms_seq_multi_cuda(boxes, alive, iou_thresh, group)


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
    method: str = "pallas_fixpoint",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full detection postprocess: conf mask -> top-K -> greedy NMS ->
    fixed-size (boxes, scores, valid, anchor_idx) outputs. The keep mask is
    ``nms_fixpoint``'s (method 'pallas_fixpoint') or ``nms_seq``'s
    ('pallas_seq'): the CUDA kernel on the card, its plain version on the
    CPU; 'fixpoint' and 'xla' run the plain versions (the reference's plain
    XLA methods) on every device. All are the same greedy mask.

    Returns boxes (B, M, 4), scores (B, M), valid (B, M) bool, anchor_idx
    (B, M) int32 into the A anchors (0 where invalid); M = max_detections."""
    check_nms_method(method)
    top_scores, top_idx, cand_boxes, init_alive = prefilter(boxes, scores, conf_thresh, pre_topk)
    K = top_scores.shape[1]
    if method == "fixpoint":
        keep = nms_fixpoint_torch(cand_boxes, init_alive, iou_thresh)
    elif method == "xla":
        keep = suppress_torch(box_iou_matrix(cand_boxes, cand_boxes), init_alive, iou_thresh)
    else:
        cand = cand_boxes.to(torch.float32).contiguous()
        op = nms_seq_op if method == "pallas_seq" else nms_fixpoint_op
        keep = op(cand, init_alive.to(torch.float32), float(iou_thresh))

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
