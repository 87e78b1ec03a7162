"""Detection evaluation: PR curve / average precision, COCO mAP50-95, OKS
pose mAP and keypoint RMS (the port's copy of ``cvsd_tpu/eval/detection.py``).

Greedy score-descending matching and VOC-style continuous AP, COCO's
101-point AP over IoU (or OKS) 0.50:0.95. Pure numpy on the host, as the
reference's, but for ``evaluate_detector``, which runs the port's detect
function (``models/detector.py::make_detect_fn``, whose NMS is the
``nms_fixpoint`` kernel on the card) over the evaluation set in fixed-size
chunks.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def match_detections(
    pred_boxes: np.ndarray,   # (N, 4) one image, any order
    pred_scores: np.ndarray,  # (N,)
    gt_boxes: np.ndarray,     # (M, 4)
    iou_thresh: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Greedy score-descending matching. Returns (tp (N,) bool in score order,
    scores sorted desc, num_gt). Each GT matches at most one detection."""
    order = np.argsort(-pred_scores)
    pb, ps = pred_boxes[order], pred_scores[order]
    iou = _iou_matrix(pb, gt_boxes)
    taken = np.zeros(len(gt_boxes), bool)
    tp = np.zeros(len(pb), bool)
    for i in range(len(pb)):
        if len(gt_boxes) == 0:
            break
        j = int(np.argmax(np.where(taken, -1.0, iou[i])))
        if iou[i, j] >= iou_thresh and not taken[j]:
            taken[j] = True
            tp[i] = True
    return tp, ps, len(gt_boxes)


def detection_pr(
    pred_boxes: Sequence[np.ndarray],
    pred_scores: Sequence[np.ndarray],
    gt_boxes: Sequence[np.ndarray],
    iou_thresh: float = 0.5,
) -> Dict[str, np.ndarray]:
    """Dataset-level PR curve + AP over per-image detection lists.

    Returns {'precision', 'recall', 'scores', 'ap', 'num_gt', 'num_pred'};
    AP is the area under the precision envelope (continuous VOC metric).
    """
    all_tp, all_scores, total_gt = [], [], 0
    for pb, ps, gb in zip(pred_boxes, pred_scores, gt_boxes):
        tp, ss, ng = match_detections(np.asarray(pb, np.float32),
                                      np.asarray(ps, np.float32),
                                      np.asarray(gb, np.float32), iou_thresh)
        all_tp.append(tp)
        all_scores.append(ss)
        total_gt += ng
    tp = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0, np.float32)
    order = np.argsort(-scores)
    tp, scores = tp[order], scores[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    recall = cum_tp / max(total_gt, 1)
    # precision envelope (monotone non-increasing from the right)
    env = np.maximum.accumulate(precision[::-1])[::-1] if len(precision) else precision
    # integrate over recall deltas
    if len(recall):
        r_prev = np.concatenate([[0.0], recall[:-1]])
        ap = float(np.sum((recall - r_prev) * env))
    else:
        ap = 0.0
    return {"precision": precision, "recall": recall, "scores": scores,
            "ap": ap, "num_gt": total_gt, "num_pred": len(scores)}


def _coco_ap(precision: np.ndarray, recall: np.ndarray) -> float:
    """COCO-style 101-point interpolated AP from a PR curve."""
    if len(recall) == 0:
        return 0.0
    env = np.maximum.accumulate(precision[::-1])[::-1]
    pts = np.linspace(0.0, 1.0, 101)
    idx = np.searchsorted(recall, pts, side="left")
    interp = np.where(idx < len(env), env[np.minimum(idx, len(env) - 1)], 0.0)
    return float(np.mean(interp))


def _greedy_pr_curve(per_image, total_gt: int, thresh: float):
    """Greedy matching (score-descending, per image) at one similarity
    threshold over precomputed (scores_desc, sim_matrix) pairs -> PR curve."""
    all_tp, all_scores = [], []
    for ps, sim in per_image:
        taken = np.zeros(sim.shape[1], bool)
        tp = np.zeros(len(ps), bool)
        for i in range(len(ps)):
            if sim.shape[1] == 0:
                break
            j = int(np.argmax(np.where(taken, -1.0, sim[i])))
            if sim[i, j] >= thresh and not taken[j]:
                taken[j] = True
                tp[i] = True
        all_tp.append(tp)
        all_scores.append(ps)
    tp = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0, np.float32)
    order = np.argsort(-scores)
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    recall = cum_tp / max(total_gt, 1)
    return precision, recall


def detection_map(
    pred_boxes: Sequence[np.ndarray],
    pred_scores: Sequence[np.ndarray],
    gt_boxes: Sequence[np.ndarray],
) -> Dict[str, object]:
    """COCO-style mAP over IoU 0.50:0.95:0.05 (101-point interpolation).

    ultralytics' standard validation report is mAP50 / mAP50-95, so this
    makes that axis a measured quantity. IoU matrices are computed ONCE per image and reused
    across thresholds (the greedy matching itself is threshold-dependent).
    Returns {'map50', 'map75', 'map50_95', 'per_iou'}.
    """
    per_image = []
    total_gt = 0
    for pb, ps, gb in zip(pred_boxes, pred_scores, gt_boxes):
        pb = np.asarray(pb, np.float32)
        ps = np.asarray(ps, np.float32)
        gb = np.asarray(gb, np.float32)
        order = np.argsort(-ps)
        per_image.append((ps[order], _iou_matrix(pb[order], gb)))
        total_gt += len(gb)
    per_iou = {}
    for t in np.arange(0.50, 0.951, 0.05):
        precision, recall = _greedy_pr_curve(per_image, total_gt, float(t))
        per_iou[round(float(t), 2)] = _coco_ap(precision, recall)
    aps = list(per_iou.values())
    return {
        "map50": per_iou[0.5],
        "map75": per_iou[0.75],
        "map50_95": float(np.mean(aps)),
        "per_iou": per_iou,
    }


# COCO-17 per-keypoint sigmas (OKS constants, from the COCO keypoint task).
COCO_KPT_SIGMAS = np.array(
    [0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
     0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089], np.float32)


def oks_matrix(
    pred_kpts: np.ndarray,  # (N, K, >=2) px
    gt_kpts: np.ndarray,    # (M, K, 2) px
    gt_areas: np.ndarray,   # (M,) box areas in px^2
    sigmas: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(N, M) object-keypoint-similarity matrix (COCO OKS, all kpts visible)."""
    if len(pred_kpts) == 0 or len(gt_kpts) == 0:
        return np.zeros((len(pred_kpts), len(gt_kpts)), np.float32)
    K = gt_kpts.shape[1]
    if sigmas is None:
        sigmas = COCO_KPT_SIGMAS[:K] if K <= len(COCO_KPT_SIGMAS) \
            else np.full(K, 0.05, np.float32)
    d2 = np.sum((pred_kpts[:, None, :, :2] - gt_kpts[None, :, :, :2]) ** 2, -1)
    var = (2.0 * sigmas[None, None, :]) ** 2
    s = np.maximum(gt_areas, 1.0)[None, :, None]
    return np.mean(np.exp(-d2 / (2.0 * s * var)), axis=-1).astype(np.float32)


def pose_map(
    pred_kpts: Sequence[np.ndarray],   # per image (N, K, >=2)
    pred_scores: Sequence[np.ndarray],  # per image (N,)
    gt_kpts: Sequence[np.ndarray],      # per image (M, K, 2)
    gt_boxes: Sequence[np.ndarray],     # per image (M, 4) xyxy (for OKS area)
    sigmas: Optional[np.ndarray] = None,
) -> Dict[str, object]:
    """COCO-style keypoint mAP: greedy OKS matching at thresholds
    0.50:0.95:0.05, 101-point AP, averaged. Mirrors ultralytics' pose-val
    metric so the top-down pose path is measurable on the standard axis.
    """
    # OKS matrices computed once per image; the (threshold-dependent) greedy
    # matching re-runs per threshold over the cached matrices.
    per_image = []
    total_gt = 0
    for pk, ps, gk, gb in zip(pred_kpts, pred_scores, gt_kpts, gt_boxes):
        pk = np.asarray(pk, np.float32)
        ps = np.asarray(ps, np.float32)
        gk = np.asarray(gk, np.float32)
        gb = np.asarray(gb, np.float32)
        areas = (np.clip(gb[:, 2] - gb[:, 0], 0, None)
                 * np.clip(gb[:, 3] - gb[:, 1], 0, None)) if len(gb) else np.zeros(0)
        order = np.argsort(-ps)
        per_image.append((ps[order], oks_matrix(pk[order], gk, areas, sigmas)))
        total_gt += len(gk)
    per_oks: Dict[float, float] = {}
    for t in np.arange(0.50, 0.951, 0.05):
        precision, recall = _greedy_pr_curve(per_image, total_gt, float(t))
        per_oks[round(float(t), 2)] = _coco_ap(precision, recall)
    aps = list(per_oks.values())
    return {"pose_map50": per_oks[0.5], "pose_map50_95": float(np.mean(aps)),
            "per_oks": per_oks}


def keypoint_rms(
    pred_kpts: np.ndarray,   # (N, K, >=2) px for matched detections
    gt_kpts: np.ndarray,     # (N, K, 2) px
    gt_boxes: Optional[np.ndarray] = None,  # (N, 4) for scale normalization
) -> Dict[str, float]:
    """RMS keypoint error for matched detections, absolute px and normalized
    by box width (comparable across scales)."""
    if len(pred_kpts) == 0:
        return {"rms_px": float("nan"), "rms_norm": float("nan"), "n": 0}
    err = np.linalg.norm(pred_kpts[..., :2] - gt_kpts, axis=-1)  # (N, K)
    rms_px = float(np.sqrt(np.mean(err ** 2)))
    if gt_boxes is not None:
        w = np.clip(gt_boxes[:, 2] - gt_boxes[:, 0], 1.0, None)[:, None]
        rms_norm = float(np.sqrt(np.mean((err / w) ** 2)))
    else:
        rms_norm = float("nan")
    return {"rms_px": rms_px, "rms_norm": rms_norm, "n": int(len(pred_kpts))}


def evaluate_detector(
    detect_fn,
    images: np.ndarray,     # (B, S, S, 3) f32
    gt_boxes: np.ndarray,   # (B, P, 4)
    gt_valid: np.ndarray,   # (B, P)
    gt_kpts: Optional[np.ndarray] = None,  # (B, P, K, 2)
    iou_thresh: float = 0.5,
    batch_size: int = 16,
    coco_map: bool = False,
    device: DeviceLike = None,
) -> Dict[str, object]:
    """Run the port's detect function (``make_detect_fn(model, ...)``, the
    model on ``device``: default the CUDA card, raising without one) over an
    evaluation set and compute PR/AP (+ keypoint RMS when the model has a
    pose head). The last chunk is zero-padded to ``batch_size``, so the
    detector and its NMS kernel always see one batch shape. Matched keypoints
    pair each TP detection with its greedily-matched GT. With coco_map=True
    also reports mAP50-95 (and OKS pose mAP when keypoints are present)."""
    dev = resolve_device(device)
    pb_list, ps_list, gb_list = [], [], []
    pk_list, gk_list = [], []
    mk_pred, mk_gt, mk_boxes = [], [], []
    B = len(images)
    for s in range(0, B, batch_size):
        chunk = images[s:s + batch_size]
        pad = batch_size - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)])
        out = detect_fn(torch.from_numpy(np.ascontiguousarray(chunk)).to(dev))
        boxes, scores, valid = (o.cpu().numpy() for o in out[:3])
        kpts = out[3].cpu().numpy() if len(out) > 3 else None
        for i in range(len(chunk) - pad):
            b = s + i
            keep = valid[i]
            pb, ps = boxes[i][keep], scores[i][keep]
            gb = gt_boxes[b][gt_valid[b]]
            pb_list.append(pb)
            ps_list.append(ps)
            gb_list.append(gb)
            if kpts is not None and gt_kpts is not None:
                pk_list.append(kpts[i][keep])
                gk_list.append(gt_kpts[b][gt_valid[b]])
            if kpts is not None and gt_kpts is not None and len(pb) and len(gb):
                order = np.argsort(-ps)
                iou = _iou_matrix(pb[order], gb)
                taken = np.zeros(len(gb), bool)
                gk = gt_kpts[b][gt_valid[b]]
                pk = kpts[i][keep][order]
                for d in range(len(pb)):
                    j = int(np.argmax(np.where(taken, -1.0, iou[d])))
                    if iou[d, j] >= iou_thresh and not taken[j]:
                        taken[j] = True
                        mk_pred.append(pk[d])
                        mk_gt.append(gk[j])
                        mk_boxes.append(gb[j])
    result: Dict[str, object] = detection_pr(pb_list, ps_list, gb_list, iou_thresh)
    if mk_pred:
        result["keypoints"] = keypoint_rms(np.stack(mk_pred), np.stack(mk_gt),
                                           np.stack(mk_boxes))
    if coco_map:
        result.update(detection_map(pb_list, ps_list, gb_list))
        if pk_list:
            result.update(pose_map(pk_list, ps_list, gk_list, gb_list))
    return result
