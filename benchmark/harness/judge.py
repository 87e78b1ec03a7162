"""The comparison that decides ``correct`` for the detection cells.

The program's served detections of a frame are judged against the float32
reference run over the same frames and weights (``reference/detector.py``).
Rounding moves the program's scores a little, and the order of near-equal
candidates, and with it which of them NMS keeps, may change; so no set is
compared with a set. Instead each served detection is tied to the
reference's anchor it came from (``match``), and then judged by what it
says. A served box that does not touch the frame's edge is put back on the
canvas exactly; one clamped to the edge cannot be, so it is tied by its
clamped box and left out of every judgement below but ``score_gap``.

With random weights bfloat16 moves a few detections a long way on some
seeds (a box logit by up to 0.8, where float32 runs of the program agree
with the reference to 1e-4), and the float8 control leaves most of them
exact on others; so the widest gaps of the two overlap, and the readings a
cell's limits can name are shares of the judged detections off by more
than a tolerance, and exact counts:

- ``score_off2_pct`` / ``score_off5_pct``: its score against the anchor's
  reference score, off by more than 0.02 / 0.05;
- ``box_off10_pct``: its box, from its xyxy and from its xywhn, put back
  on the canvas and measured against the anchor's reference box in the
  units the head regresses (``head_gap``), off by more than 0.1 (letterbox,
  detector, decode, TTA merge, unletterbox, xywhn);
- with the pose head, ``kpt_off25_pct``: its keypoints against the
  reference's at that anchor, a gap over the reference keypoint's distance
  from the anchor's cell centre plus the stride (the head regresses that
  offset) above 0.25, or a confidence's above 0.05;
- with the top-down net, ``kpt_gap_px`` and ``kpt_conf_gap``: the widest
  gap of its keypoints (canvas px) and of their confidences against the
  reference net's on the program's own box;
- ``nms_overlaps``: NMS's own rule on the served boxes: the pairs of a
  frame whose IoU, in the program's geometry, exceeds the threshold by more
  than ``NMS_SLACK`` (an exact comparison: NMS left too much);
- ``empty_frames``: the frames that one side serves no detection and the
  other some (an exact comparison: a frame left out).

Printed beside them, and named by neither cell's limits: the widest
``box_gap`` (over the reference box's longer side), ``box_head_gap``,
``xywhn_gap``, ``score_gap``, the pose head's ``kpt_gap`` and
``kpt_conf_gap``; ``iou_excess`` (the largest
reference IoU of two picks above the threshold) and ``miss_gap`` (NMS took
too much: the largest reference score by which a candidate of the top
``pre_topk`` that no pick stands for lies above the frame's lowest pick,
where no pick with a higher reference score overlaps it by more than the
threshold less ``IOU_SLACK``). The run's ``correct`` holds where each
reading that the cell's limits name is within its limit."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from reference import detector as R

IOU_SLACK = 0.05  # miss_gap: a candidate counts as suppressed from threshold - slack
NMS_SLACK = 0.01  # nms_overlaps: room for the served box's rounding on the way back to the canvas
BOX_TOL = 0.1  # box_off10_pct: a box off by more than this in the head's units
KPT_TOL, KPT_CONF_TOL = 0.25, 0.05  # kpt_off25_pct: a keypoint off by more than these
SCORE_TOLS = (0.02, 0.05)  # score_off<%>_pct: a score off by more than this
SUMMED = ("empty_frames", "nms_overlaps")
SCORE_WEIGHT = 1.0  # matching cost: a score's gap of 0.01 weighs as a box's of 1 % of its extent
PRE_TOPK = 256


def _max(x: torch.Tensor, mask: torch.Tensor) -> float:
    x = torch.where(mask, x, torch.zeros_like(x))
    return float(x.max()) if x.numel() else 0.0


def match(dist: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Each served detection's anchor (B, M) from ``dist`` (B, M, A): in the
    program's order, the nearest anchor not yet taken."""
    Bn, M, _ = dist.shape
    taken = torch.zeros_like(dist[:, 0], dtype=torch.bool)
    anchors = torch.zeros((Bn, M), dtype=torch.long, device=dist.device)
    ar = torch.arange(Bn, device=dist.device)
    for t in range(M):
        a = dist[:, t].masked_fill(taken, math.inf).argmin(-1)
        anchors[:, t] = a
        taken[ar, a] |= valid[:, t]
    return anchors


def head_gap(det: dict, boxes: torch.Tensor, ref: torch.Tensor, stride: torch.Tensor):
    """Canvas boxes (..., 4) against the reference's at their anchors, in
    the units the head regresses and rounding acts in: the anchor-free
    head's centre in strides and its sides as logs (it decodes exp(t) x
    stride), the DFL head's four sides in strides."""
    st = stride[..., None]
    if det.get("head_variant", "anchor_free") == "v8dfl":
        return ((boxes - ref).abs() / st).amax(-1)
    wh = (boxes[..., 2:] - boxes[..., :2]).clamp_min(1e-3)
    ref_wh = (ref[..., 2:] - ref[..., :2]).clamp_min(1e-3)
    centre = ((boxes[..., :2] + boxes[..., 2:]) - (ref[..., :2] + ref[..., 2:])).abs() / (2 * st)
    return torch.cat([centre, (wh / ref_wh).log().abs()], -1).amax(-1)


@torch.no_grad()
def judge_block(det: dict, ref: Dict[str, torch.Tensor], prog: List[torch.Tensor],
                src_hw, pose_ctx: Optional[R.Ctx] = None) -> Dict[str, float]:
    """Readings for one block of frames. ``ref``: ``reference.detector.detect``'s
    dict for the frames; ``prog``: the program's (boxes, xywhn, scores,
    valid[, kpts]) for them, on the reference's device."""
    H, W = src_hw
    size = int(det["img_size"])
    conf, thr = float(det["conf_threshold"]), float(det["iou_threshold"])
    boxes, xywhn, scores = (t.to(torch.float32) for t in prog[:3])
    valid = prog[3].bool()
    kpts = prog[4].to(torch.float32) if len(prog) > 4 else None
    cb, cs, ck = ref["cand_boxes"], ref["cand_scores"], ref["cand_kpts"]
    dev = cb.device
    Bn, M = scores.shape
    ar = torch.arange(Bn, device=dev)[:, None]
    src = R.unletterbox(cb, H, W, size)  # (B, A, 4)
    scale, px, py, _, _ = R.letterbox_geometry(H, W, size)
    shift = torch.tensor([px, py, px, py], dtype=torch.float32, device=dev)
    canvas = boxes * scale + shift  # exact where not clamped
    clamped = (boxes[..., :2] == 0).any(-1) | (boxes[..., 2] == W) | (boxes[..., 3] == H)
    head_kpts = kpts is not None and ck is not None
    centres, strides = R.anchor_grid(size, dev)
    # matching cost, in the same units for every anchor: each box coordinate's
    # gap over the served box's extent along that axis (at least the finest
    # stride). Rounding moves a long thin box along its long axis, where its
    # neighbour one row away differs across the thin one: over the longer
    # side alone, or over the anchor's stride, the neighbour came nearer.
    # Keypoint gaps over twice the longer side.
    ext = (canvas[..., 2:] - canvas[..., :2]).clamp_min(float(strides.min()))  # (B, M, 2)
    unit = ext.repeat(1, 1, 2)
    dist = torch.empty((Bn, M, cb.shape[1]), device=dev)
    for m in range(0, M, 16):
        sl = slice(m, m + 16)
        gap = torch.where(clamped[:, sl, None, None],
                          (boxes[:, sl, None] - src[:, None]).abs() * scale,
                          (canvas[:, sl, None] - cb[:, None]).abs())
        d = (gap / unit[:, sl, None]).amax(-1)
        d = d + SCORE_WEIGHT * (scores[:, sl, None] - cs[:, None]).abs()
        if head_kpts:
            kd = (kpts[:, sl, None, :, :2] - ck[:, None, :, :, :2]).abs().amax((-1, -2))
            d = d + kd / (2 * ext[:, sl, None].amax(-1))
        dist[:, sl] = d
    anchors = match(dist, valid)
    del dist
    rsrc = src[ar, anchors]
    side = torch.maximum(rsrc[..., 2] - rsrc[..., 0], rsrc[..., 3] - rsrc[..., 1])
    side = torch.maximum(side, strides[anchors] / scale)
    judged = valid & ~clamped
    score_off = (scores - cs[ar, anchors]).abs()
    # the served box put back on the canvas twice, from its xyxy and from
    # its xywhn, each judged in the head's own units
    x, y, w, h = xywhn.unbind(-1)
    from_n = torch.stack([(x - w / 2) * W, (y - h / 2) * H, (x + w / 2) * W, (y + h / 2) * H], -1)
    rb = cb[ar, anchors]
    head_off = torch.maximum(head_gap(det, canvas, rb, strides[anchors]),
                             head_gap(det, from_n * scale + shift, rb, strides[anchors]))
    out = {
        "empty_frames": float((valid.any(-1) != ref["valid"].bool().any(-1)).sum()),
        "n.judged": float(judged.sum()),
        "n.box_off10_pct": float((judged & (head_off > BOX_TOL)).sum()),
        "box_head_gap": _max(head_off, judged),
        "box_gap": _max((boxes - rsrc).abs().amax(-1) / side, judged),
        "xywhn_gap": _max((xywhn - R.xywhn(rsrc, H, W)).abs().amax(-1), judged),
        "score_gap": _max(score_off, valid),
    }
    for tol in SCORE_TOLS:
        out[f"n.score_off{round(100 * tol)}_pct"] = float((judged & (score_off > tol)).sum())
    if head_kpts:
        rk = ck[ar, anchors]
        reach = ((rk[..., :2] - centres[anchors][:, :, None]).abs()
                 + strides[anchors][:, :, None, None])
        k_off = ((kpts[..., :2] - rk[..., :2]).abs() / reach).amax((-1, -2))
        c_off = (kpts[..., 2] - rk[..., 2]).abs().amax(-1)
        out["n.kpt_off25_pct"] = float((judged & ((k_off > KPT_TOL) | (c_off > KPT_CONF_TOL))).sum())
        out["kpt_gap"] = _max(k_off, judged)
        out["kpt_conf_gap"] = _max(c_off, judged)
    elif kpts is not None:
        # the top-down net on the program's own box, put back on the canvas
        rk = R.topdown_pose(pose_ctx, det.get("pose_topdown") or {}, ref["canvas"], canvas)
        out["kpt_gap_px"] = _max((kpts[..., :2] - rk[..., :2]).abs().amax((-1, -2)), judged)
        out["kpt_conf_gap"] = _max((kpts[..., 2] - rk[..., 2]).abs().amax(-1), judged)
    pair = (torch.ones(M, M, dtype=torch.bool, device=dev).triu(1)
            & judged[:, :, None] & judged[:, None])
    # NMS's own rule on the served boxes, in the program's geometry
    out["nms_overlaps"] = float(((R.box_iou(canvas, canvas) > thr + NMS_SLACK) & pair).sum())
    # NMS in the reference's geometry
    picks = cb[ar, anchors]
    iou_pp = R.box_iou(picks, picks)
    out["iou_excess"] = max(0.0, float((iou_pp - thr).masked_fill(~pair, 0.0).max()))
    vals, idx, alive = R.top_candidates(cs, conf, min(PRE_TOPK, cs.shape[1]))
    cand, cand_src = cb[ar, idx], src[ar, idx]
    cand_clamped = ((cand_src[..., :2] == 0).any(-1) | (cand_src[..., 2] == W)
                    | (cand_src[..., 3] == H))
    picked = (idx[:, :, None] == anchors[:, None, :]).logical_and(valid[:, None]).any(-1)
    pick_s = cs[ar, anchors]
    over = (R.box_iou(cand, picks) > thr - IOU_SLACK) & valid[:, None]  # (B, K, M)
    over &= pick_s[:, None, :] > vals[:, :, None]
    lowest = pick_s.masked_fill(~valid, math.inf).amin(-1)
    missed = alive & ~picked & ~cand_clamped & ~over.any(-1)
    gap = (vals - lowest[:, None]).masked_fill(~missed, 0.0)
    out["miss_gap"] = max(0.0, float(gap.max()))
    return out


def merge(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest of each reading over the blocks; the counts summed; each
    share (``n.<name>_pct``) in % of the judged detections."""
    acc: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            summed = k.startswith("n.") or k in SUMMED
            acc[k] = acc.get(k, 0.0) + v if summed else max(acc.get(k, 0.0), v)
    n = acc.pop("n.judged", 0.0)
    out = {k: v for k, v in acc.items() if not k.startswith("n.")}
    for k, v in acc.items():
        if k.startswith("n."):
            out[k[2:]] = 100.0 * v / n if n else float("nan")
    return out


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """{name: {value, limit}} for every reading, limits last; a reading
    without a limit, or one that is not finite, fails."""
    return {k: {"value": readings[k], "limit": limits.get(k)} for k in readings}


def passed(checks: Dict[str, Dict]) -> bool:
    return bool(checks) and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
