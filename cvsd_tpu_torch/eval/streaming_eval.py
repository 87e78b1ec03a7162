"""Streaming evaluation: join live ScoreEvents against temporal ground truth
-> AUC (PyTorch port's copy of ``cvsd_tpu/eval/streaming_eval.py``; numpy).

Events from ``StreamingPipeline.stream_videos*`` are joined with UCF-Crime
temporal annotations (``data/ucf_crime.read_temporal_annotations``) to give

- video-level AUC (per-video aggregated score vs "has anomalous ranges"),
  with a bootstrap confidence interval over videos
- event-level (window) AUC: each scored window is labeled anomalous when any
  of its frames falls inside an annotated range
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cvsd_tpu_torch.data.ucf_crime import TemporalAnnotation
from cvsd_tpu_torch.utils.metrics import AGGREGATORS, compute_auc_roc


def _norm_name(name: str) -> str:
    base = name.rsplit("/", 1)[-1]
    return base[:-4] if base.endswith((".mp4", ".avi", ".mkv")) else base


def _annotation_index(annotations: Sequence[TemporalAnnotation]) -> Dict[str, TemporalAnnotation]:
    return {_norm_name(a.name): a for a in annotations}


@dataclass
class StreamingEvalResult:
    video_auc: float
    video_auc_ci: Tuple[float, float]  # bootstrap 95% over videos
    event_auc: float
    n_videos: int
    n_events: int
    aggregation: str
    per_video: Dict[str, Dict[str, float]] = field(default_factory=dict)
    unmatched_videos: List[str] = field(default_factory=list)

    def as_dict(self) -> Dict[str, object]:
        return {
            "video_auc": self.video_auc, "video_auc_ci": list(self.video_auc_ci),
            "event_auc": self.event_auc, "n_videos": self.n_videos,
            "n_events": self.n_events, "aggregation": self.aggregation,
            "unmatched_videos": self.unmatched_videos,
        }


def join_events(
    events: Sequence,  # StreamingPipeline ScoreEvents
    annotations: Sequence[TemporalAnnotation],
) -> Tuple[Dict[str, List], Dict[str, TemporalAnnotation], List[str]]:
    """Group events by normalized video name and pair with annotations.
    Returns (events_by_video, matched annotation per video, unmatched names)."""
    idx = _annotation_index(annotations)
    by_video: Dict[str, List] = {}
    for e in events:
        by_video.setdefault(_norm_name(e.video), []).append(e)
    matched, unmatched = {}, []
    for name in by_video:
        if name in idx:
            matched[name] = idx[name]
        else:
            unmatched.append(name)
    return by_video, matched, unmatched


def _bootstrap_auc_ci(
    labels: np.ndarray, scores: np.ndarray, n_boot: int = 1000, seed: int = 0
) -> Tuple[float, float]:
    """95% bootstrap CI over videos; degenerate resamples are skipped."""
    rng = np.random.default_rng(seed)
    n = len(labels)
    aucs = []
    for _ in range(n_boot):
        pick = rng.integers(0, n, n)
        lb = labels[pick]
        if lb.min() == lb.max():
            continue
        aucs.append(compute_auc_roc(lb, scores[pick])[0])
    if not aucs:
        return (float("nan"), float("nan"))
    return (float(np.percentile(aucs, 2.5)), float(np.percentile(aucs, 97.5)))


def evaluate_streaming(
    events: Sequence,
    annotations: Sequence[TemporalAnnotation],
    aggregation: str = "max",
    n_boot: int = 1000,
    include_eventless_videos: Optional[Sequence[str]] = None,
) -> StreamingEvalResult:
    """Full streaming-vs-GT evaluation.

    include_eventless_videos: annotated videos that were streamed but produced
    ZERO score events (no tracks long enough). They score 0 at video level —
    excluding them would silently bias AUC upward.
    """
    agg_fn = AGGREGATORS[aggregation]
    by_video, matched, unmatched = join_events(events, annotations)
    idx = _annotation_index(annotations)

    v_labels, v_scores, per_video = [], [], {}
    for name, evs in by_video.items():
        ann = matched.get(name)
        if ann is None:
            continue
        score = float(agg_fn(np.asarray([e.score for e in evs])))
        label = int(bool(ann.ranges))
        v_labels.append(label)
        v_scores.append(score)
        per_video[name] = {"score": score, "label": label, "events": len(evs)}
    for name in include_eventless_videos or ():
        key = _norm_name(name)
        ann = idx.get(key)
        if ann is not None and key not in per_video:
            v_labels.append(int(bool(ann.ranges)))
            v_scores.append(0.0)
            per_video[key] = {"score": 0.0, "label": int(bool(ann.ranges)), "events": 0}

    v_labels_a = np.asarray(v_labels, np.int32)
    v_scores_a = np.asarray(v_scores, np.float64)
    video_auc = compute_auc_roc(v_labels_a, v_scores_a)[0] if len(v_labels_a) else float("nan")
    ci = _bootstrap_auc_ci(v_labels_a, v_scores_a, n_boot) if len(v_labels_a) >= 2 else (
        float("nan"), float("nan"))

    e_labels, e_scores = [], []
    for name, evs in by_video.items():
        ann = matched.get(name)
        if ann is None:
            continue
        for e in evs:
            frames = getattr(e, "frames", None) or [e.frame_end]
            e_labels.append(int(any(ann.frame_label(f) for f in frames)))
            e_scores.append(e.score)
    event_auc = (compute_auc_roc(np.asarray(e_labels), np.asarray(e_scores))[0]
                 if e_labels else float("nan"))

    return StreamingEvalResult(
        video_auc=float(video_auc), video_auc_ci=ci, event_auc=float(event_auc),
        n_videos=len(per_video), n_events=sum(p["events"] for p in per_video.values()),
        aggregation=aggregation, per_video=per_video, unmatched_videos=sorted(unmatched),
    )
