"""Fault 1's motion reading: how the boxes and keypoints that the synthetic
chain extracts from its held-out videos move from frame to frame, against
the rendered truth.

The window AUC is the Shopformer's test AUC on the *extracted* test poses,
and the Shopformer scores how poses move over time. This reads that motion
on the PoseLift ``Test`` split a chain run writes
(``Pickle_files/Test/<video>.pkl``: ``{frame: {track: [box_xyxy, (17, 3)
keypoints]}}`` in source pixels, frames numbered from 1). The truth comes
from replaying ``render_pose_frame`` with each held-out video's render
seed, as ``render_pose_video`` draws it, without writing a video
(``end_to_end_synthetic.held_out_specs``).

Readings, every distance divided by the true box height of frame t:

- ``kpt_motion_*``: for each track and each pair of consecutive frames t,
  t + 1, the mean over the 17 joints of ``|(k^_{t+1} - k^_t) - (k_{t+1} -
  k_t)|``; ``_median`` over all pairs, ``_track_mean`` the mean over tracks
  of each track's median;
- ``box_motion_*``: the same for the centre of the box in the file (the
  detection the pose was taken through, under the IoU tracker);
- ``tracks_per_video``: the mean count of tracks a video (the truth is one
  person); ``frame_coverage``: the mean share of a video's frames that some
  track covers;
- ``static_kpt_rms``: the root mean square over frames, tracks and joints
  of ``|k^_t - k_t|``.

    python examples_torch/fault1_motion.py --poselift DIR/PoseLift

prints the readings as one JSON line. Imports numpy and the port's
renderer; no model runs.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import sys
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from end_to_end_synthetic import held_out_specs  # noqa: E402
from cvsd_tpu_torch.data.render import render_pose_frame  # noqa: E402

WIDTH, HEIGHT = 320, 240  # render_pose_video's frame size, the example's
READINGS = ("kpt_motion_median", "kpt_motion_track_mean", "box_motion_median",
            "box_motion_track_mean", "tracks_per_video", "frame_coverage", "static_kpt_rms")

Truth = Tuple[np.ndarray, np.ndarray]  # boxes (T, 4) xyxy px, keypoints (T, 17, 2) px


def replay(poses: np.ndarray, seed: int) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """``render_pose_video``'s frames before encoding: (frame, box, points)
    per pose, drawn from ``np.random.default_rng(seed)`` in its order."""
    rng = np.random.default_rng(seed)
    for pose in poses:
        yield render_pose_frame(pose, HEIGHT, WIDTH, rng)


def truth_of(poses: np.ndarray, seed: int) -> Truth:
    boxes, kpts = zip(*((box, pts) for _frame, box, pts in replay(poses, seed)))
    return np.stack(boxes), np.stack(kpts)


def held_out_truth(n_test: int) -> Dict[str, Truth]:
    """The true box and keypoints of every frame of the example's held-out
    videos, by video name."""
    return {name: truth_of(poses, seed) for name, _kind, poses, seed in held_out_specs(n_test)}


def read_split(poselift_dir: str, split: str = "Test") -> Dict[str, dict]:
    out = {}
    for path in sorted(glob.glob(os.path.join(poselift_dir, "Pickle_files", split, "*.pkl"))):
        with open(path, "rb") as f:
            out[os.path.splitext(os.path.basename(path))[0]] = pickle.load(f)
    return out


def _centre(box: np.ndarray) -> np.ndarray:
    return np.array([(box[0] + box[2]) / 2, (box[1] + box[3]) / 2])


def motion_reading(extracted: Dict[str, dict], truth: Dict[str, Truth]) -> Dict[str, float]:
    """The readings of the module docstring over every video of
    ``extracted`` (``{video: {frame: {track: [box, keypoints]}}}``, frames
    from 1) against ``truth`` (by video)."""
    kpt_pairs: List[float] = []
    box_pairs: List[float] = []
    kpt_track: List[float] = []
    box_track: List[float] = []
    static: List[np.ndarray] = []
    tracks_per_video, coverage = [], []
    for name, frames in extracted.items():
        true_boxes, true_kpts = truth[name]
        height = true_boxes[:, 3] - true_boxes[:, 1]
        tracks: Dict[int, Dict[int, Tuple[np.ndarray, np.ndarray]]] = {}
        for frame, people in frames.items():
            t = int(frame) - 1
            for track, (box, kpts) in people.items():
                xy = np.asarray(kpts, np.float64)[:, :2]
                tracks.setdefault(int(track), {})[t] = (np.asarray(box, np.float64), xy)
                static.append(np.linalg.norm(xy - true_kpts[t], axis=-1) / height[t])
        tracks_per_video.append(len(tracks))
        coverage.append(len(frames) / len(true_boxes))  # a frame is kept only with a track
        for seen in tracks.values():
            k_res, b_res = [], []
            for t in sorted(seen):
                if t + 1 not in seen:
                    continue
                (b0, k0), (b1, k1) = seen[t], seen[t + 1]
                dk = (k1 - k0) - (true_kpts[t + 1] - true_kpts[t])
                k_res.append(float(np.linalg.norm(dk, axis=-1).mean() / height[t]))
                db = ((_centre(b1) - _centre(b0))
                      - (_centre(true_boxes[t + 1]) - _centre(true_boxes[t])))
                b_res.append(float(np.linalg.norm(db) / height[t]))
            if k_res:
                kpt_pairs += k_res
                box_pairs += b_res
                kpt_track.append(float(np.median(k_res)))
                box_track.append(float(np.median(b_res)))

    def median(xs):
        return float(np.median(xs)) if xs else None

    def mean(xs):
        return float(np.mean(xs)) if xs else None

    return {
        "kpt_motion_median": median(kpt_pairs), "kpt_motion_track_mean": mean(kpt_track),
        "box_motion_median": median(box_pairs), "box_motion_track_mean": mean(box_track),
        "tracks_per_video": mean(tracks_per_video), "frame_coverage": mean(coverage),
        "static_kpt_rms": (float(np.sqrt(np.mean(np.concatenate(static) ** 2)))
                           if static else None),
        "videos": len(extracted), "tracks": int(sum(tracks_per_video)),
        "pairs": len(kpt_pairs),
    }


def poselift_reading(poselift_dir: str) -> Dict[str, float]:
    """The readings on a chain run's extracted ``Test`` split: as many
    held-out videos as the split holds, their truth replayed."""
    extracted = read_split(poselift_dir)
    if not extracted:
        raise FileNotFoundError(f"no Test split under {poselift_dir}")
    truth = held_out_truth(len(extracted))
    if set(truth) != set(extracted):
        raise ValueError(f"the Test split's videos {sorted(extracted)} are not the example's "
                         f"{len(extracted)} held-out videos")
    return motion_reading(extracted, truth)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--poselift", required=True, help="a chain run's PoseLift directory")
    args = p.parse_args(argv)
    res = poselift_reading(args.poselift)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
