"""UCF-Crime annotations (the port's copy of ``cvsd_tpu/data/ucf_crime.py``):
the 13 anomaly categories, the ``Anomaly_Train.txt`` video list with its
category filter, the routing of a video's rows to the anomaly or the normal
CSV, and the test file's temporal annotations ('video class s1 e1 s2 e2',
-1 meaning no range)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

ANOMALY_CATEGORIES = (
    "Abuse", "Arrest", "Arson", "Assault", "Burglary", "Explosion", "Fighting",
    "RoadAccidents", "Robbery", "Shooting", "Shoplifting", "Stealing", "Vandalism",
)

DEFAULT_CATEGORY_FILTER = ("Shoplifting", "Shopping")

ANOMALY_CSV = "ucf-crime_dataset.csv"
NORMAL_CSV = "ucf-crime_dataset-normal.csv"


@dataclass
class VideoEntry:
    index: int      # 1-based position in the FULL list (the clip id): lines
    #                 the filter skips are counted too
    path: str       # 'Category/Video.mp4'
    label: str      # category
    name: str       # video filename


def read_train_list(path: str, category_filter: Optional[Sequence[str]] = DEFAULT_CATEGORY_FILTER) -> List[VideoEntry]:
    """Parse Anomaly_Train.txt; keep the global 1-based index for clip ids."""
    with open(path) as f:
        lines = f.read().split("\n")
    out: List[VideoEntry] = []
    for i, line in enumerate(lines, start=1):
        line = line.strip()
        if not line or "/" not in line:
            continue
        label, name = line.split("/", 1)
        if category_filter is not None and label not in category_filter:
            continue
        out.append(VideoEntry(index=i, path=line, label=label, name=name))
    return out


def is_anomaly_label(label: str) -> bool:
    return label in ANOMALY_CATEGORIES


def route_csv(label: str, dataset_dir: str = "dataset") -> Tuple[str, bool]:
    """(csv_path, is_anomaly) of a video of category ``label``."""
    anomaly = is_anomaly_label(label)
    return os.path.join(dataset_dir, ANOMALY_CSV if anomaly else NORMAL_CSV), anomaly


@dataclass
class TemporalAnnotation:
    name: str
    category: str
    ranges: List[Tuple[int, int]]  # frame ranges (30 fps), empty if normal

    def frame_label(self, frame: int) -> int:
        return int(any(s <= frame <= e for s, e in self.ranges))


def read_temporal_annotations(path: str) -> List[TemporalAnnotation]:
    out: List[TemporalAnnotation] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6:
                continue
            name, cat = parts[0], parts[1]
            nums = [int(x) for x in parts[2:6]]
            ranges = [(nums[i], nums[i + 1]) for i in (0, 2) if nums[i] != -1]
            out.append(TemporalAnnotation(name=name, category=cat, ranges=ranges))
    return out
