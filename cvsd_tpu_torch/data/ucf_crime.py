"""UCF-Crime temporal annotations (the port's copy of ``TemporalAnnotation``
and ``read_temporal_annotations`` from ``cvsd_tpu/data/ucf_crime.py``): the
test file's 'video class s1 e1 s2 e2' lines, -1 meaning no range. The rest of
that module belongs to the Pipeline A driver (ROADMAP.md module queue,
item 9)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


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
