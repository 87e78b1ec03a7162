"""Tabular BBox schema, CSV writer and reader (the port's copy of
``cvsd_tpu/data/bbox_schema.py``, same bytes).

One row per tracked person per frame: clip id, video name, 1-based frame,
track id (a float), normalized xywh (``left``/``top`` are the box centre),
the anomaly flag and the category. Rows are appended without a header, as
the original preprocessing's dataclass-csv writer appended them. Values are
formatted by ``csv.writer``: floats by ``repr``, bools as 'True'/'False', so
a file written here is byte-identical to the JAX package's for the same
rows. ``load_bbox_dataframe`` imports pandas inside the function: the port
does not need it anywhere else.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Iterable, List, Optional

BBOX_COLUMNS = ("clip", "name", "frame", "person", "left", "top", "width", "height", "is_anomaly", "anomaly")


@dataclass
class BBox:
    """One tracked person detection in one frame."""

    clip: int
    name: str
    frame: int
    person: float  # track id
    left: float    # normalized cx (ultralytics xywhn[0])
    top: float     # normalized cy
    width: float   # normalized w
    height: float  # normalized h
    is_anomaly: bool
    anomaly: str


def append_bboxes(path: str, rows: Iterable[BBox], write_header: bool = False) -> int:
    """Headerless append, one row per BBox; returns the rows written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = 0
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if write_header:
            w.writerow(BBOX_COLUMNS)
        for r in rows:
            w.writerow([r.clip, r.name, r.frame, r.person, r.left, r.top,
                        r.width, r.height, r.is_anomaly, r.anomaly])
            n += 1
    return n


def read_bboxes(path: str, has_header: bool = False) -> List[BBox]:
    out: List[BBox] = []
    with open(path, newline="") as f:
        reader = csv.reader(f)
        for i, row in enumerate(reader):
            if has_header and i == 0:
                continue
            if not row:
                continue
            out.append(
                BBox(
                    clip=int(row[0]), name=row[1], frame=int(row[2]), person=float(row[3]),
                    left=float(row[4]), top=float(row[5]), width=float(row[6]), height=float(row[7]),
                    is_anomaly=row[8] == "True", anomaly=row[9],
                )
            )
    return out


def load_bbox_dataframe(csv_path: str, cache_dir: Optional[str] = "./cache/"):
    """CSV -> pandas DataFrame, with a pickle cache in ``cache_dir``."""
    import pandas as pd

    if cache_dir:
        cache_path = os.path.join(cache_dir, f"{os.path.basename(csv_path)}.pkl")
        if os.path.exists(cache_path):
            return pd.read_pickle(cache_path)
    df = pd.read_csv(csv_path, names=list(BBOX_COLUMNS), header=None)
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        df.to_pickle(cache_path)
    return df
