"""Video-level score aggregators (the port's copy of ``_AGGREGATORS`` from
``cvsd_tpu/utils/metrics.py``)."""

from __future__ import annotations

import numpy as np

AGGREGATORS = {
    "max": lambda v: float(np.max(v)),
    "mean": lambda v: float(np.mean(v)),
    "percentile_95": lambda v: float(np.percentile(v, 95)),
}
