"""The plain reference against the port on the CPU, in float32, at a
small size: the whole detection path of both configurations."""

import numpy as np
import pytest
import torch

from conftest import tiny
from harness import detect as D
from reference import detector as R


@pytest.mark.parametrize("cell", ["v5m-pose-detect-b128", "yolov5mu-topdown-detect-b32"])
def test_detection_path_matches_the_port_in_float32(cell):
    _, cfg, traffic = tiny(cell)
    det = dict(cfg["detector"], dtype="float32")
    st = D.build_pipeline(det, traffic, 5, "cpu")
    frames = st["pool"][1]
    got = st["pipe"].detect_frames(frames)
    ref = R.detect(R.Ctx(st["det_params"]), det, torch.from_numpy(frames),
                   R.Ctx(st["pose_params"]) if st["pose_params"] is not None else None)
    names = ["boxes", "xywhn", "scores", "valid", "kpts"]
    assert np.array_equal(got[3], ref["valid"].numpy())
    v = got[3]
    for name, g in zip(names, got):
        if name == "valid":
            continue
        r = ref[name].numpy()
        scale = max(1.0, float(np.abs(r).max()))
        assert np.abs(g[v] - r[v]).max() <= 1e-4 * scale, name
