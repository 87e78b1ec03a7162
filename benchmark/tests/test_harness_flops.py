"""The analytic FLOP count against the port's own convolutions, counted by
forward hooks at a small size, and the published counts at 640."""

import json
import os

import pytest
import torch

import flops

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hooked_flops(det):
    from cvsd_tpu_torch.models.detector import detector_from_config

    model = detector_from_config({"detector": dict(det, dtype="float32")}).eval()
    total = [0]

    def hook(mod, inp, out):
        cout, cin_g, kh, kw = mod.weight.shape
        total[0] += 2 * cin_g * cout * kh * kw * out.shape[-2] * out.shape[-1]

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    S = int(det["img_size"])
    with torch.no_grad():
        model(torch.zeros(1, S, S, 3))
    return total[0]


@pytest.mark.parametrize("name", ["v5m-pose", "yolov5mu-topdown"])
def test_count_equals_the_ports_convolutions(name):
    det = json.load(open(os.path.join(BENCH, "configs", f"{name}.json")))["detector"]
    det = dict(det, img_size=128, width_mult=0.25, depth_mult=0.34)
    assert flops.detector_flops(det) == _hooked_flops(det)


def test_pose_net_count_equals_the_ports():
    from cvsd_tpu_torch.models.pose_topdown import TopDownPoseNet

    net = TopDownPoseNet(17, 8, 32).eval()
    total = [0]
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(lambda mod, i, o: total.__setitem__(
                0, total[0] + 2 * mod.weight[0].numel() * mod.weight.shape[0]
                * o.shape[-2] * o.shape[-1]))
    with torch.no_grad():
        net(torch.zeros(1, 32, 32, 3))
    assert flops.pose_flops({"num_keypoints": 17, "width": 8, "crop_size": 32}) == total[0]


def test_yolov5mu_at_640_is_ultralytics_count():
    det = json.load(open(os.path.join(BENCH, "configs", "yolov5mu-topdown.json")))["detector"]
    assert round(flops.detector_flops(det) / 1e9, 1) == 64.2
