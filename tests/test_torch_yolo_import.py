"""The port's yolov5*u importer (``cvsd_tpu_torch/utils/yolo_import.py``,
``cli/import_yolo.py``) against the JAX package's on the CPU, at the test
size (width 0.25, depth 0.34, img 64, float32): the key maps, the
synthesized state dicts, the imported trees, the guards, the head maps and
decoded boxes (also against the independent torch mirror of
``tests/test_yolo_import.py``), both CLIs' files, and the v5m-scale key map.

The JAX detector's own init (un-jitted flax, ~35 s at img 64) is replaced by
the shapes of that init (``jax.eval_shape``) filled from a seeded numpy
generator: the importer and ``synthesize_state_dict`` read only its shapes,
and the checkpoint replaces every value but the keypoint branch's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.cli import import_yolo as import_yolo_jax
from cvsd_tpu.cli.common import load_detector_cli as load_detector_cli_jax
from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.detector import decode_predictions_v8 as decode_v8_jax
from cvsd_tpu.utils import yolo_import as yolo_jax
from cvsd_tpu.utils.checkpoint import load_checkpoint as load_checkpoint_jax
from cvsd_tpu_torch.cli import import_yolo
from cvsd_tpu_torch.cli.common import load_detector_cli
from cvsd_tpu_torch.config import get_default_config
from cvsd_tpu_torch.models.detector import (PersonDetector, build_detector,
                                            decode_predictions_v8, make_detect_fn)
from cvsd_tpu_torch.utils import yolo_import
from cvsd_tpu_torch.utils.checkpoint import load_checkpoint
from cvsd_tpu_torch.utils.weights import load_flax_variables
from test_yolo_import import TYoloV5u
from torch_testutil import random_flax_variables

W_MULT, D_MULT, S = 0.25, 0.34, 64
# float32 on the CPU, the same weights: the port against JAX and against the
# torch mirror differ only in summation order (readings ~1e-6 of the largest
# map value); the JAX package's own mirror test allows 2e-4
TOL_MAP = 2e-5  # max |a - b| / max |b| on the head maps
TOL_BOX_PX = 1e-3  # decoded xyxy, px of the 64 canvas
TOL_SCORE = 1e-6

_JAX_INIT = PersonDetectorJax.init_variables


def _shaped_init(self, rng, batch_size=1):
    """flax's init shapes (jax.eval_shape) with seeded values."""
    return random_flax_variables(lambda: _JAX_INIT(self, rng, batch_size), 7)


@pytest.fixture(autouse=True)
def _fast_jax_init(monkeypatch):
    monkeypatch.setattr(PersonDetectorJax, "init_variables", _shaped_init)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _port_model(num_keypoints=0, reg_max=16):
    return PersonDetector(img_size=S, width_mult=W_MULT, depth_mult=D_MULT,
                          head_variant="v8dfl", num_keypoints=num_keypoints, reg_max=reg_max,
                          dtype=torch.float32)


def _jax_model(num_keypoints=0, reg_max=16):
    return PersonDetectorJax(img_size=S, width_mult=W_MULT, depth_mult=D_MULT,
                             head_variant="v8dfl", num_keypoints=num_keypoints, reg_max=reg_max,
                             dtype=jnp.float32)


@pytest.fixture(scope="module")
def state_dict():
    return yolo_import.synthesize_state_dict(depth_mult=D_MULT, width_mult=W_MULT, seed=1)


@pytest.mark.parametrize("depth_mult", [0.33, 0.67])
def test_build_key_map_matches_jax(depth_mult):
    rows = yolo_import.build_key_map(depth_mult)
    assert rows == yolo_jax.build_key_map(depth_mult)
    if depth_mult == 0.67:  # v5m: C3 depths 2, 4, 6, 2 in the backbone
        for c3, n in (("model.2", 2), ("model.4", 4), ("model.6", 6), ("model.8", 2)):
            assert {k.split(".")[3] for k, *_ in rows if k.startswith(c3 + ".m.")} == {
                str(i) for i in range(n)}


@pytest.mark.parametrize("reg_max", [16, 8])
def test_synthesize_state_dict_matches_jax(reg_max):
    ref = yolo_jax.synthesize_state_dict(depth_mult=D_MULT, width_mult=W_MULT, reg_max=reg_max,
                                         seed=3)
    got = yolo_import.synthesize_state_dict(depth_mult=D_MULT, width_mult=W_MULT,
                                            reg_max=reg_max, seed=3)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_imported_tree_matches_jax(state_dict):
    got = yolo_import.import_yolov5u(state_dict, model=_port_model())
    ref = yolo_jax.import_yolov5u(state_dict, model=_jax_model())
    flat_got, flat_ref = _flat(got), _flat(jax.device_get(ref))
    assert flat_got.keys() == flat_ref.keys()
    for k in flat_ref:
        np.testing.assert_array_equal(flat_got[k], flat_ref[k], err_msg="/".join(k))
    # and the tree fills the port module strictly
    load_flax_variables(_port_model(), got)


def _broken(sd, case):
    sd = dict(sd)
    if case == "shape":
        sd["model.0.conv.weight"] = sd["model.0.conv.weight"][:, :1]
    elif case == "missing":
        del sd["model.9.cv1.conv.weight"]
    elif case == "dfl":
        sd["model.24.dfl.conv.weight"] = sd["model.24.dfl.conv.weight"][:, ::-1].copy()
    return sd


@pytest.mark.parametrize("case,exc,match", [
    ("shape", ValueError, "shape mismatch for model.0.conv.weight"),
    ("missing", KeyError, "missing 1 keys"),
    ("dfl", ValueError, "DFL conv weight is not arange"),
])
def test_import_guards_match_jax(state_dict, case, exc, match):
    sd = _broken(state_dict, case)
    with pytest.raises(exc, match=match) as got:
        yolo_import.import_yolov5u(sd, model=_port_model())
    with pytest.raises(exc, match=match) as ref:
        yolo_jax.import_yolov5u(sd, model=_jax_model())
    assert str(got.value) == str(ref.value)


def test_import_non_strict_and_nested_prefix(state_dict):
    """``strict=False`` keeps a missing leaf's initial value; the
    ``model.model.`` prefix of a nested DetectionModel is stripped."""
    model = _port_model()
    init = yolo_import.initial_variables(model, 0)
    sd = _broken(state_dict, "missing")
    got = yolo_import.import_yolov5u(sd, model=model, variables=init, strict=False)
    path = ("Backbone_0", "SPPF_0", "ConvBNAct_0", "Conv_0", "kernel")
    np.testing.assert_array_equal(yolo_import._get(got["params"], path),
                                  yolo_import._get(init["params"], path))
    ref = yolo_jax.import_yolov5u(sd, model=_jax_model(), variables=init, strict=False)
    for k, v in _flat(jax.device_get(ref)).items():
        np.testing.assert_array_equal(_flat(got)[k], v)
    nested = {"model." + k: v for k, v in state_dict.items()}
    a = _flat(yolo_import.import_yolov5u(nested, model=model))
    b = _flat(yolo_import.import_yolov5u(state_dict, model=model))
    assert all(np.array_equal(a[k], b[k]) for k in b)


def test_imported_forward_matches_jax_and_torch_mirror(state_dict):
    """Head maps and the decoded boxes of the imported port detector against
    the JAX import's and the independent torch mirror's (float32, eval)."""
    tree = yolo_import.import_yolov5u(state_dict, model=_port_model())
    model = load_flax_variables(_port_model(), tree).eval()
    jm = _jax_model()
    jvars = yolo_jax.import_yolov5u(state_dict, model=jm)
    mirror = TYoloV5u(W_MULT, D_MULT)
    missing, unexpected = mirror.load_state_dict(
        {k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=False)
    assert not missing and not unexpected
    mirror.eval()

    img = np.random.default_rng(7).uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    with torch.no_grad():
        raw = model(torch.from_numpy(img))
        raw_mirror = mirror(torch.from_numpy(img).permute(0, 3, 1, 2))
    raw_jax = jm.apply(jvars, jnp.asarray(img), train=False)
    for lvl, name in enumerate(("p3", "p4", "p5")):
        got = raw[name].numpy()
        for ref in (np.asarray(raw_jax[name]), raw_mirror[lvl].permute(0, 2, 3, 1).numpy()):
            assert got.shape == ref.shape
            assert np.abs(got - ref).max() / np.abs(ref).max() < TOL_MAP, name
    boxes, scores, _ = decode_predictions_v8(raw, 80, 16)
    jboxes, jscores, _ = decode_v8_jax(raw_jax, num_classes=80, reg_max=16)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=0, atol=TOL_BOX_PX)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=0, atol=TOL_SCORE)


def _save_pt(state_dict, path, wrap):
    tensors = {k: torch.from_numpy(v) for k, v in state_dict.items()}
    torch.save({"model": tensors} if wrap else tensors, path)


def _run_both(tmp_path, pt, extra=()):
    flags = ["--torch_checkpoint", str(pt), "--img_size", str(S), "--width_mult", str(W_MULT),
             "--depth_mult", str(D_MULT), *extra]
    jax_out, port_out = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    import_yolo_jax.main(flags + ["--output", str(jax_out)])
    import_yolo.main(flags + ["--output", str(port_out)])
    return jax_out, port_out


@pytest.mark.parametrize("wrap", [False, True])
def test_cli_without_pose_head_is_byte_identical(state_dict, tmp_path, wrap):
    pt = tmp_path / "yolov5u.pt"
    _save_pt(state_dict, pt, wrap)
    jax_out, port_out = _run_both(tmp_path, pt)
    assert port_out.read_bytes() == jax_out.read_bytes()
    state, meta = load_checkpoint(str(port_out))
    assert meta["source"] == str(pt)
    assert meta["config"]["detector"]["head_variant"] == "v8dfl"
    # every leaf is the file's tensor, OIHW -> HWIO
    flat = _flat(state)
    for torch_key, kind, fpath, coll in yolo_import.build_key_map(D_MULT):
        w = state_dict[torch_key]
        np.testing.assert_array_equal(
            flat[(coll,) + fpath], w.transpose(2, 3, 1, 0) if kind == "conv_kernel" else w)


def test_cli_pose_head_keeps_mapped_leaves(state_dict, tmp_path):
    """With --pose_head the keypoint branch comes from each package's own
    init: the mapped leaves are equal bit for bit, the keypoint leaves by
    path, shape and dtype."""
    pt = tmp_path / "yolov5u.pt"
    _save_pt(state_dict, pt, False)
    jax_out, port_out = _run_both(tmp_path, pt, ["--pose_head"])
    got, meta = load_checkpoint(str(port_out))
    ref, meta_ref = load_checkpoint_jax(str(jax_out))
    assert meta == meta_ref and meta["config"]["detector"]["num_keypoints"] == 17
    flat_got, flat_ref = _flat(got), _flat(ref)
    assert flat_got.keys() == flat_ref.keys()
    mapped = {(coll,) + fpath for _k, _kind, fpath, coll in yolo_import.build_key_map(D_MULT)}
    assert any(k not in mapped for k in flat_ref)  # the keypoint branch
    for k, v in flat_ref.items():
        assert flat_got[k].shape == v.shape and flat_got[k].dtype == v.dtype, k
        if k in mapped:
            np.testing.assert_array_equal(flat_got[k], v, err_msg="/".join(k))
    # the file loads strictly into the pose-head detector
    load_flax_variables(_port_model(num_keypoints=17), got)


def test_load_detector_cli_merges_embedded_arch(state_dict, tmp_path):
    """A session at the defaults rebuilds the imported v8dfl architecture
    from the file, as the JAX package's loader does; --set detector.* still
    wins; the detector it builds detects."""
    pt = tmp_path / "yolov5u.pt"
    _save_pt(state_dict, pt, True)
    _jax_out, port_out = _run_both(tmp_path, pt)
    overrides = ["detector.dtype=float32", "training.lr=0.1"]
    sd, cfg = load_detector_cli(str(port_out), get_default_config(), overrides)
    _vars, cfg_jax = load_detector_cli_jax(str(port_out), get_default_config_jax(), overrides)
    keys = ("head_variant", "img_size", "width_mult", "depth_mult", "reg_max", "num_classes",
            "pose_head", "dtype")
    assert {k: cfg["detector"][k] for k in keys} == {k: cfg_jax["detector"][k] for k in keys}
    assert cfg["detector"]["head_variant"] == "v8dfl" and cfg["detector"]["dtype"] == "float32"
    model = build_detector(cfg, device="cpu", state_dict=sd)
    imgs = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, S, S, 3)).astype(np.float32))
    boxes, scores, valid = make_detect_fn(model, conf_thresh=0.0, max_detections=4)(imgs)
    assert boxes.shape == (2, 4, 4) and torch.isfinite(scores).all() and valid.all()


def test_v5m_key_map_shapes():
    """At the yolov5mu scale point (width 0.75, depth 0.67) every key of a
    real-layout state dict maps onto the port detector with matching shapes
    (channel rounding, C3 depths, DFL head widths), and the key set and
    shapes are those of the torch mirror's state dict. numpy only."""
    sd = yolo_import.synthesize_state_dict(depth_mult=0.67, width_mult=0.75, seed=11)
    mirror = {k: tuple(v.shape) for k, v in TYoloV5u(0.75, 0.67).state_dict().items()
              if not k.endswith("num_batches_tracked")}
    assert {k: v.shape for k, v in sd.items()} == mirror
    with torch.device("meta"):
        model = PersonDetector(head_variant="v8dfl")  # v5m at 640
    tree = yolo_import.import_yolov5u(sd, model=model)  # raises on any mismatch
    mapped = {k for k, *_ in yolo_import.build_key_map(0.67)}
    assert not set(sd) - mapped - {"model.24.dfl.conv.weight"}
    assert sum(v.size for k, v in _flat(tree).items() if k[0] == "params") == sum(
        int(np.prod(s)) for k, s in mirror.items()
        if not k.endswith(("running_mean", "running_var")) and "dfl" not in k)


def test_load_torch_checkpoint_forms_and_unsafe_guard(state_dict, tmp_path):
    tensors = {k: torch.from_numpy(v) for k, v in state_dict.items()}
    for name, obj in (("plain", tensors), ("wrapped", {"model": tensors})):
        p = str(tmp_path / f"{name}.pt")
        torch.save(obj, p)
        got = yolo_import.load_torch_checkpoint(p)
        assert got.keys() == tensors.keys()
        assert all(torch.equal(got[k], tensors[k]) for k in tensors)
    # a pickled module: refused without the opt-in, with the JAX message
    p = str(tmp_path / "module.pt")
    torch.save(torch.nn.Sequential(torch.nn.Linear(2, 3)), p)
    with pytest.raises(ValueError, match="weights_only") as got:
        yolo_import.load_torch_checkpoint(p)
    with pytest.raises(ValueError, match="weights_only") as ref:
        yolo_jax.load_torch_checkpoint(p)
    assert str(got.value) == str(ref.value)
    with pytest.warns(RuntimeWarning, match="EXECUTES code"):
        sd = yolo_import.load_torch_checkpoint(p, allow_unsafe_load=True)
    assert set(sd) == {"0.weight", "0.bias"}
