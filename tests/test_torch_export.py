"""The port's serving artifacts (``cvsd_tpu_torch/serve/export.py``,
``cli/export.py``) and the NMS operators that keep the kernel inside them
(``ops/nms.py``), on the CPU at the test size: one artifact against the
port's eager path at batch 1 and an odd batch, against the JAX package's
``jax.export`` artifact on the same weights, the scorer, the CLI, and the
operators against the plain versions. The card cases are in
``tests/test_torch_kernels_gpu.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.eval.evaluate import ShopformerScorer as ShopformerScorerJax
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.shopformer import build_shopformer as build_shopformer_jax
from cvsd_tpu.serve import export as export_jax
from cvsd_tpu_torch.cli import export as export_cli
from cvsd_tpu_torch.config import get_default_config
from cvsd_tpu_torch.eval.evaluate import ShopformerScorer, load_model
from cvsd_tpu_torch.models.detector import PersonDetector, make_detect_fn
from cvsd_tpu_torch.models.shopformer import Shopformer
from cvsd_tpu_torch.ops import nms
from cvsd_tpu_torch.serve import export
from cvsd_tpu_torch.utils.checkpoint import save_checkpoint
from cvsd_tpu_torch.utils.weights import init_module, load_flax_variables, state_dict_to_flax
from torch_testutil import random_flax_variables

S = 64
# tests/test_export.py's limits for the JAX artifact against JAX's eager path
TOL_BOX = dict(rtol=1e-5, atol=1e-4)
TOL_SCORE = dict(rtol=1e-5, atol=1e-5)
TOL_POSE_SCORE = dict(rtol=1e-5, atol=1e-6)

# (name, detector kwargs, tta_flip): slice 1's head with its pose branch, and
# slice 2's v8dfl head with flip TTA; the artifact's NMS is the fixpoint kernel
DETECTORS = [
    ("anchor_free", dict(num_keypoints=17), False),
    ("v8dfl_tta", dict(num_keypoints=0, head_variant="v8dfl"), True),
]


def _images(b, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (b, S, S, 3)).astype(np.float32)


def _jax_variables(jm, seed):
    return jax.device_get(random_flax_variables(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, S, S, 3)), train=False),
        seed))


def _port_detector(variables, **kw):
    model = PersonDetector(img_size=S, width_mult=0.25, depth_mult=0.34, dtype=torch.float32, **kw)
    return load_flax_variables(model, variables).eval()


@pytest.mark.parametrize("name,det_kw,tta_flip", DETECTORS, ids=[d[0] for d in DETECTORS])
def test_export_detector_roundtrip_equals_eager(tmp_path, name, det_kw, tta_flip):
    """One artifact, saved and loaded, runs batch 1 and batch 3 and gives the
    eager detect function's outputs bit for bit; its graph calls the op."""
    jm = PersonDetectorJax(img_size=S, width_mult=0.25, depth_mult=0.34, dtype=jnp.float32,
                           **det_kw)
    model = _port_detector(_jax_variables(jm, 1), **det_kw)
    exp = export.export_detector(model, conf_thresh=0.0, max_detections=8, tta_flip=tta_flip)
    targets = [str(n.target) for n in exp.graph.nodes if n.op == "call_function"]
    assert targets.count("cvsd_tpu_torch.nms_fixpoint.default") == 1
    path = str(tmp_path / "det.pt2")
    export.save_exported(exp, path)
    loaded = export.load_exported(path)
    assert export.exported_device(loaded) == torch.device("cpu")
    eager = make_detect_fn(model, conf_thresh=0.0, max_detections=8,
                           nms_method="pallas_fixpoint", tta_flip=tta_flip)
    for b in (1, 3):
        imgs = _images(b, b)
        got = export.call_exported(loaded, imgs)
        ref = eager(torch.from_numpy(imgs))
        assert len(got) == len(ref) == (4 if det_kw["num_keypoints"] else 3)
        assert got[0].shape == (b, 8, 4)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and torch.equal(g, r)


def test_export_detector_matches_jax_artifact():
    """The port's artifact against the JAX package's StableHLO artifact on the
    same weights: valid masks equal, boxes and scores within
    tests/test_export.py's limits."""
    jm = PersonDetectorJax(img_size=S, width_mult=0.25, depth_mult=0.34, num_keypoints=0,
                           dtype=np.float32)
    variables = _jax_variables(jm, 2)
    ref_exp = export_jax.export_detector(jm, variables, conf_thresh=0.0, max_detections=8,
                                         platforms=("cpu",))
    exp = export.export_detector(_port_detector(variables, num_keypoints=0), conf_thresh=0.0,
                                 max_detections=8)
    for b in (1, 5):
        imgs = _images(b, 10 + b)
        ref = [np.asarray(o) for o in export_jax.call_exported(ref_exp, imgs)]
        got = [o.numpy() for o in export.call_exported(exp, imgs)]
        np.testing.assert_array_equal(got[2], ref[2])
        np.testing.assert_allclose(got[0], ref[0], **TOL_BOX)
        np.testing.assert_allclose(got[1], ref[1], **TOL_SCORE)


def test_export_scorer_matches_eager_and_jax(tmp_path):
    cfg = get_default_config()
    cfg["model"]["hidden_channels"] = 8
    cfg_jax = get_default_config_jax()
    cfg_jax["model"]["hidden_channels"] = 8
    jm = build_shopformer_jax(cfg_jax)
    variables = jax.device_get(random_flax_variables(
        lambda: jm.init_variables(jax.random.PRNGKey(0)), 3))
    model = load_flax_variables(Shopformer.from_config(cfg), variables)
    scorer = ShopformerScorer(model, cfg, device="cpu")
    exp = export.export_scorer(scorer)
    path = str(tmp_path / "scorer.pt2")
    export.save_exported(exp, path)
    loaded = export.load_exported(path)
    ref_exp = export_jax.export_scorer(ShopformerScorerJax(jm, variables, cfg_jax),
                                       platforms=("cpu",))
    for b in (1, 5):
        poses = np.random.default_rng(b).normal(size=(b, 12, 18, 2)).astype(np.float32)
        got = export.call_exported(loaded, poses)
        assert got.shape == (b,)
        with torch.no_grad():
            assert torch.equal(got, scorer.model.compute_anomaly_score(torch.from_numpy(poses)))
        ref = np.asarray(export_jax.call_exported(ref_exp, poses))
        np.testing.assert_allclose(got.numpy(), ref, **TOL_POSE_SCORE)


def test_export_cli(tmp_path, capsys):
    """cli.export writes both artifacts on the CPU; each loads and runs at
    batch 1 and 3 as the checkpoint's eager model does; tpu is refused."""
    cfg = get_default_config()
    cfg["detector"].update(img_size=S, width_mult=0.25, depth_mult=0.34, dtype="float32",
                           pose_head=True)
    cfg["model"]["hidden_channels"] = 8
    det = PersonDetector(img_size=S, width_mult=0.25, depth_mult=0.34, num_keypoints=17,
                         dtype=torch.float32)
    init_module(det, 4)
    det_ckpt, sf_ckpt = str(tmp_path / "det.msgpack"), str(tmp_path / "sf.msgpack")
    save_checkpoint(det_ckpt, state_dict_to_flax(det), config={"detector": cfg["detector"]})
    sf = init_module(Shopformer.from_config(cfg), 5, xavier=True)
    save_checkpoint(sf_ckpt, state_dict_to_flax(sf), config={"model": cfg["model"]})

    det_out, sf_out = str(tmp_path / "det.pt2"), str(tmp_path / "sf.pt2")
    export_cli.main(["--detector_checkpoint", det_ckpt, "--output", det_out, "--platforms", "cpu",
                     "--conf", "0.0", "--max_detections", "6"])
    export_cli.main(["--checkpoint", sf_ckpt, "--output", sf_out, "--platforms", "cpu"])
    det_exp, sf_exp = export.load_exported(det_out), export.load_exported(sf_out)
    eager = make_detect_fn(det.eval(), conf_thresh=0.0, max_detections=6)
    scorer = load_model(sf_ckpt, device="cpu")
    for b in (1, 3):
        imgs = _images(b, 20 + b)
        for g, r in zip(export.call_exported(det_exp, imgs), eager(torch.from_numpy(imgs))):
            assert torch.equal(g, r)
        poses = np.random.default_rng(b).normal(size=(b, 12, 18, 2)).astype(np.float32)
        np.testing.assert_array_equal(export.call_exported(sf_exp, poses).numpy(),
                                      scorer.score(poses, batch_size=b))
    for bad, match in ((["tpu"], "JAX package"), (["cuda", "cpu"], "one of")):
        with pytest.raises(SystemExit):
            export_cli.main(["--checkpoint", sf_ckpt, "--output", str(tmp_path / "x.pt2"),
                             "--platforms", *bad])
        assert match in capsys.readouterr().err
    assert not (tmp_path / "x.pt2").exists()


def _nms_inputs(B=3, K=40, seed=0):
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(10, 60, (B, K, 2))
    wh = rng.uniform(5, 30, (B, K, 2))
    boxes = torch.from_numpy(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32))
    alive = torch.from_numpy((rng.uniform(size=(B, K)) > 0.2).astype(np.float32))
    return boxes, alive


@pytest.mark.parametrize("op_name", ["nms_fixpoint", "nms_seq"])
def test_nms_ops_registered_and_equal_plain_on_cpu(op_name):
    """The operators exist under torch.ops.cvsd_tpu_torch, pass PyTorch's
    operator checks (schema, fake tensor, dynamic shapes), and on CPU tensors
    equal the plain versions bit for bit; the dispatchers return what they
    returned before (bool for the fixpoint, float32 0/1 for the sequential)."""
    op = getattr(torch.ops.cvsd_tpu_torch, op_name)
    boxes, alive = _nms_inputs()
    torch.library.opcheck(op, (boxes, alive, 0.45))
    keep = op(boxes, alive, 0.45)
    assert keep.dtype == torch.bool and keep.shape == alive.shape
    if op_name == "nms_fixpoint":
        ref = nms.nms_fixpoint_torch(boxes, alive, 0.45)
        assert torch.equal(keep, ref) and torch.equal(nms.nms_fixpoint(boxes, alive, 0.45), ref)
    else:
        ref = nms.nms_seq_torch(boxes, alive, 0.45)
        assert torch.equal(keep, ref > 0.5)
        got = nms.nms_seq(boxes, alive, 0.45)
        assert got.dtype == torch.float32 and torch.equal(got, ref)
    with torch.device("meta"):
        fake = op(torch.empty(5, 7, 4), torch.empty(5, 7), 0.45)
    assert fake.shape == (5, 7) and fake.dtype == torch.bool
