"""The port's utility tools (``examples_torch/train_detector_hard.py``,
``eval_int8_accuracy.py``, ``sweep_extracted.py``) and the detector
trainer's seeded init against the JAX package on the CPU, at tiny sizes
(img 64, width 0.25, depth 0.34, float32, 2-step chunks) except the init
test, which builds the synthetic example's detector (img 128)."""

import importlib.util
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.data.render import rendered_scene_batch as rendered_scene_batch_jax
from cvsd_tpu.data.synthetic import SyntheticPoseLiftDataset as SyntheticPoseLiftDatasetJax
from cvsd_tpu.eval.detection import evaluate_detector as evaluate_detector_jax
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.detector import make_detect_fn as make_detect_fn_jax
from cvsd_tpu.train import detector_train as jdt
from cvsd_tpu_torch.models.detector import PersonDetector
from cvsd_tpu_torch.train.detector_train import DetectorTrainer
from cvsd_tpu_torch.utils.weights import load_flax_variables
from torch_testutil import random_flax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples_torch"))

import eval_int8_accuracy  # noqa: E402
import sweep_extracted  # noqa: E402
import train_detector_hard as hard  # noqa: E402

S = 64
SMALL = dict(img_size=S, width_mult=0.25, depth_mult=0.34)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", autouse=True)
def _float32_detector():
    """The hard-scene trainer computes in float32 here, as the JAX detector
    these tests hold it against (the tool's own is bfloat16)."""
    prev = hard.DTYPE
    hard.DTYPE = torch.float32
    yield
    hard.DTYPE = prev


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- the detector trainer's seeded init (fault 1) -------------------------------------


def test_detector_trainer_init_matches_flax_distribution(monkeypatch):
    """``DetectorTrainer(seed=0)`` of each package at the synthetic example's
    detector (img 128, width 0.25, depth 0.34, float32) builds the same
    leaves with the same shapes. Each conv kernel (n entries) is flax's
    lecun_normal in both: the two means differ by less than 4 standard
    errors of their difference, 4 * sqrt(2) * sigma / sqrt(n), the two
    standard deviations by less than 4 * sigma / sqrt(n) (twice the
    variance of a normal's sample std, 2 * sigma^2 / (2n); the truncated
    normal's is smaller), each std is within 4 * sigma / sqrt(2n) of sigma =
    1/sqrt(fan_in), and no entry passes the truncation at 2 standard
    deviations of the untruncated normal, 2 * sigma / 0.8796. BatchNorm
    scales, biases, running statistics and the head convs' biases are
    equal. The JAX trainer's ``init_variables`` runs jitted: the same
    key gives the same variables bit for bit, in half the time of flax's
    op-by-op init."""
    def jitted_init(self, rng, batch_size=1):
        dummy = jnp.zeros((batch_size, self.img_size, self.img_size, 3), self.dtype)
        return jax.jit(lambda key: self.init({"params": key}, dummy, train=False))(rng)

    monkeypatch.setattr(PersonDetectorJax, "init_variables", jitted_init)
    jm = PersonDetectorJax(img_size=128, width_mult=0.25, depth_mult=0.34, dtype=jnp.float32)
    jtr = jdt.DetectorTrainer(jm, lr=2e-3, seed=0, total_steps=2000, warmup_steps=100,
                              ema_decay=0.998)
    tr = DetectorTrainer(PersonDetector(img_size=128, width_mult=0.25, depth_mult=0.34,
                                        dtype=torch.float32),
                         lr=2e-3, seed=0, total_steps=2000, warmup_steps=100, ema_decay=0.998,
                         device="cpu")
    ref, got = _leaves(jtr.variables), _leaves(tr.variables)
    assert ref.keys() == got.keys()
    kernels = 0
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, k
        if not k.endswith("['kernel']"):
            assert np.array_equal(g, r), k
            continue
        kernels += 1
        n, fan_in = r.size, int(np.prod(r.shape[:-1]))
        sigma = 1.0 / math.sqrt(fan_in)
        assert abs(g.mean() - r.mean()) <= 4 * math.sqrt(2) * sigma / math.sqrt(n), k
        assert abs(g.std() - r.std()) <= 4 * sigma / math.sqrt(n), k
        for x in (g, r):
            assert abs(x.std() - sigma) <= 4 * sigma / math.sqrt(2 * n), (k, x.std(), sigma)
            assert np.abs(x).max() <= 2 * sigma / 0.87962566103423978 * (1 + 1e-6), k
    assert kernels > 50


# -- train_detector_hard.py ----------------------------------------------------------


def _hard_args(*extra):
    """The hard-scene script's flags at the test size."""
    return hard.parser().parse_args(
        ["--steps", "4", "--img", str(S), "--batch", "2", "--scan-chunk", "2",
         "--eval-size", "8", "--width", "0.25", "--device", "cpu",
         *extra])


def _scenes_jax(rng, n, batch, src):
    return [rendered_scene_batch_jax(rng, batch, S, 4, src) for _ in range(n)]


def test_hard_scene_streams_match_jax():
    """The scripts' scene streams are the reference's, byte for byte: the
    pose source, the training chunks from ``default_rng([seed, done])`` (a
    resumed chunk included), the held-out scenes (``seed + 1000``) and the
    calibration batches (``seed + 5000``)."""
    src = hard.scene_source()
    ref_src = SyntheticPoseLiftDatasetJax(num_samples=64, seq_len=8, anomaly_ratio=0.5,
                                          seed=7).poses.reshape(-1, 17, 2)
    assert src.tobytes() == np.asarray(ref_src).tobytes()
    for seed, done in ((0, 0), (0, 50), (3, 100)):
        got = hard.scene_chunk(seed, done, 2, 2, S, 4, src)
        ref = _scenes_jax(np.random.default_rng([seed, done]), 2, 2, src)
        for i, arr in enumerate(got):
            assert arr.tobytes() == np.stack([r[i] for r in ref]).astype(arr.dtype).tobytes()
    got = hard.held_out_scenes(2, 8, S, 4, src)
    ref = rendered_scene_batch_jax(np.random.default_rng(1002), 8, S, 4, src)
    assert all(g.tobytes() == r.tobytes() for g, r in zip(got, ref))
    got = eval_int8_accuracy.calibration_batches(2, 2, 2, S, 4, src)
    ref = _scenes_jax(np.random.default_rng(5002), 2, 2, src)
    assert all(g.tobytes() == r[0].tobytes() for g, r in zip(got, ref))


@pytest.fixture(scope="module")
def pose_detector():
    """The test-sized detector with the 17-keypoint head and seeded flax
    variables."""
    jm = PersonDetectorJax(**SMALL, num_keypoints=17, dtype=jnp.float32)
    variables = random_flax_variables(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, S, S, 3)), train=False),
        11)
    return jm, jax.tree_util.tree_map(np.asarray, variables)


def test_scan_chunk_and_evaluation_match_jax(pose_detector, monkeypatch):
    """One ``train_steps_scan`` chunk (2 steps, the script's trainer: keypoint
    weight 0.1, warm-up + cosine, EMA) from flax weights carried across: both
    losses within 1e-5 relative of the JAX trainer's (the first update's rate
    is 0, so both steps run at the carried weights; readings ~1e-7) and the
    new BatchNorm statistics within 1e-5 of each tensor's largest entry. Then
    ``evaluate_detector`` (coco_map) through ``make_detect_fn`` at the
    script's conf 0.25 / IoU 0.45 / 16 detections on 8 held-out scenes:
    the same detections counted, AP50 and mAP50-95 within 1e-6, the
    keypoint RMS within 1e-4 relative."""
    jm, variables = pose_detector
    monkeypatch.setattr(PersonDetectorJax, "init_variables",
                        lambda self, rng, batch_size=1: variables)
    args = _hard_args("--cosine", "--ema", "0.9")
    src = hard.scene_source()
    chunk = hard.scene_chunk(args.seed, 0, 2, args.batch, S, args.max_persons, src)
    jtr = jdt.DetectorTrainer(jm, lr=args.lr, kpt_weight=0.1, total_steps=args.steps,
                              warmup_steps=args.warmup_steps, ema_decay=args.ema)
    ref = np.asarray(jtr.train_steps_scan(*chunk)["losses"], np.float64)
    tr = hard.build_trainer(args, torch.device("cpu"), variables=variables)
    got = tr.train_steps_scan(*chunk)["losses"].astype(np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    ref_stats = _leaves({"s": jax.device_get(jtr.variables["batch_stats"])})
    got_stats = _leaves({"s": tr.variables["batch_stats"]})
    for k, r in ref_stats.items():
        assert np.abs(got_stats[k] - r).max() <= 1e-5 * np.abs(r).max(), k

    held = hard.held_out_scenes(args.seed, 8, S, args.max_persons, src)
    res_j = evaluate_detector_jax(make_detect_fn_jax(jm, 0.25, 0.45, 16), variables, *held,
                                  coco_map=True)
    model = load_flax_variables(PersonDetector(**SMALL, num_keypoints=17, dtype=torch.float32),
                                variables).eval()
    res_t = hard.evaluate_detector(hard.make_detect_fn(model, 0.25, 0.45, 16), *held,
                                   coco_map=True, device="cpu")
    assert int(res_t["num_pred"]) == int(res_j["num_pred"]) > 0
    assert int(res_t["num_gt"]) == int(res_j["num_gt"])
    for k in ("ap", "map50_95", "map75"):
        assert abs(float(res_t[k]) - float(res_j[k])) <= 1e-6, k
    rk, gk = res_j["keypoints"], res_t["keypoints"]
    assert gk["n"] == rk["n"]
    assert abs(gk["rms_px"] - rk["rms_px"]) <= 1e-4 * rk["rms_px"]


def _state(trainer):
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            [e.clone() for e in trainer.ema_params], trainer._ema_t, trainer.opt.count)


def test_resume_equals_uninterrupted(tmp_path):
    """2 steps, the partial files, then 2 more steps in a fresh trainer give
    4 uninterrupted steps' weights, statistics, EMA and losses bit for bit.
    The uninterrupted run renders its chunks; the interrupted one trains on
    the same chunks handed over as ``scenes``, from which ``train`` takes
    those between the resume point and ``stop_at``."""
    cpu = torch.device("cpu")
    src = hard.scene_source()
    a = _hard_args("--cosine", "--ema", "0.9", "--out", str(tmp_path / "a.json"))
    b = _hard_args("--cosine", "--ema", "0.9", "--out", str(tmp_path / "b.json"))
    ta = hard.build_trainer(a, cpu)
    la = hard.train(ta, a, src)
    scenes = list(hard.chunks(a, src, 0, a.steps))
    hard.train(hard.build_trainer(b, cpu), b, src, stop_at=2, scenes=scenes)
    mp, js = hard.partial_paths(b.out)
    with open(js) as f:
        assert json.load(f)["done"] == 2
    tb = hard.build_trainer(b, cpu)
    lb = hard.train(tb, b, src, scenes=scenes)
    assert len(la) == 4 and np.array_equal(np.float32(la), np.float32(lb))
    sa, sb = _state(ta), _state(tb)
    assert sa[0].keys() == sb[0].keys()
    assert all(torch.equal(sa[0][k], sb[0][k]) for k in sa[0])
    assert all(torch.equal(x, y) for x, y in zip(sa[1], sb[1]))
    assert sa[2:] == sb[2:] == (4, 4)
    for x, y in zip(ta.opt.inner.state.values(), tb.opt.inner.state.values()):
        assert all(torch.equal(x[k], y[k]) for k in ("exp_avg", "exp_avg_sq", "step"))


# -- eval_int8_accuracy.py -------------------------------------------------------------


def _reference_module(name):
    spec = importlib.util.spec_from_file_location(f"{name}_reference",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_int8_accuracy_rows_match_jax(pose_detector, tmp_path, monkeypatch):
    """Both scripts on one JAX-written checkpoint (the test-sized pose-head
    detector, seeded flax weights), 8 held-out scenes, 2 calibration batches
    of 2: the same JSON keys and the same detections counted. The float rows
    agree to float32 rounding: AP50, mAP50-95 and pose mAP within 1e-6, the
    keypoint RMS within 1e-4 relative. The int8 rows are held at
    ``test_torch_int8.py``'s tolerance for the jitted JAX detect function,
    whose fusions move some int8 roundings (scores within 5e-4, keypoints
    within 0.3 px, nearly tied detections swapping places): a swap moves a
    true positive by one rank among 128 detections, so AP50, mAP50-95 and
    pose mAP within 1e-4 (reading 2.6e-05 for AP50) and the keypoint RMS
    within 1e-3 relative (reading 5.8e-05)."""
    jm, variables = pose_detector
    monkeypatch.setattr(PersonDetectorJax, "init_variables",
                        lambda self, rng, batch_size=1: variables)
    ckpt = str(tmp_path / "det.msgpack")
    jdt.DetectorTrainer(jm).save(ckpt, use_ema=False)
    flags = ["--checkpoint", ckpt, "--eval-size", "8", "--calib-batches", "2",
             "--calib-batch", "2"]
    monkeypatch.setattr(sys, "argv", ["eval_int8_accuracy.py", *flags,
                                      "--out", str(tmp_path / "jax.json")])
    _reference_module("eval_int8_accuracy").main()
    with open(tmp_path / "jax.json") as f:
        ref = json.load(f)
    got = eval_int8_accuracy.main([*flags, "--out", str(tmp_path / "port.json"),
                                   "--device", "cpu"])
    with open(tmp_path / "port.json") as f:
        assert json.load(f).keys() == ref.keys() == got.keys()
    for k in ("eval_scenes", "calib_frames", "margin"):
        assert got[k] == ref[k]
    for name, ap_tol, rms_tol in (("float", 1e-6, 1e-4), ("int8", 1e-4, 1e-3)):
        g, r = got[name], ref[name]
        assert g.keys() == r.keys()
        assert g["num_pred"] == r["num_pred"] > 0
        for k in ("ap50", "map50_95", "pose_map50_95"):
            assert abs(g[k] - r[k]) <= ap_tol, (name, k, g[k], r[k])
        assert g["keypoints"]["n"] == r["keypoints"]["n"]
        assert abs(g["keypoints"]["rms_px"] - r["keypoints"]["rms_px"]) <= \
            rms_tol * r["keypoints"]["rms_px"]
    assert abs(got["ap50_delta"] - ref["ap50_delta"]) <= 1e-4 + 1e-6


# -- sweep_extracted.py ------------------------------------------------------------------


def test_sweep_configs_are_the_reference_list():
    """The swept configurations are ``examples/sweep_extracted.py``'s (loaded
    by path: it imports no jax at module level), in its order."""
    assert sweep_extracted.CONFIGS == _reference_module("sweep_extracted").CONFIGS
