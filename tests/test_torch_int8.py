"""The port's int8 detector (cvsd_tpu_torch/models/detector_int8.py,
ops/int8_conv.py, train/qat.py, cli/quantize_detector.py) against the JAX
package's on the CPU, at the JAX tests' size (img 64, width 0.25, depth
0.34), both heads, with the same seeded flax variables on both sides
(torch_testutil.random_flax_variables randomises the BatchNorm statistics
and affine, so the folding does real work)."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.cli.common import load_detector_cli as load_detector_cli_jax
from cvsd_tpu.cli.quantize_detector import main as quantize_main_jax
from cvsd_tpu.models import detector_int8 as jq
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.detector import build_detector as build_detector_jax
from cvsd_tpu.models.detector import load_detector_checkpoint as load_detector_checkpoint_jax
from cvsd_tpu.models.detector import make_detect_fn as make_detect_fn_jax
from cvsd_tpu.train.detector_train import detection_loss as detection_loss_jax
from cvsd_tpu.utils.checkpoint import save_checkpoint as save_checkpoint_jax
from cvsd_tpu_torch.cli.common import load_detector_cli
from cvsd_tpu_torch.cli.quantize_detector import main as quantize_main
from cvsd_tpu_torch.models import detector_int8 as tq
from cvsd_tpu_torch.models.detector import (PersonDetector, build_detector,
                                            load_detector_checkpoint, make_detect_fn)
from cvsd_tpu_torch.ops.int8_conv import im2col_int8, int8_conv, int8_conv_gemm, int8_conv_plain
from cvsd_tpu_torch.train.detector_train import detection_loss, synthetic_detection_batch
from cvsd_tpu_torch.train.qat import QATFineTuner
from cvsd_tpu_torch.utils.weights import load_flax_variables, state_dict_to_flax
from torch_testutil import random_flax_variables

S = 64
SMALL = dict(img_size=S, width_mult=0.25, depth_mult=0.34)
HEADS = {"anchor_free": dict(head_variant="anchor_free", num_keypoints=17, num_classes=80),
         "v8dfl": dict(head_variant="v8dfl", num_keypoints=0, num_classes=1)}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _models(head, jdtype=jnp.float32, tdtype=torch.float32, seed=1):
    jm = PersonDetectorJax(**SMALL, **HEADS[head], dtype=jdtype)
    variables = random_flax_variables(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, S, S, 3)), train=False),
        seed)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = load_flax_variables(PersonDetector(**SMALL, **HEADS[head], dtype=tdtype), variables)
    return jm, variables, tm.eval()


def _batches(n=2, b=2, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.uniform(0, 1, (b, S, S, 3)).astype(np.float32) for _ in range(n)]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(got, ref):
    got, ref = _leaves(got), _leaves(ref)
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        assert got[k].dtype == r.dtype and got[k].shape == r.shape, k
        np.testing.assert_array_equal(got[k], r, err_msg=k)


def _act_scale_gap(got, ref):
    got, ref = _leaves(got), _leaves(ref)
    scales = [k for k in ref if k.endswith("['act_scale']")]
    assert len(scales) > 10
    return max(abs(float(got[k]) - float(ref[k])) / float(ref[k]) for k in scales)


@pytest.fixture(scope="module", params=sorted(HEADS))
def calibrated(request):
    """(head, jm, variables, tm, JAX's calibrated int8 variables, the port's)."""
    jm, variables, tm = _models(request.param)
    j_vars = jq.calibrate(jq.quant_model_like(jm), jq.convert_variables(variables), _batches())
    t_vars = tq.calibrate(tq.quant_model_like(tm), tq.convert_variables(variables), _batches())
    return request.param, jm, variables, tm, jax.tree_util.tree_map(np.asarray, j_vars), t_vars


# -- the numpy conversions: bit for bit ------------------------------------------------


@pytest.mark.parametrize("head", sorted(HEADS))
def test_conversions_bit_equal(head):
    """convert_variables, _fold_to_float and finalize_qat equal the JAX
    package's bit for bit (the same numpy), int8 leaves int8; the converted
    tree has QuantPersonDetector's flax layout (its init shapes) and lands in
    the port's module and back through the weight bridge unchanged."""
    jm, variables, tm = _models(head)
    conv = tq.convert_variables(variables)
    _assert_trees_equal(conv, jax.tree_util.tree_map(np.asarray, jq.convert_variables(variables)))
    folded = tq._fold_to_float(variables)
    _assert_trees_equal(folded, jax.tree_util.tree_map(np.asarray, jq._fold_to_float(variables)))
    _assert_trees_equal(tq.finalize_qat(folded),
                        jax.tree_util.tree_map(np.asarray, jq.finalize_qat(folded)))
    shapes = jax.eval_shape(lambda: jq.quant_model_like(jm).init_variables(jax.random.PRNGKey(0)))
    assert {k: v.shape for k, v in _leaves(conv).items()} == {
        jax.tree_util.keystr(p): tuple(v.shape)
        for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    qmodel = load_flax_variables(tq.quant_model_like(tm), conv)
    _assert_trees_equal(state_dict_to_flax(qmodel), conv)
    qat = load_flax_variables(tq.qat_model_like(tm), folded)
    _assert_trees_equal(state_dict_to_flax(qat), folded)


# -- the int8 convolution: the GEMM route against the plain version ----------------------


@pytest.mark.parametrize("B,H,W,C,N,k,s", [
    (2, 64, 64, 3, 16, 6, 2),   # the stem: K = 108 padded to 112
    (2, 16, 16, 16, 16, 3, 1),  # a C3 bottleneck's 3x3
    (2, 8, 8, 64, 32, 1, 1),    # a 1x1 (no im2col copy)
    (2, 2, 2, 64, 64, 3, 1),    # a p5 map at the test size: M = 8 padded to 32
    (1, 5, 7, 5, 12, 3, 2),     # odd sizes, K = 45 and N = 12 padded
])
def test_int8_gemm_route_equals_plain(B, H, W, C, N, k, s):
    """im2col + torch._int_mm (on the CPU here) gives the float64 plain
    version's int32 accumulators exactly, padding of K, M and N included;
    the dispatcher takes the plain version for a CPU tensor."""
    g = torch.Generator().manual_seed(B * H * C + k)
    xq = torch.randint(-127, 128, (B, H, W, C), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, k * k * C), generator=g, dtype=torch.int8)
    before = int8_conv_gemm.launches
    got = int8_conv_gemm(xq, w, k, s)
    assert int8_conv_gemm.launches == before + 1
    ref = int8_conv_plain(xq, w, k, s)
    assert got.dtype == ref.dtype == torch.int32 and got.shape == ref.shape
    assert torch.equal(got, ref)
    assert torch.equal(int8_conv(xq, w, k, s), ref) and int8_conv_gemm.launches == before + 1
    cols = im2col_int8(xq, k, s)
    assert cols.shape[1] % 8 == 0 and not cols[:, k * k * C:].any()


def test_int8_conv_refuses_other_devices():
    xq = torch.zeros(1, 4, 4, 8, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        int8_conv(xq, torch.zeros(8, 8, dtype=torch.int8, device="meta"), 1, 1)


# -- calibration and the int8 forward --------------------------------------------------------


def test_calibrate_matches_jax(calibrated):
    """Every act_scale within 1e-5 relative (the observed absmax of float32
    activations that differ by summation order; readings ~6e-7)."""
    _head, _jm, _v, _tm, j_vars, t_vars = calibrated
    assert _act_scale_gap(t_vars, j_vars) <= 1e-5


def _int8_inputs_jax(qmodel, qvars, x):
    """The int8 input of every ConvBNAct in the JAX forward, by scope path."""
    got = {}

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, jq.ConvBNAct) and context.method_name == "__call__":
            got["/".join(context.module.scope.path)] = np.asarray(args[0], np.float32)
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(interceptor):
        raw = qmodel.apply(qvars, jnp.asarray(x))
    return raw, got


def _int8_inputs_port(qmodel, x):
    got, hooks = {}, []
    for name, m in qmodel.named_modules():
        if isinstance(m, tq.ConvBNAct):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args, name=name: got.__setitem__(
                    name.replace(".", "/"), args[0].to(torch.float32).numpy())))
    try:
        with torch.no_grad():
            raw = qmodel(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    return raw, got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_forward_matches_jax(calibrated, dtype):
    """The int8 forward on the same converted, calibrated variables (JAX's,
    un-jitted). float32 activations: the head maps within 2e-6 of their
    largest entry (readings up to 2.05e-07) and at most 1e-5 of the int8
    activations differing (readings 0 of ~390,000: a SiLU one ulp apart could
    move a round(x / a) across a half). bfloat16: the maps within 2e-2
    (readings up to 5.5e-03: bf16 rounds at other places in each package)."""
    head, jm, variables, tm, j_vars, _t = calibrated
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    qj = jq.QuantPersonDetector(**SMALL, **HEADS[head], dtype=jdt)
    qt = load_flax_variables(tq.QuantPersonDetector(**SMALL, **HEADS[head], dtype=tdt), j_vars)
    x = _batches(1, seed=9)[0]
    raw_j, ins_j = _int8_inputs_jax(qj, j_vars, x)
    raw_t, ins_t = _int8_inputs_port(qt.eval(), x)
    for k in raw_j:
        r = np.asarray(raw_j[k], np.float32)
        g = raw_t[k].to(torch.float32).numpy()
        assert g.shape == r.shape and raw_t[k].dtype == tdt
        gap = np.abs(g - r).max() / np.abs(r).max()
        assert gap <= (2e-6 if dtype == "float32" else 2e-2), (k, gap)
    if dtype == "float32":
        assert ins_j.keys() == ins_t.keys() and len(ins_j) > 30
        scales = _leaves(j_vars)
        differ = total = 0
        for path, xj in ins_j.items():
            a = float(scales["['params']" + "".join(f"['{p}']" for p in path.split("/"))
                             + "['act_scale']"])
            qj_ = np.clip(np.round(xj / np.float32(a)), -127, 127)
            qt_ = np.clip(np.round(ins_t[path] / np.float32(a)), -127, 127)
            differ += int((qj_ != qt_).sum())
            total += qj_.size
        assert differ <= 1e-5 * total, (differ, total)


def test_make_detect_fn_on_int8_model_matches_jax():
    """make_detect_fn (decode, top-K, NMS, keypoint gather) runs unchanged on
    the int8 model with keypoints and keeps the JAX package's sets: each
    kept box matched to one of JAX's. Image 0 agrees to float32 rounding
    (boxes 1e-4 px, scores 1e-6, keypoints 1e-4 px; readings 9.5e-07,
    0 and 3.8e-06). In image 1 some int8 activations round the other way:
    the jitted JAX function's fusions move float32 roundings across a
    round(x / a) half (its forward differs from its own un-jitted one, which
    the port meets to 2e-7). That moves the boxes by up to 5.5e-3 px, the
    scores by 7.1e-5 and the keypoints by 2.8e-2 px, and swaps the nearly
    tied slots 6 and 7 (scores 0.516179 and 0.516192; PERF.md): image
    1 is held to 5e-2 px, 5e-4 and 0.3 px, ~10x those readings."""
    jm, variables, tm = _models("anchor_free", seed=2)
    qj, qvj = jq.quantize_detector(jm, variables, _batches())
    qt, _qvt = tq.quantize_detector(tm, variables, _batches())
    load_flax_variables(qt, jax.tree_util.tree_map(np.asarray, qvj))
    x = _batches(1, b=2, seed=4)[0]
    ref = make_detect_fn_jax(qj, conf_thresh=0.0, max_detections=8)(qvj, jnp.asarray(x))
    got = make_detect_fn(qt, conf_thresh=0.0, max_detections=8)(torch.from_numpy(x))
    rb, rs, rv, rk = (np.asarray(v) for v in ref)
    gb, gs, gv, gk = (v.numpy() for v in got)
    assert gk.shape == (2, 8, 17, 3)
    np.testing.assert_array_equal(gv, rv)
    moved = 0
    for b in range(2):
        dist = np.abs(gb[b][:, None] - rb[b][None]).max(-1)  # (port slot, JAX slot)
        match = dist.argmin(1)
        assert sorted(match) == list(range(8)), match
        box_tol, score_tol, kpt_tol = (1e-4, 1e-6, 1e-4) if b == 0 else (5e-2, 5e-4, 0.3)
        assert dist.min(1).max() <= box_tol
        np.testing.assert_allclose(gs[b], rs[b][match], atol=score_tol)
        np.testing.assert_allclose(gk[b], rk[b][match], atol=kpt_tol)
        moved += int((match != np.arange(8)).sum())
    assert moved <= 2, moved


# -- QAT -------------------------------------------------------------------------------------


def _qat_pair(seed=5, nk=0):
    head = "anchor_free"
    jm = PersonDetectorJax(**SMALL, head_variant=head, num_keypoints=nk, dtype=jnp.float32)
    variables = random_flax_variables(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, S, S, 3)), train=False),
        seed)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = load_flax_variables(PersonDetector(**SMALL, head_variant=head, num_keypoints=nk,
                                            dtype=torch.float32), variables)
    return jm, variables, tm


def test_qat_step_matches_jax():
    """prepare_qat equals JAX's (the act_scales within 1e-5, the rest bit for
    bit); one QATFineTuner step against JAX's loss and jax.grad: the loss
    within 1e-6 relative and every gradient within 1e-6 of the largest
    gradient anywhere (readings 1.0e-07 and 9.5e-08), and every act_scale
    unchanged bit for bit after the step."""
    jm, variables, tm = _qat_pair()
    qj, vj = jq.prepare_qat(jm, variables, _batches())
    qt, vt = tq.prepare_qat(tm, variables, _batches())
    vj = jax.tree_util.tree_map(np.asarray, vj)
    assert _act_scale_gap(vt, vj) <= 1e-5
    lj, lt = _leaves(vj), _leaves(vt)
    assert all(np.array_equal(lt[k], lj[k]) for k in lj if not k.endswith("['act_scale']"))
    batch = synthetic_detection_batch(np.random.default_rng(0), 4, S)

    from cvsd_tpu.train.detector_train import anchor_centers as anchor_centers_jax

    centers, strides = (jnp.asarray(a) for a in anchor_centers_jax(S))

    def loss_fn(p):
        raw = qj.apply({"params": p}, jnp.asarray(batch[0]), train=True)
        return detection_loss_jax(raw, jnp.asarray(batch[1]), jnp.asarray(batch[2]), S, centers,
                                  strides, obj_pos_weight=3.0, kpt_weight=0.05)[0]

    # un-jitted: XLA's fusions under jit move float32 roundings enough to flip
    # some fake-quant round(x / a) (the jitted JAX forward is 5e-3 off its own
    # un-jitted one, which the port's meets to 8e-7)
    loss_j, grads_j = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(
        jnp.asarray, vj["params"]))
    tuner = QATFineTuner(qt, vj, lr=3e-4, device="cpu")
    m = tuner.model
    raw = m(torch.from_numpy(batch[0]))
    loss_t, _ = detection_loss(raw, *(torch.from_numpy(a) for a in batch[1:]), S,
                               tuner._centers, tuner._strides, obj_pos_weight=3.0,
                               kpt_weight=0.05)
    loss_t.backward()
    grads_t = {name: p.grad.numpy().copy() for name, p in m.named_parameters()}
    m.zero_grad(set_to_none=True)
    gj = _leaves({"params": grads_j})
    largest = max(float(np.abs(v).max()) for v in gj.values())
    worst = 0.0
    for name, g in grads_t.items():
        *mods, leaf = name.split(".")
        if leaf == "weight":  # a head conv's kernel: OIHW -> HWIO
            leaf, g = "kernel", g.transpose(2, 3, 1, 0)
        r = gj["['params']" + "".join(f"['{p}']" for p in mods + [leaf])]
        worst = max(worst, float(np.abs(g - r).max()) / largest)
    assert worst <= 1e-6, worst
    out = tuner.train_step(*batch)
    assert abs(out["loss"] - float(loss_j)) <= 1e-6 * abs(float(loss_j))
    after = _leaves(tuner.variables)
    for k in lj:
        if k.endswith("['act_scale']"):
            assert after[k] == lj[k], k


def test_qat_scan_equals_step_sequence_and_finalize():
    """train_steps_scan equals the same steps by train_step bit for bit
    (losses and weights); a pose head without gt_kpts raises; finalize_qat's
    serving forward stays within 0.02 of the fake-quant forward's largest
    output (the JAX test's limit: bf16 casts between layers)."""
    jm, variables, tm = _qat_pair(seed=6)
    qt, vt = tq.prepare_qat(tm, variables, _batches())
    rng = np.random.default_rng(1)
    steps = [synthetic_detection_batch(rng, 2, S) for _ in range(3)]
    a = QATFineTuner(tq.qat_model_like(tm), vt, lr=1e-3, device="cpu")
    seq = [a.train_step(*s)["loss"] for s in steps]
    b = QATFineTuner(tq.qat_model_like(tm), vt, lr=1e-3, device="cpu")
    scan = b.train_steps_scan(*(np.stack([s[i] for s in steps]) for i in range(3)))["losses"]
    np.testing.assert_array_equal(np.asarray(seq, np.float32), scan)
    _assert_trees_equal(a.variables, b.variables)

    serving = tq.quant_model_like(tm)
    load_flax_variables(serving, tq.finalize_qat(a.variables))
    x = torch.from_numpy(_batches(1, seed=11)[0])
    with torch.no_grad():
        fq = a.model.eval()(x)
        sv = serving(x)
    for k in fq:
        gap = float((fq[k] - sv[k]).abs().max() / fq[k].abs().max().clamp(min=1e-6))
        assert gap < 0.02, (k, gap)

    _jm, v17, tm17 = _qat_pair(seed=7, nk=17)
    q17, vq17 = tq.prepare_qat(tm17, v17, _batches(1))
    tuner = QATFineTuner(q17, vq17, device="cpu")
    imgs, gb, gv = synthetic_detection_batch(rng, 2, S)
    with pytest.raises(ValueError, match="gt_kpts"):
        tuner.train_step(imgs, gb, gv)
    with pytest.raises(ValueError, match="gt_kpts"):
        tuner.train_steps_scan(imgs[None], gb[None], gv[None])
    with pytest.raises(NotImplementedError, match="Parallel"):
        QATFineTuner(q17, vq17, device="cpu", mesh_config=object())


# -- checkpoints and the CLIs ------------------------------------------------------------------


DET_CFG = {"img_size": S, "width_mult": 0.25, "depth_mult": 0.34, "pose_head": True,
           "num_keypoints": 17, "head_variant": "anchor_free", "num_classes": 80,
           "reg_max": 16, "dtype": "float32"}


def _float_checkpoint(tmp_path, seed=8):
    jm = PersonDetectorJax(**SMALL, num_keypoints=17, dtype=jnp.float32)
    variables = random_flax_variables(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, S, S, 3)), train=False),
        seed)
    path = str(tmp_path / "det.msgpack")
    save_checkpoint_jax(path, jax.device_get(variables), config={"detector": DET_CFG})
    return path


def test_quantize_cli_both_directions(tmp_path, capsys):
    """Each package's cli.quantize_detector on one float checkpoint (synthetic
    calibration): the other package's loader reads its int8 checkpoint
    strictly, int8 leaves int8; the two files hold the same w_int8, w_scale
    and bias bit for bit and act_scales within 1e-5, with the same meta; the
    port refuses an already quantized input. --qat_steps runs the port's
    QAT and its file loads in the JAX package."""
    src = _float_checkpoint(tmp_path)
    out_j, out_t, out_q = (str(tmp_path / n) for n in ("j.msgpack", "t.msgpack", "q.msgpack"))
    args = ["--detector_checkpoint", src, "--calib_frames", "4", "--calib_batch", "2"]
    quantize_main_jax(args + ["--output", out_j])
    quantize_main(args + ["--output", out_t, "--device", "cpu"])
    qj, vj, mj = load_detector_checkpoint(out_j, device="cpu")  # the port reads JAX's
    qj_jax, vt, mt = load_detector_checkpoint_jax(out_t)  # JAX reads the port's
    assert isinstance(qj_jax, jq.QuantPersonDetector)
    assert isinstance(qj, tq.QuantPersonDetector)
    assert qj.Backbone_0.ConvBNAct_0.w_int8.dtype == torch.int8
    assert np.asarray(vt["params"]["Backbone_0"]["ConvBNAct_0"]["w_int8"]).dtype == np.int8
    lj, lt = _leaves(vj), _leaves(vt)
    assert lj.keys() == lt.keys()
    for k in lj:
        if k.endswith("['act_scale']"):
            assert abs(float(lt[k]) - float(lj[k])) <= 1e-5 * float(lj[k]), k
        else:
            assert lt[k].dtype == lj[k].dtype
            np.testing.assert_array_equal(lt[k], lj[k], err_msg=k)
    assert mt["config"] == mj["config"] and mt["config"]["detector"]["quantized"] is True
    assert (mt["calib_frames"], mt["calib_margin"], mt["source"]) == (4, 1.0, src)
    with pytest.raises(SystemExit, match="already quantized"):
        quantize_main(["--detector_checkpoint", out_t, "--output", out_q, "--device", "cpu"])
    quantize_main(args + ["--output", out_q, "--device", "cpu", "--qat_steps", "2",
                          "--qat_batch", "2"])
    assert "qat 2/2" in capsys.readouterr().out
    qm, qv, _ = load_detector_checkpoint_jax(out_q)
    raw = qm.apply(qv, jnp.asarray(_batches(1)[0]))
    assert set(raw) == {"p3", "p4", "p5"}
    assert np.asarray(qv["params"]["Backbone_0"]["ConvBNAct_0"]["w_int8"]).dtype == np.int8


def test_quantize_cli_calibrates_on_videos(tmp_path):
    """--calib_video: the frames decoded with cv2 and letterboxed on the host,
    as the JAX CLI's; the act_scales equal those of calibrating on the same
    frames through the library."""
    cv2 = pytest.importorskip("cv2")  # noqa: F841
    from cvsd_tpu.data.video import write_test_video
    from cvsd_tpu_torch.cli.quantize_detector import _letterboxed_batches

    src = _float_checkpoint(tmp_path, seed=9)
    vid = write_test_video(str(tmp_path / "calib.mp4"), num_frames=8, width=96, height=64)
    out = str(tmp_path / "v.msgpack")
    quantize_main(["--detector_checkpoint", src, "--output", out, "--calib_video", vid,
                   "--calib_frames", "6", "--calib_batch", "4", "--device", "cpu"])
    batches = _letterboxed_batches([vid], S, 4, 6)
    assert [b.shape for b in batches] == [(4, S, S, 3), (2, S, S, 3)]
    model, variables, _ = load_detector_checkpoint(src, device="cpu")
    _q, ref = tq.quantize_detector(model, variables, batches)
    _m, got, meta = load_detector_checkpoint(out, device="cpu")
    _assert_trees_equal(got, ref)
    assert meta["calib_frames"] == 6


def test_load_detector_cli_quantized_key(tmp_path):
    """A fault of the reference, repaired in the port's copy: the JAX
    package's load_detector_cli drops ``quantized`` from an int8 checkpoint's
    embedded config (its _DETECTOR_ARCH_KEYS lacks it), so its consumers
    would build a float detector; the port's keeps it. With --set
    detector.quantized=true both build int8 models, and they agree (head
    maps within 1e-3 of the largest entry, float32)."""
    from cvsd_tpu.config import get_default_config as get_default_config_jax
    from cvsd_tpu_torch.config import get_default_config

    jm, variables, _tm = _models("anchor_free", seed=10)
    qm, qv = jq.quantize_detector(jm, variables, _batches(1))
    path = str(tmp_path / "int8.msgpack")
    save_checkpoint_jax(path, jax.device_get(qv),
                        config={"detector": {**DET_CFG, "quantized": True}})
    _v, cfg_j = load_detector_cli_jax(path, get_default_config_jax())
    sd, cfg_t = load_detector_cli(path, get_default_config())
    assert not cfg_j["detector"].get("quantized")
    assert cfg_t["detector"]["quantized"] is True
    model_t = build_detector(cfg_t, device="cpu", state_dict=sd)
    assert isinstance(model_t, tq.QuantPersonDetector)
    assert model_t.Backbone_0.ConvBNAct_0.w_int8.dtype == torch.int8
    assert model_t.Backbone_0.ConvBNAct_0.w_scale.dtype == torch.float32

    over = ["detector.quantized=true"]
    vj, cfg_j = load_detector_cli_jax(path, get_default_config_jax(), over)
    sd, cfg_t = load_detector_cli(path, get_default_config(), over)
    model_j = build_detector_jax(cfg_j)
    assert isinstance(model_j, jq.QuantPersonDetector)
    model_t = build_detector(cfg_t, device="cpu", state_dict=sd)
    x = _batches(1, seed=12)[0]
    raw_j = model_j.apply(vj, jnp.asarray(x))
    with torch.no_grad():
        raw_t = model_t(torch.from_numpy(x))
    for k in raw_j:
        r = np.asarray(raw_j[k], np.float32)
        assert np.abs(raw_t[k].numpy() - r).max() <= 1e-3 * np.abs(r).max(), k


def test_build_detector_quantized_defaults():
    """detector.quantized builds a QuantPersonDetector whose scales, biases
    and head convs stay float32 under a bfloat16 config (flax's dtypes), with
    flax's initial values when no weights are given."""
    cfg = {"detector": {**DET_CFG, "dtype": "bfloat16", "quantized": True}}
    m = build_detector(cfg, device="cpu", seed=0)
    assert isinstance(m, tq.QuantPersonDetector) and m.dtype == torch.bfloat16
    c = m.Backbone_0.ConvBNAct_0
    assert c.w_int8.dtype == torch.int8 and c.w_int8.shape == (16, 6 * 6 * 3)
    assert not c.w_int8.any() and bool((c.w_scale == 1).all()) and float(c.act_scale) == 1.0
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with torch.no_grad():
        raw = m(torch.zeros(1, S, S, 3))
    assert raw["p3"].dtype == torch.bfloat16 and raw["p3"].shape == (1, 8, 8, 56)
