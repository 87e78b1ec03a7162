"""The port's detector training (cvsd_tpu_torch/train/detector_train.py) and
the train-mode BatchNorm under it, against cvsd_tpu/train/detector_train.py
and flax on the CPU: the test-sized detector (img 64, width 0.25, depth
0.34, float32), seeded numpy inputs, and the same flax variables on both
sides (filled by torch_testutil.random_flax_variables)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvsd_tpu.models.detector import ConvBNAct as ConvBNActJax
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.detector import load_detector_checkpoint as load_detector_checkpoint_jax
from cvsd_tpu.models.pose_topdown import TopDownPoseNet as TopDownPoseNetJax
from cvsd_tpu.train import detector_train as jdt
from cvsd_tpu_torch.models.detector import ConvBNAct, PersonDetector, load_detector_checkpoint
from cvsd_tpu_torch.models.pose_topdown import TopDownPoseNet
from cvsd_tpu_torch.train.detector_train import (DetectorTrainer, anchor_centers,
                                                 assign_targets, detection_loss,
                                                 sigmoid_binary_cross_entropy,
                                                 synthetic_detection_batch)
from cvsd_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from torch_testutil import random_flax_variables

S = 64
SMALL = dict(img_size=S, width_mult=0.25, depth_mult=0.34)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_detector(num_keypoints=0, head_variant="anchor_free", seed=0):
    jm = PersonDetectorJax(**SMALL, num_keypoints=num_keypoints, head_variant=head_variant,
                           dtype=jnp.float32)
    variables = random_flax_variables(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, S, S, 3)), train=False),
        seed)
    return jm, variables


def _port_detector(num_keypoints=0, head_variant="anchor_free", dtype=torch.float32):
    return PersonDetector(**SMALL, num_keypoints=num_keypoints, head_variant=head_variant,
                          dtype=dtype)


def _rel(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).max()
                 / max(float(np.abs(np.asarray(ref, np.float64)).max()), 1e-30))


def _stats_gap(model, flax_stats):
    """max over BatchNorm statistics of |port - flax| / max|flax| per tensor."""
    gap = 0.0
    for name, buf in model.named_buffers():
        mod, leaf = name.rsplit(".", 1)
        node = flax_stats
        for part in mod.split("."):
            node = node[part]
        r = np.asarray(node["mean" if leaf == "running_mean" else "var"])
        gap = max(gap, _rel(buf.detach().numpy(), r))
    return gap


# -- the train-mode BatchNorm (a repair of the port) --------------------------------


def test_convbnact_train_mode_matches_flax():
    """One train-mode forward of ConvBNAct against flax's apply(train=True,
    mutable=["batch_stats"]): the output and the new statistics within 1e-6
    of their largest entry. nn.BatchNorm2d (momentum 0.1 the other way, an
    unbiased running variance) is 2e-2 off in the statistics."""
    x = np.random.default_rng(0).normal(0.3, 1.5, (4, 12, 10, 6)).astype(np.float32)
    jm = ConvBNActJax(16, 3, 2, dtype=jnp.float32)
    variables = random_flax_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    ref, upd = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    m = load_flax_variables(ConvBNAct(6, 16, 3, 2), variables).train()
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _rel(got.detach().numpy(), ref) <= 1e-6
    bs = upd["batch_stats"]["BatchNorm_0"]
    assert _rel(m.BatchNorm_0.running_mean.numpy(), bs["mean"]) <= 1e-6
    assert _rel(m.BatchNorm_0.running_var.numpy(), bs["var"]) <= 1e-6


def test_pose_net_train_mode_matches_flax():
    """The same for the whole TopDownPoseNet (six BatchNorms): the new
    statistics within 1e-6 of each tensor's largest entry (readings up to
    6.7e-07); the heatmap logits within 1e-5 of their largest, the limit of
    the eval-mode test (test_torch_pose_topdown.py), since seven float32
    convolutions that sum in another order read up to 6e-06 there."""
    x = np.random.default_rng(1).uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    jm = TopDownPoseNetJax(num_keypoints=17, width=8, crop_size=32)
    variables = random_flax_variables(lambda: jm.init_variables(jax.random.PRNGKey(0)), 2)
    ref, upd = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    m = load_flax_variables(TopDownPoseNet(17, 8, 32), variables).train()
    got = m(torch.from_numpy(x))
    assert _rel(got.detach().numpy(), ref) <= 1e-5
    assert _stats_gap(m, upd["batch_stats"]) <= 1e-6


def test_mixed_precision_keeps_float32_master_weights():
    """A bfloat16 detector trains over float32 parameters and statistics, as
    flax's dtype / param_dtype split: the head maps come out in bfloat16,
    every parameter and statistic stays float32 after a step, and the loss is
    the float32 model's within bfloat16 rounding (1e-2 relative)."""
    jm, variables = _jax_detector()
    batch = synthetic_detection_batch(np.random.default_rng(3), 4, S)
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        tr = DetectorTrainer(_port_detector(dtype=dtype), variables=variables, device="cpu")
        with torch.no_grad():
            raw = tr.model(torch.from_numpy(batch[0]))
        assert all(v.dtype == dtype for v in raw.values())
        losses[dtype] = tr.train_step(*batch)["loss"]
        assert all(p.dtype == torch.float32 for p in tr.model.parameters())
        assert all(b.dtype == torch.float32 for b in tr.model.buffers())
    assert abs(losses[torch.bfloat16] - losses[torch.float32]) <= 1e-2 * losses[torch.float32]


# -- assignment and losses -----------------------------------------------------------


@pytest.mark.parametrize("size", [64, 640])
def test_anchor_centers_match_jax(size):
    for got, ref in zip(anchor_centers(size), jdt.anchor_centers(size)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def _gt(seed=0, B=5, G=5, K=0):
    """Random GT with padding, a row of tied areas, a row with no valid GT and
    a row of degenerate boxes."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, S - 24, (B, G, 2))
    wh = rng.uniform(6, 40, (B, G, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.uniform(size=(B, G)) < 0.75
    boxes[1, :3] = [[10, 10, 40, 40], [12, 12, 42, 42], [8, 14, 38, 44]]  # equal areas
    valid[1, :3] = True
    valid[2] = False  # no valid GT: every anchor takes GT 0, padding included
    boxes[3, :2] = [[20, 20, 20, 30], [30, 30, 25, 25]]  # zero and negative extent
    valid[3, :2] = True
    kpts = (boxes[:, :, None, :2] + rng.uniform(0, 1, (B, G, K, 2)) * wh[:, :, None]
            ).astype(np.float32) if K else None
    return boxes, valid, kpts


def test_assign_targets_match_jax():
    """pos, gt_idx and the targets exactly, ties and empty rows included."""
    boxes, valid, _ = _gt()
    c, s = anchor_centers(S)
    ref = jax.jit(jdt.assign_targets)(jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(c),
                                      jnp.asarray(s))
    got = assign_targets(torch.from_numpy(boxes), torch.from_numpy(valid), torch.from_numpy(c),
                         torch.from_numpy(s))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    pos, _target, gt_idx = got
    assert not pos[2].any() and (gt_idx[2] == 0).all()
    assert pos[1].sum() > 0


def _raw_maps(head_variant, num_keypoints, seed=0, B=5):
    rng = np.random.default_rng(seed)
    ch = (4 * 16 + 80 if head_variant == "v8dfl" else 5) + 3 * num_keypoints
    return {name: (rng.normal(0, 1, (B, S // st, S // st, ch)) * 0.8).astype(np.float32)
            for name, st in (("p3", 8), ("p4", 16), ("p5", 32))}


@pytest.mark.parametrize("head_variant,num_keypoints",
                         [("anchor_free", 0), ("anchor_free", 5), ("v8dfl", 0)])
def test_detection_loss_matches_jax(head_variant, num_keypoints):
    """The total and each component within 1e-5 relative, the gradient with
    respect to the head maps within 1e-5 of its largest entry."""
    raw = _raw_maps(head_variant, num_keypoints)
    boxes, valid, kpts = _gt(1, K=num_keypoints)
    c, s = anchor_centers(S)
    kw = dict(num_keypoints=num_keypoints, obj_pos_weight=3.0, head_variant=head_variant)

    def f(r):
        return jdt.detection_loss(r, jnp.asarray(boxes), jnp.asarray(valid), S, jnp.asarray(c),
                                  jnp.asarray(s),
                                  gt_kpts=None if kpts is None else jnp.asarray(kpts), **kw)

    (ref, ref_aux), ref_grad = jax.jit(jax.value_and_grad(f, has_aux=True))(
        {k: jnp.asarray(v) for k, v in raw.items()})
    traw = {k: torch.from_numpy(v).requires_grad_() for k, v in raw.items()}
    got, aux = detection_loss(traw, torch.from_numpy(boxes), torch.from_numpy(valid), S,
                              torch.from_numpy(c), torch.from_numpy(s),
                              gt_kpts=None if kpts is None else torch.from_numpy(kpts), **kw)
    got.backward()
    assert set(aux) == set(ref_aux)
    assert float(ref_aux["n_pos"]) >= 10
    assert abs(float(got.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    for k in aux:
        got_k, ref_k = float(aux[k].detach()), float(ref_aux[k])
        assert abs(got_k - ref_k) <= 1e-5 * abs(ref_k), k
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in ref_grad.values())
    for k in raw:
        assert float(np.abs(traw[k].grad.numpy() - np.asarray(ref_grad[k])).max()) <= 1e-5 * gmax


def test_bce_form_and_its_gap():
    """The port takes optax's form, -z log sigmoid(x) - (1 - z) log
    sigmoid(-x); binary_cross_entropy_with_logits' form, (1 - z) x + softplus(-x),
    differs from it by rounding only (within 4 float32 ulps of the loss at
    these logits)."""
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 6, 100_000).astype(np.float32))
    z = (torch.rand(x.shape, generator=torch.Generator().manual_seed(0)) < 0.3).float()
    ref = np.asarray(jax.jit(lambda a, b: -b * jax.nn.log_sigmoid(a)
                             - (1 - b) * jax.nn.log_sigmoid(-a))(x.numpy(), z.numpy()))
    ours = sigmoid_binary_cross_entropy(x, z)
    other = F.binary_cross_entropy_with_logits(x, z, reduction="none")
    assert np.abs(ours.numpy() - ref).max() <= 4 * np.spacing(np.abs(ref)).max()
    assert float((other - ours).abs().max()) <= 4 * float(np.spacing(np.abs(ref)).max())


# -- the trainer ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def pose_pair():
    """The test-sized detector with a 5-keypoint pose head, its flax variables
    and one batch."""
    jm, variables = _jax_detector(num_keypoints=5, seed=5)
    batch = synthetic_detection_batch(np.random.default_rng(6), 6, S, num_keypoints=5)
    return jm, variables, batch


def _flat_grads(model):
    return {n: p.grad.detach().numpy().astype(np.float64) for n, p in model.named_parameters()}


def test_train_step_matches_jax(pose_pair, monkeypatch):
    """One DetectorTrainer.train_step from the same variables as the JAX
    package's trainer: the loss within 1e-5 relative (each component within
    1e-4: the keypoint loss of random weights reads 1.2e-05), the new
    BatchNorm statistics within 1e-5 of each tensor's largest entry. The
    gradients (a separate forward and backward from the same weights, against
    jax.grad) are held against the largest gradient anywhere, within 5e-4:
    flax's E[x^2] - E[x]^2 variance makes the stem's float32 gradients
    ill-conditioned. Readings: port vs JAX 1.26e-04, the port's float32 vs
    float64 4.6e-05, JAX's float32 vs the port's float64 1.25e-04; the port's
    float32 is also held within 2e-4 of its float64."""
    jm, variables, batch = pose_pair
    images, boxes, valid, kpts = batch
    # the reference trainer's own init draws weights that are replaced at once
    monkeypatch.setattr(PersonDetectorJax, "init_variables",
                        lambda self, rng, batch_size=1: variables)
    jtr = jdt.DetectorTrainer(jm)
    ref = jtr.train_step(images, boxes, valid, kpts)
    c, s = jdt.anchor_centers(S)

    def loss_fn(p):
        out, _ = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                          jnp.asarray(images), train=True, mutable=["batch_stats"])
        return jdt.detection_loss(out, jnp.asarray(boxes), jnp.asarray(valid), S,
                                  jnp.asarray(c), jnp.asarray(s), gt_kpts=jnp.asarray(kpts),
                                  num_keypoints=5, obj_pos_weight=3.0, kpt_weight=0.05)[0]

    ref_grads = jax.jit(jax.grad(loss_fn))(variables["params"])

    tr = DetectorTrainer(_port_detector(num_keypoints=5), variables=variables, device="cpu")
    probe = copy.deepcopy(tr.model)
    got = tr.train_step(images, boxes, valid, kpts)
    assert set(got) == set(ref)
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]), (k, got[k], ref[k])
    assert _stats_gap(tr.model, jtr.variables["batch_stats"]) <= 1e-5

    grads = {}
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(probe).to(dtype)
        detection_loss(m(torch.from_numpy(images).to(dtype)), torch.from_numpy(boxes).to(dtype),
                       torch.from_numpy(valid), S, torch.from_numpy(c).to(dtype),
                       torch.from_numpy(s).to(dtype), gt_kpts=torch.from_numpy(kpts).to(dtype),
                       num_keypoints=5, obj_pos_weight=3.0, kpt_weight=0.05)[0].backward()
        grads[dtype] = _flat_grads(m)
    ref_sd = flax_to_state_dict({"params": jax.device_get(ref_grads),
                                 "batch_stats": variables["batch_stats"]}, probe)
    g32, g64 = grads[torch.float32], grads[torch.float64]
    gmax = max(float(np.abs(g).max()) for g in g64.values())
    gap = max(float(np.abs(g - ref_sd[n].numpy()).max()) for n, g in g32.items())
    own = max(float(np.abs(g - g64[n]).max()) for n, g in g32.items())
    assert gap <= 5e-4 * gmax, gap / gmax
    assert own <= 2e-4 * gmax, own / gmax


def test_train_steps_scan_equals_train_steps(pose_pair):
    """Three steps through train_steps_scan (one host-to-device copy) and
    three train_step calls give the same weights, statistics, EMA and losses,
    bit for bit, under the warmup-cosine schedule and EMA."""
    _jm, variables, _batch = pose_pair
    rng = np.random.default_rng(7)
    steps = [synthetic_detection_batch(rng, 4, S, num_keypoints=5) for _ in range(3)]
    kw = dict(lr=2e-3, total_steps=10, warmup_steps=2, ema_decay=0.9, variables=variables,
              device="cpu")
    a = DetectorTrainer(_port_detector(num_keypoints=5), **kw)
    b = DetectorTrainer(_port_detector(num_keypoints=5), **kw)
    la = [a.train_step(*st)["loss"] for st in steps]
    lb = b.train_steps_scan(*(np.stack([st[i] for st in steps]) for i in range(4)))["losses"]
    assert np.array_equal(np.float32(la), lb)
    for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values()):
        assert torch.equal(x, y)
    for x, y in zip(a.ema_params, b.ema_params):
        assert torch.equal(x, y)
    assert a._ema_t == b._ema_t == 3
    assert a.opt.count == 3 and a.opt.lr > 0


def test_schedule_starts_at_zero(pose_pair):
    """optax counts from 0: with total_steps set, the first update's rate is 0
    and the weights do not move (the statistics do)."""
    _jm, variables, batch = pose_pair
    tr = DetectorTrainer(_port_detector(num_keypoints=5), total_steps=20, variables=variables,
                         device="cpu")
    before = [p.detach().clone() for p in tr.model.parameters()]
    tr.train_step(*batch)
    assert tr.opt.lr == 0.0
    assert all(torch.equal(x, p) for x, p in zip(before, tr.model.parameters()))


def test_ema_matches_numpy_reference():
    """The EMA equals the ramped-decay recursion min(d, (1+t)/(10+t)) computed
    in numpy from the per-step parameter trajectory, within 1e-6."""
    decay = 0.9
    _jm, variables = _jax_detector(seed=8)
    tr = DetectorTrainer(_port_detector(), lr=3e-3, ema_decay=decay, variables=variables,
                         device="cpu")
    expected = [p.detach().numpy().astype(np.float64) for p in tr.model.parameters()]
    for t in range(4):
        tr.train_step(*synthetic_detection_batch(np.random.default_rng(t), 4, S))
        d = min(np.float32(decay), (np.float32(1.0) + np.float32(t)) / (np.float32(10.0) + t))
        leaves = [p.detach().numpy().astype(np.float64) for p in tr.model.parameters()]
        expected = [e * d + p * (1 - d) for e, p in zip(expected, leaves)]
    for e, a in zip(expected, tr.ema_params):
        np.testing.assert_allclose(a.numpy(), e, rtol=0, atol=1e-6)
    ema = tr.ema_variables
    raw = tr.variables
    assert jax.tree_util.tree_structure(ema) == jax.tree_util.tree_structure(raw)
    # the EMA variables carry the raw BatchNorm statistics
    for a, b in zip(jax.tree_util.tree_leaves(ema["batch_stats"]),
                    jax.tree_util.tree_leaves(raw["batch_stats"])):
        assert np.array_equal(a, b)


def test_checkpoints_byte_identical_and_loaded_both_ways(tmp_path, monkeypatch):
    """DetectorTrainer.save from equal variables writes the JAX package's bytes
    (EMA on and off), and each package's load_detector_checkpoint reads the
    other's file bit for bit."""
    jm, variables = _jax_detector(num_keypoints=5, seed=9)
    # the reference trainer's own init draws weights that are replaced at once
    monkeypatch.setattr(PersonDetectorJax, "init_variables",
                        lambda self, rng, batch_size=1: variables)
    jtr = jdt.DetectorTrainer(jm, ema_decay=0.5)
    tr = DetectorTrainer(_port_detector(num_keypoints=5), ema_decay=0.5, variables=variables,
                         device="cpu")
    for use_ema in (True, False):
        jp, tp = tmp_path / f"jax_{use_ema}.msgpack", tmp_path / f"port_{use_ema}.msgpack"
        jtr.save(str(jp), config={"experiment": {"name": "x"}}, use_ema=use_ema, step=3, ap50=0.5)
        tr.save(str(tp), config={"experiment": {"name": "x"}}, use_ema=use_ema, step=3, ap50=0.5)
        assert jp.read_bytes() == tp.read_bytes()
    model, loaded, meta = load_detector_checkpoint(str(jp), device="cpu")
    assert meta["config"]["detector"]["dtype"] == "float32" and not model.training
    assert model.num_keypoints == 5 and model.img_size == S
    want = flax_to_state_dict(variables, model)
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    _jmodel, jvars, jmeta = load_detector_checkpoint_jax(str(tp))
    assert jmeta == meta
    for a, b in zip(jax.tree_util.tree_leaves(jvars), jax.tree_util.tree_leaves(variables)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_mesh_config_is_refused():
    with pytest.raises(NotImplementedError, match="Parallel"):
        DetectorTrainer(_port_detector(), mesh_config=object(), device="cpu")
