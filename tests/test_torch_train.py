"""The port's Shopformer training against the JAX package's on the CPU: the
GCAE decoder and train mode, both stage losses and their gradients, dropout,
the optimizer pieces against optax step by step, trainer steps and a short
fit against JAX's trainer from the same initial weights, and checkpoints
both ways. Small sizes: hidden 16, 64 synthetic windows, batch 16."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.eval.evaluate import load_model as load_model_jax
from cvsd_tpu.models.gcae import GCAE as GCAEJax
from cvsd_tpu.models.gcae import GCAEDecoder as GCAEDecoderJax
from cvsd_tpu.models.shopformer import Shopformer as ShopformerJax
from cvsd_tpu.models.shopformer import count_parameters as count_parameters_jax
from cvsd_tpu.train import optim as optim_jax
from cvsd_tpu.train.loop import Trainer as TrainerJax
from cvsd_tpu.utils.checkpoint import save_checkpoint as save_checkpoint_jax
from cvsd_tpu_torch.eval.evaluate import load_model
from cvsd_tpu_torch.models.gcae import GCAE, GCAEDecoder
from cvsd_tpu_torch.models.layers import DropoutRNG, FlaxBatchNorm, dropout
from cvsd_tpu_torch.models.shopformer import Shopformer, count_parameters
from cvsd_tpu_torch.models.transformer import MultiHeadDotProductAttention
from cvsd_tpu_torch.train import optim
from cvsd_tpu_torch.train.loop import Trainer, train_from_config
from cvsd_tpu_torch.utils.weights import load_flax_variables, state_dict_to_flax
from torch_testutil import cuda_mesh_config, random_flax_variables


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tiny_config(ckpt_dir, **overrides):
    """The JAX tests' tiny configuration (hidden 16, 64 + 64 synthetic
    windows, batch 16, 2 + 2 epochs), augmentation and dropout off unless
    overridden."""
    cfg = get_default_config_jax()
    cfg["data"]["dataset"] = "synthetic"
    cfg["data"]["synthetic"].update(num_train=64, num_test=64)
    cfg["data"]["batch_size"] = 16
    cfg["data"]["augment"]["enabled"] = False
    cfg["model"]["hidden_channels"] = 16
    cfg["model"]["dropout"] = 0.0
    cfg["training"].update(stage1_epochs=2, stage2_epochs=2, lr=1e-3)
    cfg["experiment"]["checkpoint_dir"] = str(ckpt_dir)
    for k, v in overrides.items():
        node = cfg
        keys = k.split(".")
        for kk in keys[:-1]:
            node = node[kk]
        node[keys[-1]] = v
    return copy.deepcopy(dict(cfg))


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def grads_as_flax(model):
    """The model's gradients in the flax layout (the bridge applied to a copy
    whose parameters hold the gradients); a missing gradient is zero."""
    twin = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(twin.parameters(), model.parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    return state_dict_to_flax(twin)["params"]


def assert_grads_close(got, ref, rtol):
    """Each gradient tensor within ``rtol`` of its largest JAX entry. A
    tensor whose gradient is zero up to rounding in JAX (under 1e-6 of the
    largest gradient anywhere: the key biases of attention, whose softmax
    ignores them, and the biases in front of a train-mode BatchNorm) must be
    as small in the port."""
    got, ref = leaves(got), leaves(ref)
    assert set(got) == set(ref)
    scale = max(float(np.abs(v).max()) for v in ref.values())
    for k, r in ref.items():
        g = got[k]
        rmax = float(np.abs(r).max())
        if rmax < 1e-6 * scale:
            assert float(np.abs(g).max()) < 1e-5 * scale, k
        else:
            assert float(np.abs(g - r).max()) <= rtol * rmax, (k, float(np.abs(g - r).max()), rmax)


# ---------------------------------------------------------------- the GCAE


@pytest.mark.parametrize("seq_len,num_tokens", [(12, 2), (8, 2)], ids=["T12_resize", "T8_exact"])
def test_decoder_matches_jax(seq_len, num_tokens):
    """GCAEDecoder at T 12 / 2 tokens (2 -> 16, then the antialiased 16 -> 12
    resize) and at T 8 / 2 tokens (2 -> 8, no resize), in eval mode, within
    1e-5 of the largest output (float32, another summation order)."""
    dj = GCAEDecoderJax(hidden_channels=16, seq_len=seq_len, num_tokens=num_tokens)
    tokens = np.random.default_rng(0).normal(size=(5, num_tokens, 144)).astype(np.float32)
    v = random_flax_variables(lambda: dj.init(jax.random.PRNGKey(0), jnp.zeros((5, num_tokens, 144))),
                              1)
    ref = np.asarray(dj.apply(v, tokens))
    dt = GCAEDecoder(hidden_channels=16, seq_len=seq_len, num_tokens=num_tokens)
    load_flax_variables(dt, v)
    got = dt.eval()(torch.from_numpy(tokens)).detach().numpy()
    assert got.shape == ref.shape == (5, seq_len, 18, 2)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # the bridge undoes the kernel flip: port -> flax gives the same bits back
    for k, x in leaves(state_dict_to_flax(dt)).items():
        np.testing.assert_array_equal(x, leaves(v)[k])


def test_conv_transpose_impulse_is_flax_unflipped():
    """flax's ConvTranspose does not flip its kernel: an impulse at t=0
    through k (4, 1), s 2, "SAME" gives [k2, k1, k0, 0]; the port's layer
    with the bridged (flipped) weight gives the same."""
    import flax.linen as fnn

    layer = fnn.ConvTranspose(1, kernel_size=(4, 1), strides=(2, 1), padding="SAME", use_bias=False)
    k = np.array([1.0, 2.0, 3.0, 4.0], np.float32).reshape(4, 1, 1, 1)
    x = np.zeros((1, 2, 1, 1), np.float32)
    x[0, 0] = 1.0
    ref = np.asarray(layer.apply({"params": {"kernel": k}}, x)).ravel()
    np.testing.assert_array_equal(ref, [3.0, 2.0, 1.0, 0.0])
    dec = GCAEDecoder(in_channels=1, hidden_channels=1, latent_channels=1, num_keypoints=1,
                      seq_len=4, num_tokens=2)
    conv = dec.ConvTranspose_0
    conv.bias.data.zero_()
    variables = state_dict_to_flax(dec)
    variables["params"]["ConvTranspose_0"]["kernel"] = k
    load_flax_variables(dec, variables)
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().numpy().ravel()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("variant", ["v2", "v1"])
def test_gcae_train_forward_matches_flax(variant):
    """The GCAE in train mode (dropout 0): the reconstruction and tokens
    within 1e-5 of their largest entries, and every updated BatchNorm
    statistic within 1e-5 absolute (statistics are O(1)), against flax with
    mutable=["batch_stats"]."""
    gj = GCAEJax(hidden_channels=16)
    poses = np.random.default_rng(1).normal(size=(6, 12, 18, 2)).astype(np.float32)
    v = random_flax_variables(lambda: gj.init(jax.random.PRNGKey(0), jnp.zeros((2, 12, 18, 2))),
                              2 if variant == "v2" else 3)
    (recon, tokens), upd = gj.apply(v, poses, train=True, mutable=["batch_stats"])
    g = GCAE(hidden_channels=16)
    load_flax_variables(g, v)
    r2, t2 = g.train()(torch.from_numpy(poses))
    assert np.abs(r2.detach().numpy() - np.asarray(recon)).max() <= 1e-5 * np.abs(recon).max()
    assert np.abs(t2.detach().numpy() - np.asarray(tokens)).max() <= 1e-5 * np.abs(tokens).max()
    new, ref = leaves(state_dict_to_flax(g)["batch_stats"]), leaves(host(upd["batch_stats"]))
    assert set(new) == set(ref)
    for k in ref:
        np.testing.assert_allclose(new[k], ref[k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("shape,feature_dims,axis", [
    ((8, 5, 7), (1,), 1), ((4, 6, 18, 2), (2, 3), (-2, -1))], ids=["BCT", "BTVC"])
def test_flax_batchnorm_matches_flax(shape, feature_dims, axis):
    """FlaxBatchNorm against flax nn.BatchNorm(momentum 0.9) over the same
    feature axes: the train-mode output and both running statistics after
    one step (the biased variance), then eval mode; within 2e-6 (float32)."""
    import flax.linen as fnn

    x = (np.random.default_rng(2).normal(size=shape) * 3 + 1).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, axis=axis)
    v = bn.init(jax.random.PRNGKey(0), x)
    y_j, upd = bn.apply(v, x, mutable=["batch_stats"])
    m = FlaxBatchNorm(tuple(shape[d] for d in feature_dims), feature_dims).train()
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(), np.asarray(y_j), atol=2e-6)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(m, name).numpy(),
                                   np.asarray(upd["batch_stats"][key]), atol=2e-6)
    bn_eval = fnn.BatchNorm(use_running_average=True, momentum=0.9, axis=axis)
    y_eval = np.asarray(bn_eval.apply({**v, "batch_stats": upd["batch_stats"]}, x))
    np.testing.assert_allclose(m.eval()(torch.from_numpy(x)).detach().numpy(), y_eval, atol=2e-6)


def _shopformer_pair(variant, seed, **model):
    cfg = get_default_config_jax()
    cfg["model"].update(variant=variant, hidden_channels=16, dropout=0.0, **model)
    jm = ShopformerJax.from_config(cfg)
    variables = random_flax_variables(lambda: jm.init_variables(jax.random.PRNGKey(0)), seed)
    tm = Shopformer.from_config(cfg)
    load_flax_variables(tm, variables)
    return cfg, jm, variables, tm.eval()


def test_count_parameters_matches_jax():
    _cfg, _jm, variables, tm = _shopformer_pair("v2", 5)
    assert count_parameters(tm) == count_parameters_jax(variables["params"])


@pytest.mark.parametrize("variant", ["v2", "v1"])
@pytest.mark.parametrize("stage", [1, 2])
def test_stage_loss_and_gradients_match_jax(stage, variant):
    """Both stage losses in train mode with a mask (3 of 8 windows masked
    out), dropout 0: the loss within 1e-5 relative, every gradient tensor
    within 1e-4 of its largest entry against jax.grad (float32; train-mode
    BatchNorm's E[x^2] - E[x]^2 loses digits to cancellation); stage 2's
    GCAE gets no gradient in either."""
    _cfg, jm, variables, tm = _shopformer_pair(variant, 10 + stage)
    rng = np.random.default_rng(3)
    poses = rng.normal(size=(8, 12, 18, 2)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 0, 1, 0], np.float32)
    method = "compute_gcae_loss" if stage == 1 else "compute_transformer_loss"

    def loss_fn(params):
        out = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, poses,
                       train=True, mask=mask, method=method, mutable=["batch_stats"])
        return out[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    fn = tm.compute_gcae_loss if stage == 1 else tm.compute_transformer_loss
    loss = fn(torch.from_numpy(poses), train=True, mask=torch.from_numpy(mask))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    assert not tm.training and not tm.gcae.training  # the mode is restored
    grads = grads_as_flax(tm)
    assert_grads_close(grads, host(grads_j), rtol=1e-4)
    if stage == 2:
        assert all(p.grad is None for p in tm.gcae.parameters())


# ---------------------------------------------------------------- dropout


def test_dropout_keep_rate_scale_and_eval_identity():
    """flax's Dropout: kept with probability 1 - p (binomial bound of 5
    standard deviations over 200,000 draws), kept values scaled by
    1 / (1 - p), dropped ones 0; eval mode and p = 0 are the identity; the
    explicit generator alone decides the masks."""
    x = torch.ones(200_000)
    p = 0.3
    y = dropout(x, p, True, DropoutRNG(torch.Generator().manual_seed(0)))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.7) <= 5 * np.sqrt(0.7 * 0.3 / x.numel())
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.7))
    assert dropout(x, p, False, None) is x and dropout(x, 0.0, True, None) is x
    torch.manual_seed(1)
    y2 = dropout(x, p, True, DropoutRNG(torch.Generator().manual_seed(0)))
    assert torch.equal(y, y2)
    with pytest.raises(ValueError, match="DropoutRNG"):
        dropout(x, p, True, None)


def test_dropout_rng_replays_after_rewind():
    rng = DropoutRNG(torch.Generator().manual_seed(4))
    a = dropout(torch.ones(64), 0.5, True, rng)
    b = dropout(torch.ones(32), 0.5, True, rng)
    rng.rewind()
    assert torch.equal(dropout(torch.ones(64), 0.5, True, rng), a)
    assert torch.equal(dropout(torch.ones(32), 0.5, True, rng), b)


def test_attention_dropout_mask_shared_across_batch_and_heads():
    """flax's broadcast_dropout=True: ONE (1, 1, q, k) mask for every batch
    element and head. With identical inputs across the batch and value
    weights that copy one head into the output, every batch element gives
    the same output in train mode; eval mode equals the no-dropout forward."""
    torch.manual_seed(0)
    attn = MultiHeadDotProductAttention(8, 2, dropout=0.5)
    x = torch.randn(1, 6, 8).expand(5, 6, 8).contiguous()
    rng = DropoutRNG(torch.Generator().manual_seed(1))
    y = attn.train()(x, x, rng)
    assert all(torch.equal(y[0], y[b]) for b in range(1, 5))
    assert rng._masks[0].shape == (1, 1, 6, 6)
    ref = MultiHeadDotProductAttention(8, 2, dropout=0.0)
    ref.load_state_dict(attn.state_dict())
    assert torch.equal(attn.eval()(x, x), ref.eval()(x, x))


def test_transformer_eval_mode_unchanged_by_dropout():
    """The Shopformer's scores in eval mode are bit-equal with dropout 0.1
    and 0 (the same weights)."""
    cfg = get_default_config_jax()
    cfg["model"]["hidden_channels"] = 16
    a = Shopformer.from_config(cfg)
    cfg["model"]["dropout"] = 0.0
    b = Shopformer.from_config(cfg)
    b.load_state_dict(a.state_dict())
    poses = torch.from_numpy(np.random.default_rng(5).normal(size=(4, 12, 18, 2)).astype(np.float32))
    assert torch.equal(a.eval().compute_anomaly_score(poses), b.eval().compute_anomaly_score(poses))


# ---------------------------------------------------------------- the optimizer


SCHEDULES = [
    ("constant", {}),
    ("cosine_warmup", {"warmup_epochs": 2}),
    ("step", {"step_size": 2, "gamma": 0.5}),
    ("exponential", {"gamma": 0.9}),
    ("cosine_warm_restarts", {"T_0": 2, "T_mult": 2, "eta_min": 1e-5}),
    ("cosine_restarts", {"T_0": 2, "T_mult": 1}),
    ("reduce_on_plateau", {}),
]


@pytest.mark.parametrize("name,params", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_optax(name, params):
    """Every count 0..250 of a 7-steps-an-epoch, 30-epoch schedule within
    rtol 1e-5 (optax evaluates in float32, the port in float64) with an
    absolute floor of 2^-21 of the base rate."""
    base = 1e-3
    ref = optim_jax.build_schedule(name, base, 7, 30, params)
    got = optim.build_schedule(name, base, 7, 30, params)
    assert callable(got) == callable(ref)
    counts = np.arange(251)
    # optax schedules are elementwise: one call on every count at once
    r = (np.asarray(ref(jnp.asarray(counts, jnp.int32)), np.float64) if callable(ref)
         else np.full(counts.shape, ref))
    g = np.array([got(int(c)) if callable(got) else got for c in counts])
    assert np.all(np.abs(g - r) <= np.maximum(1e-5 * np.abs(r), base * 2.0 ** -21)), \
        np.abs(g - r).max()


def _params_pair(seed):
    rng = np.random.default_rng(seed)
    tree = {"gcae": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
            "transformer": {"w": rng.normal(size=(5,)).astype(np.float32),
                            "b": rng.normal(size=(2, 2)).astype(np.float32)}}
    params = [torch.nn.Parameter(torch.from_numpy(tree["gcae"]["w"].copy())),
              torch.nn.Parameter(torch.from_numpy(tree["transformer"]["w"].copy())),
              torch.nn.Parameter(torch.from_numpy(tree["transformer"]["b"].copy()))]
    return tree, params


def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    return {"gcae": {"w": (rng.normal(size=(3, 4)) * scale).astype(np.float32)},
            "transformer": {"w": (rng.normal(size=(5,)) * scale).astype(np.float32),
                            "b": (rng.normal(size=(2, 2)) * scale).astype(np.float32)}}


def _set_grads(params, g):
    for p, a in zip(params, (g["gcae"]["w"], g["transformer"]["w"], g["transformer"]["b"])):
        p.grad = torch.from_numpy(a.copy())


def _as_tree(params):
    return {"gcae": {"w": params[0].detach().numpy()},
            "transformer": {"w": params[1].detach().numpy(), "b": params[2].detach().numpy()}}


def _config(**training):
    cfg = get_default_config_jax()
    cfg["training"].update(training)
    return cfg


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below_max_norm", "above_max_norm"])
def test_clip_matches_optax(scale):
    """optax.clip_by_global_norm(1.0) over every gradient, a frozen part's
    included, then SGD-free: one Adam step at lr 1 from zero moments is
    sign-like, so the clip is read on the accumulated gradient the optimizer
    hands to Adam; within 1e-6 of the largest entry."""
    tree, params = _params_pair(1)
    g = _grads(2, scale)
    clip = optax.clip_by_global_norm(1.0)
    ref, _ = clip.update(g, clip.init(tree))
    opt = optim.StageOptimizer(params[1:], params, "adam", 1.0, max_norm=1.0)
    captured = {}
    opt.inner.step = lambda: captured.update(g=[p.grad.clone() for p in opt.trained])
    _set_grads(params, g)
    opt.step()
    for got, r in zip(captured["g"], (ref["transformer"]["w"], ref["transformer"]["b"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=1e-6 * np.abs(r).max(), rtol=0)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_adam_step_with_frozen_subtree_matches_optax(name):
    """Three steps of the chain clip -> adam/adamw -> (no accumulation) with
    the GCAE frozen (stage 2): the trained leaves within 1e-6 absolute of
    optax (1e-4 of a step at lr 1e-2: the two order Adam's float32
    arithmetic differently), the frozen one untouched (no update, no weight
    decay)."""
    cfg = _config(optimizer=name, lr=1e-2, weight_decay=0.1, grad_clip=1.0, scheduler="constant")
    tree, params = _params_pair(3)
    labels = optim_jax.stage_param_labels(tree, 2)
    tx = optim_jax.build_optimizer(cfg, 10, 5, param_labels=labels)
    state = tx.init(tree)
    opt = optim.build_optimizer(cfg, 10, 5, params[1:], params)
    p_j = jax.tree_util.tree_map(jnp.asarray, tree)
    for step in range(3):
        g = _grads(10 + step, 0.5)
        upd, state = tx.update(g, state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        _set_grads(params, g)
        opt.step()
    got = _as_tree(params)
    np.testing.assert_array_equal(got["gcae"]["w"], tree["gcae"]["w"])
    for k in ("w", "b"):
        np.testing.assert_allclose(got["transformer"][k], np.asarray(p_j["transformer"][k]),
                                   rtol=0, atol=1e-6)


def test_multisteps_across_epoch_boundary_matches_optax():
    """grad_accum_steps 3 over 7 micro-steps (an 'epoch' of 4 then the next
    epoch's 3): updates at micro-steps 3 and 6 only, the mean of each 3, the
    count carried over the boundary, an exponential schedule counted in
    updates; params within 1e-6 absolute (1e-4 of a step) of
    optax.MultiSteps at every micro-step, and current_learning_rate equal to optax's injected rate."""
    cfg = _config(optimizer="adam", lr=1e-2, grad_clip=1.0, grad_accum_steps=3,
                  scheduler="exponential", scheduler_params={"gamma": 0.5})
    tree, params = _params_pair(4)
    tx = optim_jax.build_optimizer(cfg, 2, 5, param_labels=optim_jax.stage_param_labels(tree, 1))
    state = tx.init(tree)
    opt = optim.build_optimizer(cfg, 2, 5, params[:1], params)
    p_j = jax.tree_util.tree_map(jnp.asarray, tree)
    assert opt.lr == optim_jax.current_learning_rate(state)
    applied = []
    for micro in range(7):
        g = _grads(20 + micro, 2.0)
        upd, state = tx.update(g, state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        _set_grads(params, g)
        applied.append(opt.step())
        np.testing.assert_allclose(_as_tree(params)["gcae"]["w"], np.asarray(p_j["gcae"]["w"]),
                                   rtol=0, atol=1e-6)
        assert optim.current_learning_rate(opt) == optim_jax.current_learning_rate(state)
    assert applied == [False, False, True, False, False, True, False]
    assert opt.count == 2 and opt.mini_step == 1


def test_set_learning_rate_only_sticks_for_a_constant():
    """As inject_hyperparams: a constant rate set by hand is used by the next
    update and stays; a schedule's next update overwrites it."""
    tree, params = _params_pair(5)
    const = optim.build_optimizer(_config(lr=1e-3), 4, 2, params)
    optim.set_learning_rate(const, 5e-4)
    _set_grads(params, _grads(6, 1.0))
    const.step()
    assert const.lr == float(np.float32(5e-4))
    assert const.inner.param_groups[0]["lr"] == const.lr
    sched = optim.build_optimizer(_config(lr=1e-3, scheduler="exponential"), 4, 2, params)
    optim.set_learning_rate(sched, 5e-4)
    _set_grads(params, _grads(7, 1.0))
    sched.step()
    assert sched.lr == float(np.float32(1e-3))  # the schedule at count 0


def test_plateau_and_early_stopping_sequences_match_jax():
    metrics = [0.5, 0.6, 0.55, 0.55, 0.7, 0.7, 0.69, 0.2, 0.71, 0.71, 0.71, 0.71]
    for mode in ("min", "max"):
        pj, pp = optim_jax.PlateauController(0.5, 1, mode), optim.PlateauController(0.5, 1, mode)
        ej, ep = (optim_jax.EarlyStopping(2, 0.01, mode), optim.EarlyStopping(2, 0.01, mode))
        lr_j = lr_p = 1e-3
        for m in metrics:
            lr_j, lr_p = pj.update(m, lr_j), pp.update(m, lr_p)
            assert lr_j == lr_p
            assert ej(m) == ep(m)
        assert (ej.best, ej.counter) == (ep.best, ep.counter)


def test_stage_param_labels_match_jax():
    params = {"gcae": {"w": 1}, "transformer": {"w": 2}}
    for stage in (1, 2):
        assert optim.stage_param_labels(params.keys(), stage) == \
            optim_jax.stage_param_labels(params, stage)


# ---------------------------------------------------------------- the trainer


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX trainer of the tiny configuration: its initial variables (as
    a checkpoint), one jitted stage-1 and one stage-2 step on the first
    batch, and a 2 + 2-epoch fit from those initial variables."""
    d = tmp_path_factory.mktemp("jax_run")
    cfg = tiny_config(d / "jax", **{"training.grad_accum_steps": 2})
    tj = TrainerJax(cfg, verbose=False).setup()
    v0 = host({"params": tj._params, "batch_stats": tj._batch_stats})
    init = str(d / "init.msgpack")
    save_checkpoint_jax(init, v0, config=cfg)
    batch = next(tj.datamodule.train_batches(epoch=1))
    steps = {}
    for stage in (1, 2):
        tj._params, tj._batch_stats = (jax.tree_util.tree_map(jnp.asarray, v0["params"]),
                                       jax.tree_util.tree_map(jnp.asarray, v0["batch_stats"]))
        tj.config["training"]["grad_accum_steps"] = 1
        st = tj._make_state(stage)
        tj.config["training"]["grad_accum_steps"] = 2
        new, loss = tj._stage_steps[stage](st, jnp.asarray(batch["poses"]), jnp.asarray(batch["mask"]),
                                           jax.random.fold_in(tj.rng, 100003))
        steps[stage] = (float(loss), host({"params": new.params, "batch_stats": new.batch_stats}))
    tj._params, tj._batch_stats = (jax.tree_util.tree_map(jnp.asarray, v0["params"]),
                                   jax.tree_util.tree_map(jnp.asarray, v0["batch_stats"]))
    tj._build_steps()  # the fit traces its steps anew, with grad_accum_steps 2
    artifact = tj.fit(resume_checkpoint=init)
    return {"cfg": cfg, "v0": v0, "init": init, "batch": batch, "steps": steps,
            "artifact": artifact, "dir": cfg["experiment"]["checkpoint_dir"], "root": d}


def _port_trainer(cfg, directory, **training):
    cfg = copy.deepcopy(cfg)
    cfg["experiment"]["checkpoint_dir"] = str(directory)
    cfg["training"].update(training)
    return Trainer(cfg, verbose=False, device="cpu").setup()


@pytest.mark.parametrize("stage", [1, 2])
def test_trainer_step_matches_jax(jax_run, tmp_path, stage):
    """One trainer step (augmentation off, dropout 0, Adam at lr 1e-3 with
    the clip, no accumulation) from the same initial variables on the same
    batch: the loss within 2e-5 relative; every BatchNorm statistic within
    5e-5 (read: 8.2e-6); every parameter within 1e-6 (1e-3 of a step; read:
    1.2e-7) of JAX's where its gradient is at least 1e-3 of the largest.
    Adam's first step is lr * g / (|g| + 1e-8), a sign: below that, elements
    whose gradient is rounding noise (the biases in front of a train-mode
    BatchNorm, attention's key biases) take a sign from rounding in both
    packages, so they are held to a step of at most lr."""
    loss_j, new_j = jax_run["steps"][stage]
    tp = _port_trainer(jax_run["cfg"], tmp_path / "p", grad_accum_steps=1)
    load_flax_variables(tp.model, jax_run["v0"])
    probe = copy.deepcopy(tp.model)
    poses = torch.from_numpy(jax_run["batch"]["poses"])
    mask = torch.from_numpy(jax_run["batch"]["mask"])
    fn = probe.compute_gcae_loss if stage == 1 else probe.compute_transformer_loss
    fn(poses, train=True, mask=mask).backward()
    grads = leaves(grads_as_flax(probe))
    gmax = max(float(np.abs(g).max()) for g in grads.values())
    opt = tp.make_optimizer(stage)
    loss = float(tp.train_step(stage, opt, poses, mask, 100003))
    assert abs(loss - loss_j) <= 2e-5 * abs(loss_j)
    got = leaves(state_dict_to_flax(tp.model))
    ref, init = leaves(new_j), leaves(jax_run["v0"])
    lr = tp.config["training"]["lr"]
    for k, r in ref.items():
        if "batch_stats" in k:
            np.testing.assert_allclose(got[k], r, atol=5e-5, rtol=0, err_msg=k)
            continue
        g = grads[k.replace("['params']", "", 1)]
        sure = np.abs(g) >= 1e-3 * gmax
        diff = np.abs(got[k] - r)
        assert diff[sure].max(initial=0.0) <= 1e-6, k
        assert diff.max() <= 2 * lr * 1.0001, k
        if stage == 2 and "gcae" in k:
            np.testing.assert_array_equal(got[k], init[k])


def test_fit_matches_jax(jax_run, tmp_path):
    """A 2 + 2-epoch fit (grad_accum_steps 2, the count carried over
    epochs) from JAX's initial variables with augmentation and dropout off.
    The runs drift apart by design: each Adam step moves the
    rounding-noise elements (see test_trainer_step_matches_jax) by a sign
    of their own, and the biases among them shift the BatchNorm running
    means that stage 2's eval-mode tokens read. Limits at 5-10x the
    readings (7e-5, 1.4e-4 for stage 1; 1.7e-4, 1.0e-3 for stage 2; AUC
    1.1e-3): stage-1 losses within 1e-3 relative, stage-2 losses within
    5e-3, the learning rates equal, the best epoch equal, the best and final
    AUC within 0.01; the artifacts have JAX's keys."""
    art_j = jax_run["artifact"]
    tp = _port_trainer(jax_run["cfg"], tmp_path / "p")
    art = tp.fit(resume_checkpoint=jax_run["init"])
    for stage in ("stage1", "stage2"):
        hj, hp = art_j["history"][stage], art["history"][stage]
        assert [r["epoch"] for r in hp] == [r["epoch"] for r in hj]
        for a, b in zip(hp, hj):
            assert set(a) == set(b)
            limit = 1e-3 if stage == "stage1" else 5e-3
            assert abs(a["loss"] - b["loss"]) <= limit * abs(b["loss"]), (stage, a, b)
            assert a["lr"] == b["lr"]
    assert art["best_epoch"] == art_j["best_epoch"]
    assert abs(art["best_auc"] - art_j["best_auc"]) <= 0.01
    assert abs(art["test_metrics"]["auc_roc"] - art_j["test_metrics"]["auc_roc"]) <= 0.01
    assert set(art) == set(art_j)
    for name in ("config.json", "training_history.json", "training_results.json"):
        with open(os.path.join(jax_run["dir"], name)) as f, open(tmp_path / "p" / name) as g:
            a, b = json.load(f), json.load(g)
            assert set(a) == set(b), name
    for name in ("stage1_best", "stage1_final", "stage2_best", "stage2_final"):
        assert (tmp_path / "p" / f"{name}.msgpack").exists()


def test_port_checkpoint_scores_in_jax(jax_run, tmp_path):
    """The port's stage2_best (from a 1 + 1-epoch fit) through the JAX
    package's load_model scores the test set within 1e-5 of the port's own
    load_model (relative to the largest score)."""
    tp = _port_trainer(jax_run["cfg"], tmp_path / "p", stage1_epochs=1, stage2_epochs=1)
    tp.fit(resume_checkpoint=jax_run["init"])
    path = str(tmp_path / "p" / "stage2_best.msgpack")
    poses = tp.datamodule.test_dataset.poses
    ref = load_model_jax(path).score(poses)
    got = load_model(path, device="cpu").score(poses)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_jax_checkpoint_loads_in_port_trainer(jax_run, tmp_path):
    """JAX's stage1_best through the port trainer's load_model_state, every
    leaf used: the port's variables are then the checkpoint's, bit for bit."""
    from cvsd_tpu_torch.utils.checkpoint import load_checkpoint

    tp = _port_trainer(jax_run["cfg"], tmp_path / "p")
    path = os.path.join(jax_run["dir"], "stage1_best.msgpack")
    tp.load_model_state(path)
    state, _ = load_checkpoint(path)
    got, ref = leaves(state_dict_to_flax(tp.model)), leaves(state)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_remat_matches_plain(jax_run, tmp_path):
    """training.remat (torch.utils.checkpoint) with dropout 0.1 and
    augmentation on: the same losses, weights and BatchNorm statistics as
    without it, bit for bit (the recomputed forward replays the masks and
    moves no statistics), over 2 stage-1 and 1 stage-2 epochs."""
    out = []
    for remat in (False, True):
        cfg = copy.deepcopy(jax_run["cfg"])
        cfg["model"]["dropout"] = 0.1
        cfg["model"]["variant"] = "v1"  # the GCAE's dropout too
        cfg["data"]["augment"]["enabled"] = True
        tp = _port_trainer(cfg, tmp_path / str(remat), remat=remat, stage2_epochs=1)
        tp.train_stage(1)
        tp.train_stage(2)
        out.append((tp.history, {k: v.clone() for k, v in tp.model.state_dict().items()}))
    (h0, s0), (h1, s1) = out
    assert [r["loss"] for r in h0["stage1"] + h0["stage2"]] == \
        [r["loss"] for r in h1["stage1"] + h1["stage2"]]
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_same_seed_twice_gives_identical_weights(jax_run, tmp_path):
    """Augmentation and dropout on: two runs of one seed end with the same
    weights bit for bit (per-step generators from host counters only); a
    third with another seed does not."""
    states = []
    for i, seed in enumerate((7, 7, 8)):
        cfg = copy.deepcopy(jax_run["cfg"])
        cfg["model"]["dropout"] = 0.1
        cfg["data"]["augment"]["enabled"] = True
        cfg["experiment"]["seed"] = seed
        tp = _port_trainer(cfg, tmp_path / str(i), stage1_epochs=1, stage2_epochs=1)
        load_flax_variables(tp.model, jax_run["v0"])
        tp.train_stage(1)
        tp.train_stage(2)
        states.append(tp.model.state_dict())
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])
    assert not all(torch.equal(states[0][k], states[2][k]) for k in states[0])


def test_max_seconds_abort_on_nan_and_zero_epoch_stage(jax_run, tmp_path):
    """training.max_seconds stops the fit after the epoch that passes it
    (one budget for both stages); a NaN loss aborts the stage with a record;
    a stage of 0 epochs saves its final checkpoint and records nothing."""
    tp = _port_trainer(jax_run["cfg"], tmp_path / "a", max_seconds=1e-9, stage1_epochs=3,
                       stage2_epochs=3)
    art = tp.fit()
    assert art["timed_out"]
    assert len(art["history"]["stage1"]) == 1
    assert art["history"]["stage1"][0]["aborted"] == "max_seconds exceeded"
    assert len(art["history"]["stage2"]) == 1

    tp = _port_trainer(jax_run["cfg"], tmp_path / "b", stage1_epochs=3, stage2_epochs=0)
    with torch.no_grad():
        tp.model.gcae.decoder.Conv_0.bias.fill_(float("nan"))
    art = tp.fit()
    (record,) = art["history"]["stage1"]
    assert record["epoch"] == 1 and record["aborted"] == "non-finite loss"
    assert np.isnan(record["loss"])
    assert art["history"]["stage2"] == []
    assert (tmp_path / "b" / "stage2_final.msgpack").exists()


def test_train_from_config_and_mesh_config(jax_run, tmp_path):
    """train_from_config runs a whole fit on the given device; a card's
    mesh raises on a host without a card (the meshed trainer itself:
    tests/test_torch_parallel_shopformer.py)."""
    cfg = copy.deepcopy(jax_run["cfg"])
    cfg["experiment"]["checkpoint_dir"] = str(tmp_path / "t")
    cfg["training"].update(stage1_epochs=1, stage2_epochs=1)
    art = train_from_config(cfg, verbose=False, device="cpu")
    assert len(art["history"]["stage2"]) == 1 and 0.0 <= art["best_auc"] <= 1.0
    with cuda_mesh_config(tmp_path) as mc, pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, mesh_config=mc)
