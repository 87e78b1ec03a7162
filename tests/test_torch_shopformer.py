"""The port's Shopformer scoring against the JAX Shopformer on the CPU, with
the JAX weights carried across by the bridge (default widths: d_model 144)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.eval.evaluate import ShopformerScorer as ShopformerScorerJax
from cvsd_tpu.models.shopformer import Shopformer as ShopformerJax
from cvsd_tpu_torch.config import get_default_config
from cvsd_tpu_torch.eval.evaluate import ShopformerScorer
from cvsd_tpu_torch.models.shopformer import Shopformer, build_shopformer
from cvsd_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables
from torch_testutil import random_flax_variables


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(variant, seed):
    cfg = get_default_config_jax()
    cfg["model"]["variant"] = variant
    jm = ShopformerJax.from_config(cfg)
    variables = random_flax_variables(lambda: jm.init_variables(jax.random.PRNGKey(0)), seed)
    tm = Shopformer.from_config(cfg)
    load_flax_variables(tm, variables)
    return cfg, jm, variables, tm.eval()


@pytest.fixture(scope="module")
def poses():
    return np.random.default_rng(7).normal(size=(9, 12, 18, 2)).astype(np.float32)


@pytest.mark.parametrize("variant", ["v2", "v1"])
def test_compute_anomaly_score_matches_jax(variant, poses):
    """float32; tolerance 1e-5 relative + 1e-6 absolute: einsum/matmul and
    LayerNorm's variance are summed in another order (flax uses E[x^2]-E[x]^2)."""
    _cfg, jm, variables, tm = _pair(variant, seed=1 if variant == "v2" else 2)
    score = jax.jit(lambda v, x: jm.apply(v, x, method="compute_anomaly_score"))
    ref = np.asarray(score(variables, jnp.asarray(poses)))
    got = tm.compute_anomaly_score(torch.from_numpy(poses)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    tokens_ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, method="tokenize"))(
        variables, jnp.asarray(poses)))
    with torch.no_grad():
        np.testing.assert_allclose(tm.tokenize(torch.from_numpy(poses)).numpy(), tokens_ref,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant", ["v2", "v1"])
def test_bf16_scorer_matches_jax_bf16(variant, capsys):
    """model.dtype bfloat16 (float32 parameters, flax's compute dtype): the
    port's ShopformerScorer against the JAX package's on 256 windows, the
    same weights. Both come out in bfloat16 and the gap is stated as the
    mean relative gap over the windows: the port's gap to JAX's bfloat16
    scores must be no larger than JAX's own bfloat16-vs-float32 gap (both
    printed, with the largest gaps beside them). The packages round at the
    same places (models/layers.py); what differs is float32 summation order
    in the convolutions, which bfloat16 rounding magnifies (seeds 5-6:
    port 0.0005-0.0020 against JAX's 0.0014-0.0024). float32 is untouched."""
    x = np.random.default_rng(11).normal(size=(256, 12, 18, 2)).astype(np.float32)
    cfg, jm, variables, tm = _pair(variant, seed=5)
    scores = {}
    for dtype in ("float32", "bfloat16"):
        cfg_d = {**cfg, "model": {**cfg["model"], "dtype": dtype}}
        scores["jax", dtype] = np.asarray(ShopformerScorerJax(
            ShopformerJax.from_config(cfg_d), variables, cfg_d).score(x, 64), np.float32)
        model = build_shopformer(cfg_d, device="cpu",
                                 state_dict=flax_to_state_dict(variables, tm))
        assert model.dtype == getattr(torch, dtype)
        scores["port", dtype] = ShopformerScorer(model, cfg_d, device="cpu").score(x, 64)
        assert scores["port", dtype].dtype == np.float32 and scores["port", dtype].shape == (256,)
    with torch.no_grad():
        assert model.compute_anomaly_score(torch.from_numpy(x[:4])).dtype == torch.bfloat16
    bf16 = scores["port", "bfloat16"]
    assert np.array_equal(torch.from_numpy(bf16).to(torch.bfloat16).float().numpy(), bf16)
    np.testing.assert_allclose(scores["port", "float32"], scores["jax", "float32"],
                               rtol=1e-5, atol=1e-6)

    def rel(a, b):
        return np.abs(a - b) / np.abs(b)

    port_gap = rel(bf16, scores["jax", "bfloat16"])
    jax_gap = rel(scores["jax", "bfloat16"], scores["jax", "float32"])
    with capsys.disabled():
        print(f"\nbf16 Shopformer {variant}: port vs JAX bf16 mean {port_gap.mean():.3e} "
              f"(max {port_gap.max():.3e}); JAX bf16 vs float32 mean {jax_gap.mean():.3e} "
              f"(max {jax_gap.max():.3e})")
    assert port_gap.mean() <= jax_gap.mean()
    assert port_gap.max() < 2e-2 and np.isfinite(bf16).all()


def test_scorer_ragged_tail_matches_jax(poses):
    """ShopformerScorer.score with 9 windows at batch 4 (2 full + a padded,
    masked tail of 1) -> 9 scores equal to JAX's within 1e-5 relative."""
    cfg, jm, variables, tm = _pair("v2", seed=3)
    ref = ShopformerScorerJax(jm, variables, cfg).score(poses, batch_size=4)
    got = ShopformerScorer(tm, get_default_config(), device="cpu").score(poses, batch_size=4)
    assert got.shape == ref.shape == (9,)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_bridge_skips_only_named_subtrees():
    """The whole flax Shopformer, GCAE decoder included, fills the port's
    module; the bridge stays strict: a skipped subtree the module holds
    leaves its tensors unfilled, and an extra leaf has no counterpart."""
    cfg, _jm, variables, tm = _pair("v2", seed=4)
    sd = flax_to_state_dict(variables, tm)
    assert set(sd) == set(tm.state_dict())
    assert any(k.startswith("gcae.decoder.ConvTranspose_") for k in sd)
    with pytest.raises(KeyError, match="not filled"):
        flax_to_state_dict(variables, tm, skip=("gcae/decoder",))
    extra = {**variables, "params": {**variables["params"], "extra": {"Dense_0": {
        "kernel": np.zeros((2, 2), np.float32)}}}}
    with pytest.raises(KeyError, match="no torch counterpart"):
        flax_to_state_dict(extra, tm)
    a = build_shopformer(cfg, device="cpu", seed=5).state_dict()
    b = build_shopformer(cfg, device="cpu", seed=5).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
