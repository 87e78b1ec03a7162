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
