"""The port's reference-Shopformer importer (``cvsd_tpu_torch/utils/
shopformer_import.py``, ``cli/import_shopformer.py``) and the GCAE's
reference-mirror options against the JAX package's on the CPU, for both
reference generations (v1: 17 keypoints, v2: 18), and against the
independent torch mirrors of ``tests/test_shopformer_import.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.cli import import_shopformer as import_shopformer_jax
from cvsd_tpu.models.gcae import GCAE as GCAEJax
from cvsd_tpu.models.shopformer import Shopformer as ShopformerJax
from cvsd_tpu.utils import shopformer_import as sfi_jax
from cvsd_tpu_torch.cli import import_shopformer
from cvsd_tpu_torch.eval.evaluate import load_model
from cvsd_tpu_torch.models.gcae import GCAE
from cvsd_tpu_torch.models.shopformer import Shopformer
from cvsd_tpu_torch.utils import shopformer_import as sfi
from cvsd_tpu_torch.utils.weights import load_flax_variables
from test_shopformer_import import TShopformer, _randomize_bn_stats
from torch_testutil import random_flax_variables

GENERATIONS = [("v1", 17), ("v2", 18)]
# float32 on the CPU with the same weights: the packages and the mirrors
# differ only in summation order (readings 1e-7 to 1e-6); the JAX package's
# mirror test allows rtol 1e-4
TOL_TOKENS = 2e-6  # max |a - b| / max |b|
TOL_RECON = 5e-6
TOL_SCORE = 2e-6  # relative, per window


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _mirror(variant, V, seed=0):
    torch.manual_seed(seed)
    tm = TShopformer(variant, V)
    with torch.no_grad():
        _randomize_bn_stats(tm, np.random.default_rng(seed + 1))
    return tm.eval()


def _v2_embedded_config(V=18):
    """The reference v2's nested yaml schema, as its stage checkpoints embed it."""
    return {"model": {"num_keypoints": V, "seq_len": 12, "num_tokens": 2,
                      "gcae": {"hidden_channels": 64, "latent_channels": 8, "num_layers": 4},
                      "transformer": {"num_heads": 2, "num_layers": 2, "dim_feedforward": 64}}}


@pytest.mark.parametrize("variant,V", GENERATIONS)
def test_config_and_conversion_match_jax(variant, V):
    cfg = sfi.reference_model_config(variant, num_keypoints=V)
    assert cfg == sfi_jax.reference_model_config(variant, num_keypoints=V)
    assert (cfg["pool_to_tokens"], cfg["transformer_final_norm"]) == (variant == "v2",) * 2
    sd = _mirror(variant, V).state_dict()
    got, ref = _flat(sfi.convert_state_dict(sd, cfg)), _flat(sfi_jax.convert_state_dict(sd, cfg))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k], err_msg="/".join(k))


@pytest.mark.parametrize("variant,V", GENERATIONS)
def test_mirror_mode_matches_jax_and_torch_mirror(variant, V):
    """Tokens, the GCAE's reconstruction, the transformer's reconstruction and
    the scores of the port in mirror mode against JAX's mirror mode and the
    torch mirror, in eval mode."""
    tm = _mirror(variant, V)
    cfg = sfi.reference_model_config(variant, num_keypoints=V)
    variables = sfi.convert_state_dict(tm.state_dict(), cfg)
    model = load_flax_variables(Shopformer.from_config({"model": cfg}), variables).eval()
    jm = ShopformerJax.from_config({"model": cfg})

    poses = np.random.default_rng(2).normal(size=(3, 12, V, 2)).astype(np.float32)
    x = torch.from_numpy(poses)
    with torch.no_grad():
        t_tokens, t_recon, t_gcae, t_score = tm(x.permute(0, 3, 1, 2))
        tokens = model.tokenize(x)
        recon = model.reconstruct_tokens(tokens)
        gcae = model.decode_tokens(tokens)
        score = model.compute_anomaly_score(x)
    j_tokens = jm.apply(variables, poses, method="tokenize")
    j_recon = jm.apply(variables, j_tokens, method="reconstruct_tokens")
    j_gcae = jm.apply(variables, j_tokens, method="decode_tokens")
    j_score = jm.apply(variables, poses, method="compute_anomaly_score")
    # v1 keeps the 3 tokens its halving strides leave (12 -> 6 -> 3)
    assert tokens.shape == (3, 3 if variant == "v1" else 2, 8 * V)
    for ref in (j_tokens, t_tokens.numpy()):
        assert _rel(tokens.numpy(), ref) < TOL_TOKENS
    for ref in (j_recon, t_recon.numpy()):
        assert _rel(recon.numpy(), ref) < TOL_RECON
    for ref in (np.asarray(j_gcae), t_gcae.permute(0, 2, 3, 1).numpy()):
        assert _rel(gcae.numpy(), ref) < TOL_RECON
    for ref in (np.asarray(j_score), t_score.numpy()):
        np.testing.assert_allclose(score.numpy(), ref, rtol=TOL_SCORE, atol=0)


@pytest.mark.parametrize("token_order", ["vc", "cv"])
@pytest.mark.parametrize("pool_to_tokens", [True, False])
def test_gcae_mirror_options_match_jax(token_order, pool_to_tokens):
    """The reference decoder and the encoder options in every combination,
    against flax's modules on the same random variables (hidden 8, v1's
    strides, so the pool has work where it is on)."""
    kw = dict(in_channels=2, hidden_channels=8, latent_channels=4, num_keypoints=17,
              seq_len=12, num_tokens=2, num_layers=4, layout="coco")
    strides = (2, 2, 1, 1)
    jm = GCAEJax(**kw, strides_override=strides, token_order=token_order,
                 pool_to_tokens=pool_to_tokens, decoder_variant="ref")
    poses = np.random.default_rng(4).normal(size=(2, 12, 17, 2)).astype(np.float32)
    variables = jax.device_get(random_flax_variables(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(poses)), 5))
    model = load_flax_variables(
        GCAE(**kw, strides_override=strides, token_order=token_order,
             pool_to_tokens=pool_to_tokens, decoder_variant="ref"), variables).eval()
    j_recon, j_tokens = jm.apply(variables, poses)
    with torch.no_grad():
        recon, tokens = model(torch.from_numpy(poses))
    assert tokens.shape == j_tokens.shape == (2, 2 if pool_to_tokens else 3, 68)
    assert _rel(tokens.numpy(), j_tokens) < TOL_TOKENS
    assert _rel(recon.numpy(), j_recon) < TOL_RECON


def _write_reference_checkpoint(tmp_path, variant, V, seed=0):
    tm = _mirror(variant, V, seed)
    path = str(tmp_path / f"{variant}.pt")
    if variant == "v1":  # shopformer/train.py's {'model_state_dict': ...}
        torch.save({"epoch": 3, "model_state_dict": tm.state_dict()}, path)
    else:  # shopformer_2/train.py's, with its config
        torch.save({"model_state_dict": tm.state_dict(), "config": _v2_embedded_config(V)}, path)
    return tm, path


@pytest.mark.parametrize("variant,V", GENERATIONS)
def test_cli_is_byte_identical_to_jax(tmp_path, variant, V):
    """v1 with --variant, v2 from its embedded nested config."""
    _tm, pt = _write_reference_checkpoint(tmp_path, variant, V)
    flags = ["--torch_checkpoint", pt] + (["--variant", "v1"] if variant == "v1" else [])
    jax_out, port_out = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    import_shopformer_jax.main(flags + ["--output", jax_out])
    import_shopformer.main(flags + ["--output", port_out, "--device", "cpu"])
    with open(jax_out, "rb") as a, open(port_out, "rb") as b:
        assert b.read() == a.read()


@pytest.mark.parametrize("variant,V", GENERATIONS)
def test_imported_checkpoint_scores_through_load_model(tmp_path, variant, V):
    """The imported file rebuilds the mirror-mode model through load_model
    (its embedded config, no flags) and ShopformerScorer scores it as the
    torch mirror does; import_shopformer_checkpoint gives the same model."""
    tm, pt = _write_reference_checkpoint(tmp_path, variant, V, seed=5)
    out = str(tmp_path / "sf.msgpack")
    import_shopformer.main(["--torch_checkpoint", pt, "--output", out, "--device", "cpu",
                            "--variant", variant])
    scorer = load_model(out, device="cpu")
    assert scorer.config["model"]["token_order"] == "cv"
    assert scorer.config["model"]["gcae_decoder_variant"] == "ref"
    poses = np.random.default_rng(6).normal(size=(37, 12, V, 2)).astype(np.float32)
    scores = scorer.score(poses, batch_size=16)
    with torch.no_grad():
        ref = tm(torch.from_numpy(poses).permute(0, 3, 1, 2))[3].numpy()
    np.testing.assert_allclose(scores, ref, rtol=TOL_SCORE, atol=0)
    model, variables, config = sfi.import_shopformer_checkpoint(pt, variant=variant, device="cpu")
    assert not model.training and config["model"]["variant"] == variant
    assert all(scorer.config["model"][k] == v for k, v in config["model"].items())
    with torch.no_grad():
        np.testing.assert_array_equal(
            model.compute_anomaly_score(torch.from_numpy(poses)).numpy(), scores)


def _deeper(sd, what):
    sd = dict(sd)
    if what == "encoder":
        sd.update({k.replace("encoder_layers.1", "encoder_layers.2"): v
                   for k, v in sd.items() if "encoder_layers.1" in k})
    elif what == "decoder":
        sd.update({k.replace("decoder_layers.1", "decoder_layers.2"): v
                   for k, v in sd.items() if "decoder_layers.1" in k})
    elif what == "gcae_block":
        sd.update({k.replace("gcae.encoder.layers.3", "gcae.encoder.layers.4"): v
                   for k, v in sd.items() if "gcae.encoder.layers.3" in k})
    else:  # one more module in the decoder's Sequential
        sd["gcae.decoder.layers.13.weight"] = sd["gcae.decoder.layers.12.weight"]
    return sd


@pytest.mark.parametrize("what,match", [
    ("encoder", "encoder layer 2"), ("decoder", "decoder layer 2"),
    ("gcae_block", "GCAE block 4"), ("decoder_seq", "decoder Sequential index 13")])
def test_depth_guards_match_jax(what, match):
    """A checkpoint deeper than the config raises, as in the JAX package."""
    sd = _deeper(_mirror("v1", 17, seed=3).state_dict(), what)
    cfg = sfi.reference_model_config("v1", num_keypoints=17)
    with pytest.raises(ValueError, match=match) as got:
        sfi.convert_state_dict(sd, cfg)
    with pytest.raises(ValueError, match=match) as ref:
        sfi_jax.convert_state_dict(sd, cfg)
    assert str(got.value) == str(ref.value)


def test_unsafe_checkpoint_requires_opt_in(tmp_path):
    p = str(tmp_path / "sketchy.pt")
    # a function reference pickles fine but is refused by weights_only=True
    torch.save({"state_dict": {}, "payload": os.getcwd}, p)
    with pytest.raises(ValueError, match="weights_only"):
        sfi.import_shopformer_checkpoint(p, device="cpu")
    with pytest.raises(ValueError, match="weights_only"):
        sfi_jax.import_shopformer_checkpoint(p)
    with pytest.raises(ValueError, match="weights_only"):
        import_shopformer.main(["--torch_checkpoint", p, "--output", str(tmp_path / "o.msgpack"),
                                "--device", "cpu"])
    assert not (tmp_path / "o.msgpack").exists()
