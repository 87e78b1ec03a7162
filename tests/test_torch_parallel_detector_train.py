"""Data-parallel training in the port (DetectorTrainer and its scan chunks,
QATFineTuner, the train-mode BatchNorm statistics, the masked losses, the
augmentation and dropout draws) against the JAX package's meshed trainers
and the port's own single-process steps, on the CPU.

The port's side runs once for the module in a world of 2 spawned gloo
processes; the JAX side on a 2-device mesh of the 8 virtual CPU devices
from tests/conftest.py, from the same flax variables and the same batches.
Limits are the JAX package's mesh tests' (tests/test_detection_mesh.py):
the detector's losses rtol 1e-3 and parameters atol 5e-3 after 3 steps, the
scan's losses rtol 5e-3; QAT's loss 1e-3. The module imports no JAX at top
level: the spawned processes import it."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cvsd_tpu_torch.parallel.distributed import spawn_world
from cvsd_tpu_torch.parallel.mesh import MeshConfig, build_mesh

S = 64
SMALL = dict(img_size=S, width_mult=0.25, depth_mult=0.34)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _data():
    from cvsd_tpu_torch.train.detector_train import synthetic_detection_batch

    steps = [synthetic_detection_batch(np.random.default_rng(i), 8, S, max_gt=2)
             for i in range(3)]
    scan = [synthetic_detection_batch(np.random.default_rng(10 + i), 8, S, max_gt=2)
            for i in range(4)]
    return steps, tuple(np.stack([d[k] for d in scan]) for k in range(3))


def _calib():
    return [np.random.default_rng(9).uniform(0, 1, (4, S, S, 3)).astype(np.float32)]


def _port_runs(variables, mesh_config):
    """The port's detector and QAT trainers, single or meshed: per-step
    losses, the detector's final parameters, the scan's losses."""
    from cvsd_tpu_torch.models.detector import PersonDetector
    from cvsd_tpu_torch.models.detector_int8 import prepare_qat
    from cvsd_tpu_torch.train.detector_train import DetectorTrainer
    from cvsd_tpu_torch.train.qat import QATFineTuner
    from cvsd_tpu_torch.utils.weights import load_flax_variables

    steps, scan = _data()
    out = {}
    tr = DetectorTrainer(PersonDetector(**SMALL, dtype=torch.float32), lr=1e-3,
                         variables=variables, mesh_config=mesh_config, device="cpu")
    out["det_losses"] = [tr.train_step(*b)["loss"] for b in steps]
    out["det_params"] = tr.variables["params"]
    tr = DetectorTrainer(PersonDetector(**SMALL, dtype=torch.float32), lr=1e-3,
                         variables=variables, mesh_config=mesh_config, device="cpu")
    out["scan_losses"] = tr.train_steps_scan(*scan)["losses"]
    model = load_flax_variables(PersonDetector(**SMALL, dtype=torch.float32), variables)
    q, qv = prepare_qat(model, variables, _calib())
    tuner = QATFineTuner(q, qv, lr=1e-4, mesh_config=mesh_config, device="cpu")
    out["qat_losses"] = [tuner.train_step(*b)["loss"] for b in steps[:2]]
    out["qat_scan"] = tuner.train_steps_scan(*(a[:2] for a in scan))["losses"]
    return out


def _naive_and_global_parts():
    """This rank's half of the three things a naive per-rank step gets
    wrong: BatchNorm statistics, a masked loss with unequal valid counts,
    the augmentation draw. Each is computed both ways."""
    from cvsd_tpu_torch.config import get_default_config
    from cvsd_tpu_torch.data.augment import batched_augment_from_config
    from cvsd_tpu_torch.models.layers import DropoutRNG, FlaxBatchNorm, set_data_group
    from cvsd_tpu_torch.models.shopformer import build_shopformer

    mc = MeshConfig(build_mesh((2,), ("data",)))
    dg = mc.data_group()
    rows = dg.rows(8)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 1, (8, 6, 5, 4)).astype(np.float32))
    x[4:] = x[4:] * 3 + 2  # the two halves' statistics differ
    out = {}
    for name, group in (("global", dg), ("naive", None)):
        bn = FlaxBatchNorm(6).train()
        set_data_group(bn, group)
        y = bn(x[rows])
        out[f"bn_{name}"] = (y.detach().numpy(), bn.running_mean.numpy().copy(),
                             bn.running_var.numpy().copy())
    cfg = get_default_config()
    cfg["model"]["hidden_channels"] = 8
    model = build_shopformer(cfg, device="cpu", seed=0).train()
    poses = torch.from_numpy(rng.normal(0, 1, (8, 12, 18, 2)).astype(np.float32))
    mask = torch.tensor([1, 1, 1, 1, 1, 0, 0, 0], dtype=torch.bool)  # 4 valid rows, then 1
    gen = torch.Generator()
    gen.manual_seed(3)
    aug = batched_augment_from_config(gen, poses, cfg)  # the global draw
    gen.manual_seed(3)
    aug_naive = batched_augment_from_config(gen, poses[rows], cfg)
    out["aug"] = (aug[rows].numpy(), aug_naive.numpy())
    for name, group in (("global", dg), ("naive", None)):
        set_data_group(model, group)
        gen.manual_seed(4)
        share = model.compute_gcae_loss(aug[rows], mask=mask[rows],
                                        rng=DropoutRNG(gen, (rows, 8)), data_group=group)
        out[f"loss_{name}"] = float(share.detach())
    return out


def _world(variables):
    mc = MeshConfig(build_mesh((2,), ("data",)))
    return {"runs": _port_runs(variables, mc), "parts": _naive_and_global_parts()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
    from torch_testutil import random_flax_variables

    jm = PersonDetectorJax(**SMALL, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(np.asarray, random_flax_variables(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, S, S, 3)),
                        train=False), 41))
    meshed = spawn_world(_world, 2, (variables,), store_dir=str(tmp_path_factory.mktemp("w")),
                         timeout=300, threads=2)
    return variables, meshed, _port_runs(variables, None)


@pytest.fixture(scope="module")
def jax_meshed(runs):
    import jax
    import jax.numpy as jnp

    from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
    from cvsd_tpu.models.detector_int8 import prepare_qat
    from cvsd_tpu.parallel.mesh import MeshConfig as MeshConfigJax
    from cvsd_tpu.parallel.mesh import build_mesh as build_mesh_jax
    from cvsd_tpu.train.detector_train import DetectorTrainer as DetectorTrainerJax
    from cvsd_tpu.train.qat import QATFineTuner as QATFineTunerJax

    variables = runs[0]
    mc = MeshConfigJax(mesh=build_mesh_jax((2,), ("data",), jax.devices()[:2]))
    jm = PersonDetectorJax(**SMALL, dtype=jnp.float32)
    steps, scan = _data()
    out = {}
    with pytest.MonkeyPatch.context() as mp:  # the trainer's own init is replaced at once
        mp.setattr(PersonDetectorJax, "init_variables",
                   lambda self, rng, batch_size=1: jax.tree_util.tree_map(jnp.asarray, variables))
        tr = DetectorTrainerJax(jm, lr=1e-3, mesh_config=mc)
        out["det_losses"] = [tr.train_step(*b)["loss"] for b in steps]
        out["det_params"] = jax.device_get(tr.variables["params"])
        tr = DetectorTrainerJax(jm, lr=1e-3, mesh_config=mc)
        out["scan_losses"] = np.asarray(tr.train_steps_scan(*scan)["losses"])
    q, qv = prepare_qat(jm, variables, _calib())
    tuner = QATFineTunerJax(q, qv, lr=1e-4, mesh_config=mc)
    out["qat_losses"] = [tuner.train_step(*b)["loss"] for b in steps[:2]]
    out["qat_scan"] = np.asarray(tuner.train_steps_scan(*(a[:2] for a in scan))["losses"])
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _leaves(v, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree)}


def test_meshed_detector_steps_match_jax_meshed(runs, jax_meshed):
    """Three DetectorTrainer.train_step calls over the mesh: every rank's
    loss within rtol 1e-3 of the JAX package's meshed trainer's and every
    parameter within 5e-3, as tests/test_detection_mesh.py holds JAX's own
    mesh against its single device."""
    _v, meshed, _single = runs
    for w in meshed:
        np.testing.assert_allclose(w["runs"]["det_losses"], jax_meshed["det_losses"], rtol=1e-3)
        got, ref = _leaves(w["runs"]["det_params"]), _leaves(jax_meshed["det_params"])
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], atol=5e-3, err_msg=k)


def test_meshed_detector_scan_matches_jax_meshed(runs, jax_meshed):
    """train_steps_scan's chunks shard their per-batch dim (dim 1): the
    losses within rtol 5e-3 of JAX's meshed scan."""
    _v, meshed, _single = runs
    for w in meshed:
        np.testing.assert_allclose(w["runs"]["scan_losses"], jax_meshed["scan_losses"],
                                   rtol=5e-3)


def test_meshed_qat_matches_jax_meshed(runs, jax_meshed):
    _v, meshed, _single = runs
    for w in meshed:
        np.testing.assert_allclose(w["runs"]["qat_losses"], jax_meshed["qat_losses"], rtol=1e-3)
        np.testing.assert_allclose(w["runs"]["qat_scan"], jax_meshed["qat_scan"], rtol=1e-3)


def test_meshed_trainers_match_the_single_process(runs):
    """Over the mesh, each update is the single-device update on the global
    batch: the ranks agree bit for bit with each other; the first losses
    (one forward of the same weights over the global batch) equal the single
    process's within 1e-6, the later ones and the parameters within the JAX
    package's mesh-vs-single limits (rtol 1e-3, atol 5e-3): the BatchNorm
    statistics and the gradients are summed over two halves in float32, and
    Adam's first steps take the sign of gradients that are rounding noise
    (read: 2.2e-4 on the detector's third loss)."""
    _v, (r0, r1), single = runs
    for key in ("det_losses", "scan_losses", "qat_losses", "qat_scan"):
        np.testing.assert_array_equal(r0["runs"][key], r1["runs"][key])
        np.testing.assert_allclose(r0["runs"][key][0], single[key][0], rtol=1e-6, err_msg=key)
        np.testing.assert_allclose(r0["runs"][key], single[key], rtol=1e-3, err_msg=key)
    got, ref = _leaves(r0["runs"]["det_params"]), _leaves(single["det_params"])
    for k in ref:
        np.testing.assert_array_equal(got[k], _leaves(r1["runs"]["det_params"])[k])
        np.testing.assert_allclose(got[k], ref[k], atol=5e-3, err_msg=k)


def test_batchnorm_statistics_are_the_global_batch(runs):
    """Train-mode FlaxBatchNorm over the data group: each rank's normalized
    rows and the running statistics within 1e-6 of one BatchNorm over the
    whole batch; the per-rank statistics (the naive version) are far off."""
    from cvsd_tpu_torch.models.layers import FlaxBatchNorm

    _v, meshed, _single = runs
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (8, 6, 5, 4)).astype(np.float32))
    x[4:] = x[4:] * 3 + 2
    bn = FlaxBatchNorm(6).train()
    y = bn(x).detach().numpy()
    for rank, w in enumerate(meshed):
        got_y, got_mean, got_var = w["parts"]["bn_global"]
        np.testing.assert_allclose(got_y, y[4 * rank: 4 * rank + 4], atol=1e-6)
        np.testing.assert_allclose(got_mean, bn.running_mean.numpy(), atol=1e-6)
        np.testing.assert_allclose(got_var, bn.running_var.numpy(), atol=1e-6)
        naive_y, naive_mean, _ = w["parts"]["bn_naive"]
        assert np.abs(naive_mean - bn.running_mean.numpy()).max() > 1e-2
        assert np.abs(naive_y - y[4 * rank: 4 * rank + 4]).max() > 1e-2


def test_masked_loss_with_unequal_valid_counts_is_the_global_mean(runs):
    """Rank 0 holds 4 valid rows, rank 1 one: the shares sum to the single
    device's masked mean over the 5 (1e-6); the mean of per-rank means (the
    naive version) does not."""
    from cvsd_tpu_torch.config import get_default_config
    from cvsd_tpu_torch.models.layers import DropoutRNG
    from cvsd_tpu_torch.models.shopformer import build_shopformer

    _v, (r0, r1), _single = runs
    cfg = get_default_config()
    cfg["model"]["hidden_channels"] = 8
    model = build_shopformer(cfg, device="cpu", seed=0).train()
    aug = torch.from_numpy(np.concatenate([r0["parts"]["aug"][0], r1["parts"]["aug"][0]]))
    gen = torch.Generator()
    gen.manual_seed(4)
    mask = torch.tensor([1, 1, 1, 1, 1, 0, 0, 0], dtype=torch.bool)
    ref = float(model.compute_gcae_loss(aug, mask=mask, rng=DropoutRNG(gen)).detach())
    got = r0["parts"]["loss_global"] + r1["parts"]["loss_global"]
    assert abs(got - ref) <= 1e-6 * abs(ref)
    naive = (r0["parts"]["loss_naive"] + r1["parts"]["loss_naive"]) / 2
    assert abs(naive - ref) > 1e-3 * abs(ref)


def test_augmentation_draws_the_global_batch(runs):
    """Each rank augments the global batch from the shared generator and
    keeps its rows (mixup pairs rows across ranks): the rows equal one
    draw over the whole batch; augmenting only its own rows from the same
    seed (the naive version) gives other poses."""
    from cvsd_tpu_torch.config import get_default_config
    from cvsd_tpu_torch.data.augment import batched_augment_from_config

    _v, meshed, _single = runs
    rng = np.random.default_rng(5)
    rng.normal(0, 1, (8, 6, 5, 4))
    poses = torch.from_numpy(rng.normal(0, 1, (8, 12, 18, 2)).astype(np.float32))
    cfg = get_default_config()
    gen = torch.Generator()
    gen.manual_seed(3)
    ref = batched_augment_from_config(gen, poses, cfg).numpy()
    for rank, w in enumerate(meshed):
        got, naive = w["parts"]["aug"]
        np.testing.assert_array_equal(got, ref[4 * rank: 4 * rank + 4])
        assert np.abs(naive - ref[4 * rank: 4 * rank + 4]).max() > 1e-2
